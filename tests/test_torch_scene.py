"""The port's scene compiler and megakernel tables against the JAX package.

`mcpt_tpu_torch.scene.Scene.compile()` + `kernels.tables.mega_tables` must
give tables BITWISE equal to `mcpt_tpu.kernels.megakernel.mega_tables` (the
eight the brute-force regen kernel reads) and equal static ints, for the
DEMO scene and for the textured chessboard-floor scene of
tests/test_megakernel.py:150-176; `convert.tables_from_pack` must carry a JAX
`ScenePack` across to the same `SceneTables`, env map and BVH included.
"""

import numpy as np
import pytest
import torch

import mcpt_tpu.builtin_scenes as JB
import mcpt_tpu.materials as JM
import mcpt_tpu.scene as JS
from mcpt_tpu.kernels.megakernel import mega_tables as jax_mega_tables

import mcpt_tpu_torch.builtin_scenes as TB
import mcpt_tpu_torch.materials as TM
import mcpt_tpu_torch.scene as TS
from mcpt_tpu_torch.convert import PACK_FIELDS, PACK_STATIC, tables_from_pack
from mcpt_tpu_torch.kernels.tables import EXTRA, TABLE_COLS, SceneTables, mega_tables

STATIC = ("n_emitters", "n_sph_emitters", "n_dir_sample", "enable_shadow", "use_env")


def _chess_floor_scene(B, M, S):
    """tests/test_megakernel.py:150-176, built from either package."""
    base = B.demo_scene()
    floor_mat = M.Material(
        mtype=M.MaterialType.ROUGH_CONDUCTOR,
        roughness=0.9,
        base_reflectance=(0.5, 0.5, 0.5),
        textured=True,
        name="chessboard",
    )
    sc = S.Scene(base.camera)
    sc.add(B._mesh(B.CORNELL_FLOOR, floor_mat, "floor"))
    sc.add(B._mesh(B.CORNELL_LIGHT, M.make_light_material(3.9), "light"))
    return sc


SCENES = {
    "demo": lambda B, M, S: B.demo_scene(),
    "chess_floor": _chess_floor_scene,
}


def _jax_tables(jpack):
    return dict(zip(TABLE_COLS, (np.asarray(t) for t in jax_mega_tables(jpack)[:8])))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tables_bitwise_equal_jax(name):
    jpack = SCENES[name](JB, JM, JS).compile()
    tpack = SCENES[name](TB, TM, TS).compile()
    want = _jax_tables(jpack)
    got = mega_tables(tpack)
    for k in TABLE_COLS:
        assert got[k].dtype == np.float32 and want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for s in STATIC:
        assert getattr(tpack, s) == getattr(jpack, s), s
    assert np.array_equal(tpack.mat_textured, np.asarray(jpack.mat_textured))
    assert bool(tpack.mat_textured.any()) == (name == "chess_floor")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tables_from_pack_matches_own_compile(name):
    jpack = SCENES[name](JB, JM, JS).compile()
    arrays = {f: np.asarray(getattr(jpack, f)) for f in PACK_FIELDS}
    static = {s: getattr(jpack, s) for s in PACK_STATIC}
    carried = tables_from_pack(arrays, static)
    own = SceneTables.from_pack(SCENES[name](TB, TM, TS).compile())
    _assert_same_tables(carried, own)
    assert own.tri.device.type == "cpu"
    assert set(dict(own.named_buffers())) == set(TABLE_COLS) | set(EXTRA)
    assert not own.use_env and not own.use_bvh


def _assert_same_tables(a, b):
    assert a.static() == b.static()
    for k in (*TABLE_COLS, *EXTRA):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def _many_triangles(S, M, n):
    rng = np.random.default_rng(0)
    v0 = rng.uniform(0.0, 500.0, (n, 1, 3)).astype(np.float32)
    pos = v0 + rng.uniform(1.0, 5.0, (n, 3, 3)).astype(np.float32) * np.eye(3, dtype=np.float32)
    sc = S.Scene()
    sc.add(S.TriangleMesh(pos, np.zeros((n, 3, 2), np.float32), M.Material(), "many"))
    sc.add(S.TriangleMesh(pos[:2] + 600.0, np.zeros((2, 3, 2), np.float32),
                          M.make_light_material(1.0), "light"))
    return sc


def _env_demo(B, M, S):
    sc = B.demo_scene()
    sc.env_pixels = np.random.default_rng(3).uniform(0.0, 1.0, (4, 8, 3)).astype(np.float32)
    return sc


FORMERLY_UNSUPPORTED = {
    # scene builder from either package, compile kwargs, uses the BVH, env
    "1025_triangles": (lambda B, M, S: _many_triangles(S, M, 1023), {}, True, False),
    "1032_table_rows": (lambda B, M, S: _many_triangles(S, M, 1030), {}, True, False),
    "env_map": (_env_demo, {}, False, True),
    "carried_env_map": (_env_demo, {"cluster_threshold": 8}, True, True),
}


@pytest.mark.parametrize("case", sorted(FORMERLY_UNSUPPORTED))
def test_formerly_unsupported_scenes_compile(case):
    """Scenes over 1024 triangles (here with two light triangles added) and
    env-map scenes compile, and their tables equal the JAX pack's carried
    across by `tables_from_pack` (its BVH and env map as they are)."""
    build, kw, bvh, env = FORMERLY_UNSUPPORTED[case]
    own = SceneTables.from_pack(build(TB, TM, TS).compile(**kw))
    jpack = build(JB, JM, JS).compile(**kw)
    assert (jpack.n_cl_nodes > 0) == bvh
    carried = tables_from_pack(
        {f: np.asarray(getattr(jpack, f)) for f in PACK_FIELDS},
        {s: getattr(jpack, s) for s in PACK_STATIC},
    )
    assert (own.use_bvh, own.use_env) == (bvh, env)
    _assert_same_tables(carried, own)


def test_1024_triangles_compile():
    pack = _many_triangles(TS, TM, 1022).compile()
    assert pack.tri_sc.shape == (1024, 16) and not pack.use_bvh
