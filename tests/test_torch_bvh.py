"""The port's BVH builder and its BVH walks against the JAX package and
against the port's own brute-force sweeps, on the CPU.

- `mcpt_tpu_torch.bvh.build_bvh` is a numpy copy of `mcpt_tpu.bvh.build_bvh`
  (the JAX package's Python builder) and must give the same flat tree, bit
  for bit, in both split modes.
- The plain version's stackless walks (`bvh_nearest`, `bvh_fan`) must give
  exactly the brute sweep's answers on random rays inside the x4-scaled
  Cornell box of tests/test_megakernel.py:207-279 (chessboard-scale
  coordinates, where absolute epsilons would leak light): the same hit
  record and bitwise t, ties included (both keep the lower triangle row and
  prefer triangles to spheres), and the same visibility bits.
- That scene rendered through the port's BVH path (cluster_threshold=8)
  must match the JAX megakernel's render of its shared-memory pack: ray
  counts exactly equal and the repo's bound (tests/test_megakernel.py:
  202-204: under 2% of pixels off by more than 1e-3, means within 5e-3).
  Dropping every 4th triangle from the port's tables must break that bound.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import mcpt_tpu.builtin_scenes as JB
import mcpt_tpu.camera as JC
import mcpt_tpu.materials as JM
import mcpt_tpu.scene as JS
from mcpt_tpu.bvh import build_bvh as jax_build_bvh
from mcpt_tpu.kernels.megakernel import render_mega as jax_render_mega

import mcpt_tpu_torch.builtin_scenes as TB
import mcpt_tpu_torch.camera as TC
import mcpt_tpu_torch.materials as TM
import mcpt_tpu_torch.scene as TS
from mcpt_tpu_torch.bvh import build_bvh
from mcpt_tpu_torch.kernels.megakernel_ref import (
    bvh_fan,
    bvh_nearest,
    intersect_tile,
    occlude_shared_origin,
)
from mcpt_tpu_torch.kernels.tables import SceneTables
from mcpt_tpu_torch.render import render_mega

FLAT = ("node_min", "node_max", "node_miss", "leaf_start", "leaf_count", "prim_ids")
K = 4.0


def cornell_x4(B, M, S, C, width=24, height=24):
    """tests/test_megakernel.py:207-279's scene, from either package."""
    mats = M.standard_materials()
    camera = C.Camera(width=width, height=height, fov=40.0,
                      position=(278.0 * K, 273.0 * K, -800.0 * K),
                      target=(278.0 * K, 273.0 * K, 0.0), up=(0.0, 1.0, 0.0))
    sc = S.Scene(camera)
    for quads, m, name in [
        (B.CORNELL_FLOOR, mats["rough_white_conductor"], "back"),
        (B.CORNELL_SHORTBOX, mats["green_mirror"], "shortbox"),
        (B.CORNELL_TALLBOX, mats["rough_plastic"], "tallbox"),
        (B.CORNELL_LEFT, mats["rough_red_conductor"], "left"),
        (B.CORNELL_RIGHT, mats["gold_conductor"], "right"),
        (B.CORNELL_LIGHT, M.make_light_material(3.9), "light"),
    ]:
        sc.add(B._mesh(np.asarray(quads) * K, m, name))
    sc.add(S.Sphere((400.0 * K, 90.0 * K, 3.0 * K), 80.0 * K, mats["smooth_glass"], "big"))
    sc.add(S.Sphere((250.0 * K, 260.0 * K, 230.0 * K), 60.0 * K,
                    mats["clear_rough_plastic"], "mid"))
    return sc


@pytest.mark.parametrize("n", [1, 37, 1500])
@pytest.mark.parametrize("method", ["median", "sah"])
def test_build_bvh_bitwise_equal_jax(method, n):
    rng = np.random.default_rng(n)
    lo = rng.uniform(-50.0, 50.0, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 4.0, (n, 3)).astype(np.float32)
    lo[: n // 10] = lo[0]  # a cluster of equal boxes: the degenerate split
    hi[: n // 10] = hi[0]
    got = build_bvh(lo, hi, leaf_size=4, method=method)
    want = jax_build_bvh(lo, hi, leaf_size=4, method=method)
    for k in FLAT:
        a, b = getattr(got, k), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.max_leaf_count == want.max_leaf_count


@pytest.fixture(scope="module")
def x4_tables():
    sc = cornell_x4(TB, TM, TS, TC)
    brute = SceneTables.from_pack(sc.compile())
    bvh = SceneTables.from_pack(sc.compile(cluster_threshold=8))
    assert bvh.use_bvh and not brute.use_bvh
    return brute, bvh


def _rays(rng, n):
    lo = np.float32([0.0, 0.0, -200.0 * K])
    hi = np.float32([556.0 * K, 548.8 * K, 559.2 * K])
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _t3(x):
    return tuple(torch.tensor(np.ascontiguousarray(x[:, k])) for k in range(3))


def test_bvh_nearest_equals_brute_sweep(x4_tables):
    """4096 random rays: every field of the hit record bitwise equal."""
    brute, bvh = x4_tables
    o, d = _rays(np.random.default_rng(0), 4096)
    want = intersect_tile(brute.tri, brute.sph, _t3(o), _t3(d), textured=True)
    got = bvh_nearest(bvh, _t3(o), _t3(d), torch.ones(4096, dtype=torch.bool))
    assert 0.5 < got[1].float().mean().item() <= 1.0  # happened

    def fields(rec):  # (t, happened, p, n, uv, mat, emissive), tuples flattened
        return [x for f in rec for x in (f if isinstance(f, tuple) else (f,))]

    for a, b in zip(fields(got), fields(want), strict=True):
        assert torch.equal(a, b)


def test_bvh_fan_equals_brute_fan(x4_tables):
    """4096 origins, 4 shadow rays each towards random points: the
    visibility bits of the BVH walk equal the brute fan's over the same
    triangles. (The kernel's brute fan sweeps the occluder table, culled of
    triangles that cannot block a segment between two surface points; these
    random segments can end anywhere, so this test sweeps every triangle.)"""
    brute, bvh = x4_tables
    rng = np.random.default_rng(1)
    o, _ = _rays(rng, 4096)
    ds, dists = [], []
    for _ in range(4):
        p, _ = _rays(rng, 4096)
        delta = p - o
        dist = np.sqrt((delta * delta).sum(1)).astype(np.float32)
        ds.append(_t3((delta / dist[:, None]).astype(np.float32)))
        dists.append(torch.tensor(dist))
    want = occlude_shared_origin(brute.tri, brute.sph, _t3(o), ds, dists)
    got = bvh_fan(bvh, _t3(o), ds, dists, torch.ones(4096, dtype=torch.bool))
    for a, b in zip(got, want):
        assert 0.1 < a.float().mean().item() < 0.9
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_x4_render():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCPT_MEGA_UNROLL", "1")
        mp.setenv("MCPT_MEGA_SPLIT", "1")
        jax.clear_caches()
        sc = cornell_x4(JB, JM, JS, JC)
        pack = sc.compile()
        assert pack.n_cl_nodes == 0
        img, stats = jax_render_mega(pack, sc.camera, 4, seed=3, max_bounces=4, interpret=True)
        jax.clear_caches()
    return np.asarray(img), stats


@pytest.mark.parametrize("arm", ["bvh", "drop_every_4th_triangle"])
def test_bvh_render_matches_jax_smem_pack(jax_x4_render, arm):
    want, wstats = jax_x4_render
    sc = cornell_x4(TB, TM, TS, TC)
    tables = SceneTables.from_pack(sc.compile(cluster_threshold=8))
    assert tables.use_bvh
    if arm != "bvh":
        tables.tri[::4, 12] = 0.0  # nr2: the Woop and fan tests reject the row
        tables.tri[::4, 13] = 0.0  # valid
        # the walks read the leaf-ordered copy; col 25 holds the row of `tri`
        every_4th = tables.leaf_tri.view(torch.int32)[:, 25] % 4 == 0
        tables.leaf_tri[every_4th, 12] = 0.0
        tables.leaf_tri[every_4th, 13] = 0.0
    got, stats = render_mega(tables, sc.camera, 4, seed=3, max_bounces=4, device="cpu")
    diff = np.abs(got - want)
    mismatch = float((diff > 1e-3).mean())
    if arm == "bvh":
        assert stats["rays"] == wstats["rays"]
        assert mismatch < 0.02, mismatch
        assert abs(got.mean() - want.mean()) < 5e-3
    else:
        assert mismatch > 0.05, mismatch


def test_tables_carry_the_jax_bvh(x4_tables):
    """`convert.tables_from_pack` carries the JAX pack's flat BVH (built by
    its native builder) as it is: the same walk tables as the port's own
    compile of the same scene, whose numpy builder gives the same tree."""
    from mcpt_tpu_torch.convert import PACK_FIELDS, PACK_STATIC, tables_from_pack

    _, own = x4_tables
    jpack = cornell_x4(JB, JM, JS, JC).compile(cluster_threshold=8)
    assert jpack.n_cl_nodes > 0
    carried = tables_from_pack(
        {f: np.asarray(getattr(jpack, f)) for f in PACK_FIELDS},
        {s: getattr(jpack, s) for s in PACK_STATIC},
    )
    assert carried.static() == own.static()
    for k, _ in own.named_buffers():
        assert torch.equal(getattr(carried, k), getattr(own, k)), k
