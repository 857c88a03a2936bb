"""The port's wavefront pieces against the JAX package, on the CPU: the scene
fields the wavefront reads, primary-ray generation, and the intersector
kernels' plain version (`kernels/intersect_prims_ref.py`, what
`csrc/intersect_prims.cu` computes) against the Pallas kernels K2
(`intersect_prims_pallas_c`), K3 (`intersect_tris_pallas_mm`) and K4
(`intersect_tris_pallas`) run in interpret mode, plus the port's
intersection methods against each other.

Bounds: the pack fields are bitwise equal; prim agrees on at least 99.9% of
rays, t within 1e-5·max(t, |o|∞) where prim agrees, u and v within 1e-4.
The remainder allows ULP-level winner flips: XLA's CPU backend contracts the
Woop products into FMAs, the port rounds each (t comes out of o·w − c, whose
rounding scales with the origin's coordinates).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcpt_tpu.builtin_scenes as JB
import mcpt_tpu.materials as JM
import mcpt_tpu.scene as JS
from mcpt_tpu.camera import generate_rays_c as jax_generate_rays_c
from mcpt_tpu.kernels.intersect_pallas import (
    intersect_prims_pallas_c,
    intersect_tris_pallas,
    intersect_tris_pallas_mm,
)

import mcpt_tpu_torch.builtin_scenes as TB
import mcpt_tpu_torch.materials as TM
import mcpt_tpu_torch.scene as TS
from mcpt_tpu_torch import prng
from mcpt_tpu_torch.convert import PACK_FIELDS, PACK_STATIC, pack_from_arrays
from mcpt_tpu_torch.intersect import intersect_brute, intersect_c, occlude_t_c
from mcpt_tpu_torch.kernels.intersect_prims import intersect_prims_c, intersect_tris
from mcpt_tpu_torch.kernels.wavefront import camera_rays

AGREE = 0.999
WAVEFRONT_FIELDS = (
    "tri_w", "tri_c", "tri_nr2", "tri_valid", "tri_mt", "prim_emissive", "tri_shade",
    "tri_sc", "sph_geom", "sph_shade", "mat_fat", "emt_fat", "bvh_fat",
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU thread pool costs far more than it saves at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soup(S, M, n=1200, spheres=False):
    """n random triangles in [-1, 1]^3 (a K3-sized table: 1200 > 1024 rows),
    and optionally two spheres and an emitter."""
    rng = np.random.default_rng(11)
    v0 = rng.uniform(-1.0, 1.0, (n, 3))
    pos = np.stack([v0, v0 + rng.uniform(-0.2, 0.2, (n, 3)), v0 + rng.uniform(-0.2, 0.2, (n, 3))], 1)
    sc = S.Scene()
    sc.add(S.TriangleMesh(pos.astype(np.float32), np.zeros((n, 3, 2), np.float32), M.Material(), "soup"))
    if spheres:
        sc.add(S.Sphere((0.3, 0.2, -0.4), 0.35, M.Material(), "a"))
        sc.add(S.Sphere((-0.5, -0.3, 0.5), 0.25, M.make_light_material(2.0), "b"))
    return sc


def _rays(n, lo, hi, seed, aim=None):
    """n rays from uniform points of the box [lo, hi]; directions random, or
    toward uniform points of the box `aim`."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3))
    if aim is None:
        d = rng.normal(size=(n, 3))
    else:
        d = rng.uniform(*aim, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _cols(x):
    return tuple(torch.from_numpy(np.ascontiguousarray(x[:, k])) for k in range(3))


def _agree(o, t, prim, u, v, t2, prim2, u2, v2):
    """The module's bounds; (t, prim, u, v) numpy, the second set the
    reference."""
    same = prim == prim2
    assert same.mean() >= AGREE, same.mean()
    scale = np.maximum(np.maximum(t2, np.abs(o).max(axis=1)), 1.0)
    hit = same & (prim2 >= 0)
    assert np.all(np.abs(t - t2)[hit] <= 1e-5 * scale[hit])
    assert np.all(t[same & (prim2 < 0)] == t2[same & (prim2 < 0)])
    if u is not None:
        assert np.abs(u - u2)[hit].max(initial=0.0) <= 1e-4
        assert np.abs(v - v2)[hit].max(initial=0.0) <= 1e-4


SCENES = {
    "demo": lambda B, M, S: B.demo_scene(),
    "soup_spheres": lambda B, M, S: _soup(S, M, 200, spheres=True),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_wavefront_pack_fields_bitwise_equal_jax(name):
    """Scene.compile()'s wavefront fields equal mcpt_tpu's, and
    `pack_from_arrays` carries the JAX pack's across as they are."""
    jpack = SCENES[name](JB, JM, JS).compile()
    tpack = SCENES[name](TB, TM, TS).compile()
    carried = pack_from_arrays(
        {f: np.asarray(getattr(jpack, f)) for f in PACK_FIELDS},
        {s: getattr(jpack, s) for s in PACK_STATIC},
    )
    assert tpack.n_tris == jpack.n_tris == carried.n_tris
    TS.fat_bvh(tpack)
    for f in WAVEFRONT_FIELDS:
        want = np.asarray(getattr(jpack, f))
        for got in (getattr(tpack, f), getattr(carried, f)):
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("dof,w,h", [(False, 16, 8), (True, 15, 9)])
def test_generate_rays_match_jax(dof, w, h):
    cam_j = dataclasses.replace(JB.demo_scene().camera, width=w, height=h, use_dof=dof,
                                focal_distance=800.0, aperture_radius=8.0)
    cam_t = dataclasses.replace(TB.demo_scene().camera, width=w, height=h, use_dof=dof,
                                focal_distance=800.0, aperture_radius=8.0)
    ids = np.arange(w * h, dtype=np.int32)
    oj, dj = jax_generate_rays_c(cam_j, jnp.asarray(ids), jax.random.key(9))
    ot, dt = camera_rays(cam_t, torch.from_numpy(ids), prng.key(9))
    for k in range(3):
        # sin/cos and XLA's FMAs move the thin-lens rays by a few ULPs
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(dt[k].numpy(), np.asarray(dj[k]), rtol=0, atol=2e-6)
    if not dof:
        for k in range(3):
            np.testing.assert_array_equal(ot[k].numpy(), np.asarray(oj[k]))


@pytest.fixture(scope="module")
def demo_packs():
    return JB.demo_scene().compile(), TB.demo_scene().compile()


@pytest.mark.parametrize("occlusion", [False, True])
def test_k2_plain_version_matches_pallas(demo_packs, occlusion):
    """K2 (`_kernel_sc`) on the DEMO: 512 rays from points inside the box."""
    jp, tp = demo_packs
    o, d = _rays(512, (1.0, 1.0, 1.0), (555.0, 547.0, 558.0), seed=3)
    oc = tuple(jnp.asarray(o[:, k]) for k in range(3))
    dc = tuple(jnp.asarray(d[:, k]) for k in range(3))
    want = intersect_prims_pallas_c(jp.tri_sc, jp.sph_geom, jp.n_tris, oc, dc,
                                    interpret=True, occlusion=occlusion)
    got = intersect_prims_c(torch.from_numpy(tp.tri_sc), torch.from_numpy(tp.sph_geom),
                            tp.n_tris, _cols(o), _cols(d), occlusion=occlusion)
    if occlusion:
        assert got[1] is None
        t, t2 = got[0].numpy(), np.asarray(want[0])
        ok = (t < 1e30) == (t2 < 1e30)
        assert ok.mean() >= AGREE
        scale = np.maximum(np.maximum(t2, np.abs(o).max(axis=1)), 1.0)
        assert np.mean(np.abs(t - t2) <= 1e-5 * scale) >= AGREE
        return
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    assert got[1].dtype == np.int32 and (got[1] >= tp.n_tris).any()  # spheres hit
    _agree(o, *got, *want)


@pytest.fixture(scope="module")
def soup_packs():
    return _soup(JS, JM).compile(), _soup(TS, TM).compile()


def test_k3_plain_version_matches_pallas_mm(soup_packs):
    """K3 (`_kernel_mm`, the matmul form) on a 1,200-triangle soup, 256 rays
    aimed into it."""
    jp, tp = soup_packs
    assert tp.tri_sc.shape[0] > 1024
    o, d = _rays(256, (-3.0, -3.0, -3.0), (3.0, 3.0, 3.0), seed=4, aim=((-1, -1, -1), (1, 1, 1)))
    want = [np.asarray(x) for x in intersect_tris_pallas_mm(
        jp.tri_kern, jnp.asarray(o), jnp.asarray(d), interpret=True)]
    empty = torch.zeros((0, 4), dtype=torch.float32)
    got = [x.numpy() for x in intersect_prims_c(
        torch.from_numpy(tp.tri_sc), empty, tp.n_tris, _cols(o), _cols(d))]
    assert (want[1] >= 0).mean() > 0.5
    _agree(o, *got, *want)
    occ_want = np.asarray(intersect_tris_pallas_mm(
        jp.tri_kern, jnp.asarray(o), jnp.asarray(d), interpret=True, occlusion=True)[0])
    occ = intersect_prims_c(torch.from_numpy(tp.tri_sc), empty, tp.n_tris, _cols(o), _cols(d),
                            occlusion=True)[0].numpy()
    np.testing.assert_array_equal(occ, got[0])
    scale = np.maximum(np.maximum(occ_want, np.abs(o).max(axis=1)), 1.0)
    assert np.mean(np.abs(occ - occ_want) <= 1e-5 * scale) >= AGREE


def test_k4_plain_version_matches_pallas(soup_packs):
    """K4 (`_kernel`, triangles only, (B, 3) rows) on the soup's table."""
    jp = soup_packs[0]
    o, d = _rays(256, (-3.0, -3.0, -3.0), (3.0, 3.0, 3.0), seed=5, aim=((-1, -1, -1), (1, 1, 1)))
    want = [np.asarray(x) for x in intersect_tris_pallas(
        jp.tri_kern, jnp.asarray(o), jnp.asarray(d), interpret=True)]
    rows = torch.from_numpy(np.ascontiguousarray(np.asarray(jp.tri_kern).T))
    got = [x.numpy() for x in intersect_tris(rows, torch.from_numpy(o), torch.from_numpy(d))]
    assert (want[1] >= 0).mean() > 0.5
    _agree(o, *got, *want)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_intersect_methods_agree(name):
    """dense, bvh, the kernel's plain version and the brute-force oracle give
    the same nearest hits in the port (and occlude_t_c the same t)."""
    tp = SCENES[name](TB, TM, TS).compile()
    pack = TS.pack_to(tp, "cpu", bvh=True)
    if name == "demo":
        o, d = _rays(512, (1.0, 1.0, 1.0), (555.0, 547.0, 558.0), seed=6)
    else:
        o, d = _rays(512, (-2.0, -2.0, -2.0), (2.0, 2.0, 2.0), seed=6,
                     aim=((-0.8, -0.8, -0.8), (0.8, 0.8, 0.8)))
    oc, dc = _cols(o), _cols(d)
    ref = intersect_brute(pack, torch.from_numpy(o), torch.from_numpy(d))
    ref = [x.numpy() for x in ref]
    assert (ref[1] >= pack.n_tris).any() and (ref[1] < 0).mean() < 0.9
    for method in ("dense", "bvh", "kernel"):
        got = [x.numpy() for x in intersect_c(pack, oc, dc, method=method)]
        _agree(o, *got, *ref)
        occ = occlude_t_c(pack, oc, dc, method=method).numpy()
        np.testing.assert_array_equal(occ, got[0])
