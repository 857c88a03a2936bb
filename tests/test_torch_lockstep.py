"""The port's lockstep path (`render_mega(..., regen=False)`, the plain
version of the lockstep kernel on CPU tensors) against the JAX lockstep
megakernel `mcpt_tpu.kernels.megakernel.render_mega(..., regen=False,
interpret=True)`, on the CPU.

Both draw the same murmur3 counter-hash uniforms, keyed per sample and depth
(megakernel.py:1700-1766), so they agree far more tightly than Monte-Carlo
noise: ray counts equal on every lane, images within the repo's own bound
(tests/test_megakernel.py:202-204): under 2% of pixels off by more than
1e-3, means within 5e-3. The bound is not bitwise because XLA's CPU rsqrt is
about 1 ULP off and XLA contracts `a*b+c` into FMAs inside compiled loops,
where the port rounds every product; a ULP moves a nearest hit now and then,
and the reverse clamp fold carries it on.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mcpt_tpu.builtin_scenes as JB
import mcpt_tpu.camera as JC
import mcpt_tpu.materials as JM
import mcpt_tpu.scene as JS
from mcpt_tpu.kernels import megakernel as J

import mcpt_tpu_torch.builtin_scenes as TB
import mcpt_tpu_torch.camera as TC
import mcpt_tpu_torch.materials as TM
import mcpt_tpu_torch.scene as TS
from mcpt_tpu_torch.kernels import megakernel as K
from mcpt_tpu_torch.kernels.megakernel_ref import cam_static
from mcpt_tpu_torch.kernels.tables import SceneTables
from mcpt_tpu_torch.render import render_mega
from test_torch_bvh import cornell_x4

W, H = 16, 8


def _within_bound(got, want):
    diff = np.abs(got - want)
    assert (diff > 1e-3).mean() < 0.02, float((diff > 1e-3).mean())
    assert abs(got.mean() - want.mean()) < 5e-3


@pytest.mark.parametrize("spp,mb", [(4, 4), (2, 1)])
def test_lockstep_render_matches_jax_megakernel(spp, mb):
    seed = 1
    jpack = JB.demo_scene().compile()
    cam = dataclasses.replace(JB.demo_scene().camera, width=W, height=H)
    want, wstats = J.render_mega(jpack, cam, spp, seed=seed, max_bounces=mb, interpret=True,
                                 regen=False)
    want = np.asarray(want)
    # per-lane ray counts: the same (cached) kernel call render_mega made
    lanes = W * H * 3
    _, jrays, _ = J.trace_mega_block(
        jpack, cam, seed, 0, spp, -(-lanes // J.CHUNK) * J.CHUNK, mb, True, False,
        False, tile=None,
    )
    jrays = np.asarray(jrays)[:lanes]

    pack = TB.demo_scene().compile()
    got, stats = render_mega(pack, cam, spp, seed=seed, max_bounces=mb, device="cpu",
                             regen=False)
    tables = SceneTables.from_pack(pack)
    _, trays = K.trace_block(tables, cam_static(cam), seed, 0, spp, lanes, mb, regen=False)

    assert got.shape == want.shape == (H, W, 3) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(trays.numpy(), jrays)
    assert stats["rays"] == wstats["rays"] == int(jrays.sum())
    _within_bound(got, want)
    for k in ("camera_samples", "wavelength_paths"):
        assert stats[k] == wstats[k], k
    assert got[:, 4:12].mean() > 0.02  # the box is lit


@pytest.fixture(scope="module")
def jax_x4_lockstep():
    sc = cornell_x4(JB, JM, JS, JC)
    pack = sc.compile()
    assert pack.n_cl_nodes == 0
    img, stats = J.render_mega(pack, sc.camera, 4, seed=3, max_bounces=4, interpret=True,
                               regen=False)
    return np.asarray(img), stats


@pytest.mark.parametrize("arm", ["bvh", "drop_every_4th_triangle"])
def test_lockstep_bvh_render_matches_jax_smem_pack(jax_x4_lockstep, arm):
    """The x4-scaled Cornell box (tests/test_megakernel.py:207-279) through
    the port's BVH lockstep path (cluster_threshold=8) against JAX's
    lockstep kernel on its shared-memory pack; dropping every 4th triangle
    from the port's tables must break the bound."""
    want, wstats = jax_x4_lockstep
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
    got, stats = render_mega(tables, sc.camera, 4, seed=3, max_bounces=4, device="cpu",
                             regen=False)
    diff = np.abs(got - want)
    mismatch = float((diff > 1e-3).mean())
    if arm == "bvh":
        assert stats["rays"] == wstats["rays"]
        _within_bound(got, want)
    else:
        assert mismatch > 0.05, mismatch


@pytest.mark.parametrize("regen", [False, True])
def test_no_phantom_padding_triangle(regen):
    """tests/test_megakernel.py::test_mega_no_phantom_padding_triangle on the
    port: a 3-triangle scene (5 pad rows in the 8-row table, nr2 = 0) viewed
    through the origin renders pure background, one camera ray a sample."""
    cam = TC.Camera(width=8, height=8, fov=40, position=(0.3, 0.3, -2.0),
                    target=(0.3, 0.3, 0.0), up=(0, 1, 0))
    sc = TS.Scene(cam)
    tri = np.array([[[50, 0, 10], [51, 0, 10], [50, 1, 10]]], np.float32)
    quad = np.array([[[50, 5, 10], [51, 5, 10], [51, 5, 11]],
                     [[50, 5, 10], [51, 5, 11], [50, 5, 11]]], np.float32)
    sc.add(TS.TriangleMesh(tri, np.zeros((1, 3, 2), np.float32), TM.Material(), "tri"))
    sc.add(TS.TriangleMesh(quad, np.zeros((2, 3, 2), np.float32),
                           TM.make_light_material(5.0), "light"))
    tables = SceneTables.from_pack(sc.compile())
    assert tables.tri.shape[0] == 8 and float(tables.tri[3:, 12].abs().max()) == 0.0
    img, stats = render_mega(tables, cam, 4, seed=0, max_bounces=3, device="cpu", regen=regen)
    assert np.array_equal(img, np.zeros_like(img))
    assert stats["rays"] == 8 * 8 * 3 * 4


def test_lockstep_refuses_env_scenes():
    """As JAX's render_mega (megakernel.py:3313): an env map needs regen."""
    sc = TB.demo_scene()
    sc.env_pixels = np.zeros((4, 8, 3), np.float32)
    tables = SceneTables.from_pack(sc.compile())
    assert tables.use_env
    cam = dataclasses.replace(sc.camera, width=4, height=4)
    with pytest.raises(ValueError, match="regen"):
        render_mega(tables, cam, 1, device="cpu", regen=False)
    with pytest.raises(ValueError, match="regen"):
        K.trace_block(tables, cam_static(cam), 0, 0, 1, 48, 2, regen=False)
    img, _ = render_mega(tables, cam, 1, max_bounces=2, device="cpu")  # regen takes it
    assert img.shape == (4, 4, 3)
