"""The port's lane-strided launches and `render_mega_sharded`, on the CPU.

- Strided and sharded renders are bitwise equal to the single-device
  render: the random numbers key on the absolute lane id, so how lanes are
  dealt to launches changes nothing (tests/test_megakernel.py::
  test_mega_sharded_8dev). One device listed k times runs the k strided
  launch sets one after another.
- The sharded render's bookkeeping (pad lanes, per-device rays including the
  pad lanes' real wrapped paths) equals JAX's `render_mega_sharded` on two
  virtual CPU devices; the images within the repo's bound
  (tests/test_megakernel.py:202-204).
- Both kernels' images against the wavefront engine at higher spp, as
  tests/test_megakernel.py::test_mega_matches_wavefront_mean holds the JAX
  kernels: whole-image means within the pooled estimate's noise (35%).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mcpt_tpu.builtin_scenes import demo_scene as jax_demo_scene
from mcpt_tpu.kernels import megakernel as J

from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.kernels import megakernel as K
from mcpt_tpu_torch.kernels.megakernel_ref import cam_static
from mcpt_tpu_torch.kernels.tables import SceneTables
from mcpt_tpu_torch.render import render_mega, render_mega_sharded, render_radiance

W, H = 16, 8
SPP = 8
MB = 4


@pytest.fixture(scope="module")
def tables():
    return SceneTables.from_pack(demo_scene().compile())


@pytest.mark.parametrize("regen", [True, False])
@pytest.mark.parametrize("k", [1, 3])
def test_sharded_equals_single_device(tables, k, regen):
    cam = dataclasses.replace(demo_scene().camera, width=W, height=H)
    single, s1 = render_mega(tables, cam, 2, seed=5, max_bounces=3, device="cpu", regen=regen)
    sharded, sk = render_mega_sharded(tables, cam, 2, seed=5, devices=["cpu"] * k,
                                      max_bounces=3, regen=regen)
    assert np.array_equal(single, sharded)
    assert s1["rays"] == sk["rays"]
    assert sk["devices"] == k and len(sk["per_device_rays"]) == k
    assert sk["pad_lanes"] == k * 1024 - W * H * 3
    assert sum(sk["per_device_rays"]) >= sk["rays"]


@pytest.mark.parametrize("regen", [True, False])
def test_strided_block_equals_whole_image(tables, regen):
    """One launch over every 5th lane from lane 7 (past the image's end:
    pad lanes) equals those lanes of a launch over all of them."""
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=8, height=4))
    r, ry = K.trace_block(tables, cs, 3, 0, 2, 200, 3, regen=regen)
    r2, ry2 = K.trace_block(tables, cs, 3, 7, 2, 39, 3, regen=regen, lane_stride=5)
    assert torch.equal(r[7::5], r2) and torch.equal(ry[7::5], ry2)
    with pytest.raises(ValueError, match="int32"):
        K.trace_block(tables, cs, 3, 2**31 - 10, 2, 4, 3, regen=regen, lane_stride=5)
    with pytest.raises(ValueError, match="int32"):
        K.trace_block(tables, cs, 3, -1, 2, 4, 3, regen=regen)


@pytest.fixture
def single_slot_jax(monkeypatch):
    """trace_mega_block reads its knobs at trace time: drop cached traces
    before and after so neither this test nor a later one reuses another's
    (the single-slot, unroll-1 regen kernel traces in seconds)."""
    monkeypatch.setenv("MCPT_MEGA_UNROLL", "1")
    monkeypatch.setenv("MCPT_MEGA_SPLIT", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("regen", [True, False])
def test_sharded_bookkeeping_matches_jax(single_slot_jax, tables, regen):
    cam = dataclasses.replace(jax_demo_scene().camera, width=8, height=8)
    want, ws = J.render_mega_sharded(jax_demo_scene().compile(), cam, 2, seed=0,
                                     devices=jax.devices()[:2], max_bounces=2,
                                     interpret=True, regen=regen)
    got, gs = render_mega_sharded(tables, cam, 2, seed=0, devices=["cpu", "cpu"],
                                  max_bounces=2, regen=regen)
    assert gs["devices"] == ws["devices"] == 2
    assert gs["pad_lanes"] == ws["pad_lanes"]
    assert gs["per_device_rays"] == ws["per_device_rays"]
    assert gs["rays"] == ws["rays"]
    diff = np.abs(got - np.asarray(want))
    assert (diff > 1e-3).mean() < 0.02
    assert abs(got.mean() - np.asarray(want).mean()) < 5e-3


@pytest.fixture(scope="module")
def wavefront_img():
    cam = dataclasses.replace(demo_scene().camera, width=W, height=H)
    img, _ = render_radiance(demo_scene(), cam, 32, method="dense", max_bounces=MB,
                             tile_pixels=W * H, device="cpu")
    return img


@pytest.mark.parametrize("regen", [False, True])
def test_mega_matches_wavefront_mean(tables, wavefront_img, regen):
    cam = dataclasses.replace(demo_scene().camera, width=W, height=H)
    img, stats = render_mega(tables, cam, SPP, seed=0, max_bounces=MB, device="cpu",
                             regen=regen)
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    # border columns see only the (black) background in this camera setup
    assert img[:, :2].max() == 0.0
    assert img[:, 4:12].mean() > 0.05
    ref_mean = wavefront_img.mean()
    assert abs(img.mean() - ref_mean) / ref_mean < 0.35
    # 1 camera ray per sample plus (1 + 4 shadow rays) per vertex, <= MB vertices
    lanes = W * H * 3
    assert lanes * SPP <= stats["rays"] <= lanes * SPP * (1 + 5 * MB)
