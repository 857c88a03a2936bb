"""The CUDA megakernel on the card (marker `gpu`; each test skips without a
CUDA device). This file imports neither jax nor mcpt_tpu, so it also runs on
a GPU machine without them; tests/conftest.py imports jax, so there run

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m gpu

Bounds as in chip_smoke.py: per-lane ray counts equal on at least 98% of
lanes (on every lane for the env and BVH instances), radiance off by more
than 1e-3 on under 2% of lanes (ULP-level nearest-hit flips), means within
5e-3.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.kernels import megakernel as K
from mcpt_tpu_torch.kernels.megakernel_ref import cam_static, trace_block_ref
from mcpt_tpu_torch.kernels.tables import SceneTables
from mcpt_tpu_torch.render import render_mega

W, H = 32, 24
SKY = Path(__file__).resolve().parent.parent / "assets" / "sky.png"


@pytest.fixture
def cuda_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return SceneTables.from_pack(demo_scene().compile(), device="cuda")


def _agree(r, ry, r2, ry2):
    assert bool(torch.isfinite(r).all())
    assert (ry == ry2).float().mean().item() >= 0.98
    assert (ry.double().sum() - ry2.double().sum()).abs().item() <= 0.005 * ry2.double().sum().item()
    diff = (r - r2).abs()
    assert (diff > 1e-3).float().mean().item() < 0.02
    assert abs(r.double().mean().item() - r2.double().mean().item()) < 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("spp,mb", [(4, 6), (2, 1)])
def test_cuda_kernel_matches_plain_version(cuda_tables, spp, mb):
    """One launch of the kernel against its plain version on the same CUDA
    tables, at a lane offset inside the image."""
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    n, off = W * H * 3 - 100, 100
    before = K.trace_block.launches
    r, ry = K.trace_block(cuda_tables, cs, 11, off, spp, n, mb)
    torch.cuda.synchronize()
    assert K.trace_block.launches == before + 1
    assert r.device.type == "cuda" and r.shape == ry.shape == (n,)
    _agree(r, ry, *trace_block_ref(cuda_tables, cs, 11, off, spp, n, mb))


@pytest.mark.gpu
def test_render_mega_goes_through_the_kernel(cuda_tables):
    cam = dataclasses.replace(demo_scene().camera, width=W, height=H)
    before = K.trace_block.launches
    img, stats = render_mega(cuda_tables, cam, 4, seed=3, max_bounces=4, device="cuda")
    assert K.trace_block.launches == before + 1
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    r2, ry2 = trace_block_ref(cuda_tables, cam_static(cam), 3, 0, 4, W * H * 3, 4)
    assert abs(stats["rays"] - ry2.double().sum().item()) <= 0.005 * stats["rays"]
    assert np.abs(img - r2.cpu().numpy().reshape(H, W, 3)).mean() < 5e-3


@pytest.mark.gpu
def test_trace_block_rejects_what_the_kernel_does_not_take(cuda_tables):
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    with pytest.raises(ValueError, match="lanes outside the image"):
        K.trace_block(cuda_tables, cs, 0, 1, 1, W * H * 3, 2)
    cuda_tables.tri = cuda_tables.tri.double()
    with pytest.raises(ValueError, match="table tri"):
        K.trace_block(cuda_tables, cs, 0, 0, 1, 96, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("env,bvh", [(True, False), (False, True), (True, True)])
def test_cuda_env_and_bvh_instances_match_plain_version(env, bvh):
    """The env-map and BVH-walk instances of the kernel against the plain
    version, on the DEMO under assets/sky.png and forced onto the BVH walk
    with cluster_threshold=8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    sc = demo_scene()
    if env:
        sc.load_env_map(SKY)
    pack = sc.compile(cluster_threshold=8 if bvh else 1024)
    tables = SceneTables.from_pack(pack, device="cuda")
    assert (tables.use_env, tables.use_bvh) == (env, bvh)
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    n = W * H * 3
    name = f"mega_regen<4, {str(env).lower()}, {str(bvh).lower()}>"
    before = K.trace_block.by_instance[name]
    r, ry = K.trace_block(tables, cs, 7, 0, 4, n, 6)
    torch.cuda.synchronize()
    assert K.trace_block.last_instance == name
    assert K.trace_block.by_instance[name] == before + 1
    r2, ry2 = trace_block_ref(tables, cs, 7, 0, 4, n, 6)
    assert torch.equal(ry, ry2)
    _agree(r, ry, r2, ry2)


@pytest.mark.gpu
@pytest.mark.parametrize("n_dir,cap", [(32, 32), (8, 16)])
def test_cuda_generic_light_count_matches_plain_version(n_dir, cap):
    """The generic-S instances on the BVH walk under the sky map: at 32
    light samples, the count conf.json asks for in fixed mode, and at 8,
    which the instance capped at 16 takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    sc = demo_scene()
    sc.load_env_map(SKY)
    sc.n_dir_sample = n_dir
    tables = SceneTables.from_pack(sc.compile(cluster_threshold=8), device="cuda")
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    n = W * H * 3
    r, ry = K.trace_block(tables, cs, 9, 0, 2, n, 4)
    torch.cuda.synchronize()
    assert K.trace_block.last_instance == f"mega_regen<-{cap}, true, true>"
    r2, ry2 = trace_block_ref(tables, cs, 9, 0, 2, n, 4)
    assert torch.equal(ry, ry2)
    _agree(r, ry, r2, ry2)
