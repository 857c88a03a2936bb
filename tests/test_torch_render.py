"""The port's render path against the JAX megakernel, end to end on the CPU.

`mcpt_tpu_torch.render.render_mega` (plain PyTorch version of the kernel on
CPU tensors) against `mcpt_tpu.kernels.megakernel.render_mega(...,
interpret=True)` on the DEMO scene at 16x8, the way tests/test_megakernel.py
runs it, with the single-slot, unroll-1 kernel (MCPT_MEGA_SPLIT=1,
MCPT_MEGA_UNROLL=1: the same per-sample arithmetic, only the per-lane sum
order of the default 4-slot kernel differs, megakernel.py:3050-3054). Both
draw the same murmur3 counter-hash uniforms, so they agree far more tightly
than Monte-Carlo noise: total rays within 0.5% and per-lane ray counts equal
on at least 98% of lanes (both measured exactly equal), images within the
repo's own bound (tests/test_megakernel.py:202-204): under 2% of pixels off
by more than 1e-3, means within 5e-3.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mcpt_tpu.builtin_scenes import demo_scene as jax_demo_scene
from mcpt_tpu.kernels import megakernel as J

from chip_smoke import write_stand_in_models
from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.io.png import read_png
from mcpt_tpu_torch.kernels import megakernel as K
from mcpt_tpu_torch.kernels.megakernel_ref import cam_static, trace_block_ref
from mcpt_tpu_torch.kernels.tables import SceneTables
from mcpt_tpu_torch.render import render_mega

ROOT = Path(__file__).resolve().parent.parent
W, H = 16, 8


@pytest.fixture
def single_slot_jax(monkeypatch):
    """trace_mega_block reads its knobs at trace time: drop cached traces
    before and after so neither this test nor a later one reuses another's."""
    monkeypatch.setenv("MCPT_MEGA_UNROLL", "1")
    monkeypatch.setenv("MCPT_MEGA_SPLIT", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("spp,mb", [(4, 4), (2, 1)])
def test_render_matches_jax_megakernel(single_slot_jax, spp, mb):
    seed = 1
    jpack = jax_demo_scene().compile()
    cam = dataclasses.replace(jax_demo_scene().camera, width=W, height=H)
    want, wstats = J.render_mega(jpack, cam, spp, seed=seed, max_bounces=mb, interpret=True)
    want = np.asarray(want)
    # per-lane ray counts: the same (cached) kernel call render_mega made
    lanes = W * H * 3
    _, jrays, _ = J.trace_mega_block(
        jpack, cam, seed, 0, spp, -(-lanes // J.CHUNK) * J.CHUNK, mb, True, True,
        False, tile=None,
    )
    jrays = np.asarray(jrays)[:lanes]

    pack = demo_scene().compile()
    got, stats = render_mega(pack, cam, spp, seed=seed, max_bounces=mb, device="cpu")
    tables = SceneTables.from_pack(pack)
    _, trays = K.trace_block(tables, cam_static(cam), seed, 0, spp, lanes, mb)

    assert got.shape == want.shape == (H, W, 3) and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert abs(stats["rays"] - wstats["rays"]) <= 0.005 * wstats["rays"]
    assert stats["rays"] == wstats["rays"] == int(jrays.sum())
    assert (trays.numpy() == jrays).mean() >= 0.98
    assert (trays.numpy() == jrays).all()
    diff = np.abs(got - want)
    assert (diff > 1e-3).mean() < 0.02, float((diff > 1e-3).mean())
    assert abs(got.mean() - want.mean()) < 5e-3
    for k in ("camera_samples", "wavelength_paths"):
        assert stats[k] == wstats[k], k
    assert got[:, 4:12].mean() > 0.05  # the box is lit


def test_trace_block_plain_path_on_cpu():
    """CPU tensors take the plain version and launch nothing; lane blocks
    at an offset equal the same lanes of one whole-image call."""
    cam = dataclasses.replace(demo_scene().camera, width=8, height=4)
    tables = SceneTables.from_pack(demo_scene().compile())
    cs = cam_static(cam)
    before = K.trace_block.launches
    r, ry = K.trace_block(tables, cs, 5, 0, 2, 96, 3)
    r2, ry2 = trace_block_ref(tables, cs, 5, 40, 2, 56, 3)
    assert K.trace_block.launches == before
    assert torch.equal(r[40:], r2) and torch.equal(ry[40:], ry2)
    with pytest.raises(ValueError):
        K.trace_block(tables, cs, 5, 0, 2, 96, 33)


def test_cuda_device_without_gpu_raises():
    """No fallback: a CUDA device without a usable card raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cam = dataclasses.replace(demo_scene().camera, width=4, height=4)
    with pytest.raises(RuntimeError, match="cuda"):
        render_mega(demo_scene().compile(), cam, 1, device="cuda")


def _run_cli(argv):
    """`python -m mcpt_tpu_torch <argv>` in a fresh interpreter (run as `-m`
    does, through runpy), which then reports every jax/flax/optax/mcpt_tpu
    module the port's imports loaded. Returns its standard output."""
    argv = ["mcpt_tpu_torch", *argv]
    code = (
        "import runpy, sys\n"
        "import mcpt_tpu_torch, mcpt_tpu_torch.bench, mcpt_tpu_torch.convert\n"
        f"sys.argv = {argv!r}\n"
        "try:\n"
        "    runpy.run_module('mcpt_tpu_torch', run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'mcpt_tpu'))\n"
        "print('FOREIGN_MODULES', bad)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """`python -m mcpt_tpu_torch --demo --device cpu ...`"""
    out = tmp_path_factory.mktemp("cli") / "demo.png"
    return _run_cli(["--demo", "--device", "cpu", "--width", "8", "--height", "8",
                     "--spp", "1", "--max-bounces", "2", "--out", str(out)]), out


@pytest.fixture(scope="module")
def conf_cli_run(tmp_path_factory):
    """`python -m mcpt_tpu_torch --conf conf.json --device cpu ...` on stand-in
    chess meshes of 112 triangles each (1,796 triangles with floor and light,
    so the BVH walk runs) and conf.json's assets/sky.png."""
    models = tmp_path_factory.mktemp("models")
    write_stand_in_models(models, segs_steps=(8, 8))
    out = tmp_path_factory.mktemp("cli") / "conf.png"
    return _run_cli(["--conf", "conf.json", "--models-dir", str(models), "--device", "cpu",
                     "--width", "8", "--height", "8", "--spp", "1", "--max-bounces", "2",
                     "--out", str(out)]), out


def test_import_loads_no_jax(cli_run):
    stdout, _ = cli_run
    assert "FOREIGN_MODULES []" in stdout, stdout


def test_cli_demo_writes_png(cli_run):
    stdout, out = cli_run
    img = read_png(out)
    assert img.shape == (8, 8, 4) and img.dtype == np.uint8
    assert "rays/s" in stdout


def test_conf_cli_loads_no_jax(conf_cli_run):
    stdout, _ = conf_cli_run
    assert "FOREIGN_MODULES []" in stdout, stdout


def test_cli_conf_writes_png(conf_cli_run):
    stdout, out = conf_cli_run
    img = read_png(out)
    assert img.shape == (8, 8, 4) and img.dtype == np.uint8
    assert "SPP: 1" in stdout and "rays/s" in stdout
    assert img[:, :, :3].mean() > 0  # the sky map lights the view
