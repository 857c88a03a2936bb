"""The port's wavefront engine on the CPU, around the render itself: an
interrupted render resumed from its checkpoint, and the CLI's `--engine
wavefront --checkpoint` path (no jax module loaded) and its refusal of
`--engine mega --checkpoint`."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mcpt_tpu_torch.builtin_scenes as TB
from mcpt_tpu_torch.io.png import read_png
from mcpt_tpu_torch.render import render_radiance

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU thread pool costs far more than it saves at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_from_real_checkpoint(tmp_path, monkeypatch):
    """An interrupted render resumed from a checkpoint written at chunk 16
    equals the uninterrupted one, and the file is removed on completion
    (tests/test_render_resume.py for the port)."""
    import mcpt_tpu_torch.render as R

    sc = TB.demo_scene()
    pack = sc.compile()
    cam = dataclasses.replace(sc.camera, width=8, height=8)
    kw = dict(spp=20, max_bounces=2, method="dense", spp_chunk=1, tile_pixels=64, device="cpu")
    fb_ref, st_ref = render_radiance(pack, cam, **kw)

    ckpt = str(tmp_path / "state.npz")
    calls = {"n": 0}
    orig = R._render_tile

    def bomb(*a, **k):
        calls["n"] += 1
        if calls["n"] > 17:  # past the 16-chunk checkpoint write
            raise KeyboardInterrupt
        return orig(*a, **k)

    monkeypatch.setattr(R, "_render_tile", bomb)
    with pytest.raises(KeyboardInterrupt):
        render_radiance(pack, cam, checkpoint_path=ckpt, **kw)
    monkeypatch.setattr(R, "_render_tile", orig)
    assert os.path.exists(ckpt)
    assert int(np.load(ckpt)["start_chunk"][0]) == 16
    fb, st = render_radiance(pack, cam, checkpoint_path=ckpt, **kw)
    np.testing.assert_allclose(fb, fb_ref, atol=1e-6)
    assert st["rays"] == st_ref["rays"]
    assert not os.path.exists(ckpt)


def _run_cli(argv):
    """`python -m mcpt_tpu_torch <argv>` in a fresh interpreter; returns
    (exit code, stdout + stderr, the jax/mcpt_tpu modules it loaded)."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = {['mcpt_tpu_torch', *argv]!r}\n"
        "rc = 0\n"
        "try:\n"
        "    runpy.run_module('mcpt_tpu_torch', run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    rc = e.code or 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'mcpt_tpu'))\n"
        "print('FOREIGN_MODULES', bad)\n"
        "sys.exit(rc)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
    )
    return res.returncode, res.stdout + res.stderr


def test_cli_wavefront_checkpoint_writes_png(tmp_path):
    out = tmp_path / "wf.png"
    ckpt = tmp_path / "state.npz"
    rc, log = _run_cli(["--demo", "--engine", "wavefront", "--checkpoint", str(ckpt),
                        "--device", "cpu", "--width", "8", "--height", "8", "--spp", "2",
                        "--max-bounces", "2", "--out", str(out)])
    assert rc == 0, log
    assert "FOREIGN_MODULES []" in log and "engine=wavefront" in log
    img = read_png(out)
    assert img.shape == (8, 8, 4) and img[:, :, :3].mean() > 0
    assert not ckpt.exists()


def test_cli_mega_checkpoint_is_an_error(tmp_path):
    rc, log = _run_cli(["--demo", "--engine", "mega", "--checkpoint", str(tmp_path / "s.npz"),
                        "--device", "cpu", "--width", "4", "--height", "4", "--spp", "1"])
    assert rc == 2 and "does not support --checkpoint" in log
