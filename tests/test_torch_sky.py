"""`mcpt_tpu_torch.sky` (a numpy copy of `mcpt_tpu/sky.py`) against the JAX
package's generator: the same image bit for bit, the same PNG, and the
repo's assets/sky.png from the default arguments."""

from pathlib import Path

import numpy as np
import pytest

from mcpt_tpu.sky import generate_sky as jax_generate_sky
from mcpt_tpu.sky import write_sky_png as jax_write_sky_png

from mcpt_tpu_torch.io.png import read_png
from mcpt_tpu_torch.sky import generate_sky, write_sky_png


@pytest.mark.parametrize("clouds", [0.55, 0.0])
def test_generate_sky_bitwise_equal_jax(clouds):
    got = generate_sky(64, 32, clouds=clouds)
    want = jax_generate_sky(64, 32, clouds=clouds)
    assert got.shape == (32, 64, 3) and got.dtype == np.float32
    assert np.array_equal(got, want)


def test_write_sky_png_equal_jax(tmp_path):
    write_sky_png(tmp_path / "a.png", 64)
    jax_write_sky_png(tmp_path / "b.png", 64)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    assert read_png(tmp_path / "a.png").shape == (32, 64, 3)


def test_default_sky_is_the_committed_asset(tmp_path):
    """`python -m mcpt_tpu_torch.sky assets/sky.png` regenerates the
    repo's map (the default width, 1024, with clouds) byte for byte."""
    write_sky_png(tmp_path / "sky.png")
    asset = Path(__file__).resolve().parent.parent / "assets" / "sky.png"
    assert (tmp_path / "sky.png").read_bytes() == asset.read_bytes()
