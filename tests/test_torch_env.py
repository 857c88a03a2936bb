"""The port's env maps against the JAX package, on the CPU.

The port looks the env map up per lane at full resolution with bilinear
filtering, inside the kernel, as the JAX wavefront path and the reference do
(`mcpt_tpu/envmap.py`, Scene.hpp:60-99). The JAX megakernel instead reads a
16x32 nearest-texel mip for bounce rays and shades primary misses with the
pixel's all-sample env mean (its TPU workarounds, megakernel.py:93-101,
`_primary_env_mean`). So the port is held to the JAX megakernel exactly
where the two coincide (a pure sky, a constant map) and to the wavefront
path, statistically, everywhere else. JAX megakernel renders run with
MCPT_MEGA_UNROLL=1 MCPT_MEGA_SPLIT=1 (tests/test_torch_render.py), traced once
for the module.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpt_tpu.builtin_scenes import demo_scene as jax_demo_scene
from mcpt_tpu.camera import Camera as JaxCamera
from mcpt_tpu.envmap import sample_env as jax_sample_env
from mcpt_tpu.envmap import sample_env_chan_c
from mcpt_tpu.kernels.megakernel import render_mega as jax_render_mega
from mcpt_tpu.render import render_radiance
from mcpt_tpu.scene import Scene as JaxScene

from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.camera import Camera
from mcpt_tpu_torch.envmap import sample_env, sample_env_chan
from mcpt_tpu_torch.render import render_mega
from mcpt_tpu_torch.scene import Scene

W, H = 16, 8
SKY_CAM = dict(width=W, height=H, fov=60, position=(0.0, 0.0, 0.0),
               target=(0.0, 0.0, 5.0), up=(0, 1, 0))


def gradient_env(h=64, w=128):
    """tests/test_mega_env.py's smooth map, distinct per channel."""
    v = np.linspace(0.0, 1.0, h)[:, None]
    u = np.linspace(0.0, 1.0, w, endpoint=False)[None, :]
    img = np.stack(
        [
            0.2 + 0.6 * v * np.ones_like(u),
            0.3 + 0.4 * (0.5 + 0.5 * np.sin(2 * np.pi * u)) * np.ones_like(v),
            0.8 - 0.5 * v * np.ones_like(u),
        ],
        axis=-1,
    )
    return img.astype(np.float32)


CONST_ENV = np.broadcast_to(np.float32([0.3, 0.5, 0.7]), (64, 128, 3)).copy()


@pytest.fixture(scope="module")
def jax_renders():
    """The JAX megakernel's renders this module compares with: one trace for
    the sky scene, one shared by the two DEMO maps (same table shapes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCPT_MEGA_UNROLL", "1")
        mp.setenv("MCPT_MEGA_SPLIT", "1")
        jax.clear_caches()
        out = {}
        sky = JaxScene(JaxCamera(**SKY_CAM))
        sky.env_pixels = gradient_env()
        out["sky"] = jax_render_mega(sky.compile(), sky.camera, 8, seed=0, max_bounces=3,
                                     interpret=True)
        for name, env in (("const", CONST_ENV), ("gradient", gradient_env())):
            sc = jax_demo_scene()
            sc.env_pixels = env
            cam = dataclasses.replace(sc.camera, width=W, height=H)
            out[name] = jax_render_mega(sc.compile(), cam, 4, seed=1, max_bounces=4,
                                        interpret=True)
        jax.clear_caches()
    return {k: (np.asarray(img), stats) for k, (img, stats) in out.items()}


def _port_demo(env, spp, seed):
    sc = demo_scene()
    sc.env_pixels = env
    cam = dataclasses.replace(sc.camera, width=W, height=H)
    return render_mega(sc.compile(), cam, spp, seed=seed, max_bounces=4, device="cpu")


def test_sample_env_chan_matches_jax():
    """4096 random directions (of random length) on the 64x128 gradient map,
    within 1e-5 abs: bilinear filtering is continuous, so an ULP of
    difference between torch's and XLA's atan2/acos moves the value by ULPs
    even across a texel edge. The RGB form and the background fallback too."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(4096, 3)).astype(np.float32) * rng.uniform(0.1, 3.0, (4096, 1)).astype(np.float32)
    chan = rng.integers(0, 3, 4096)
    env = gradient_env()
    bg = np.float32([0.1, 0.2, 0.3])
    pack = types.SimpleNamespace(use_env=True, env_pixels=jnp.asarray(env),
                                 background=jnp.asarray(bg))
    want = np.asarray(sample_env_chan_c(pack, tuple(jnp.asarray(d[:, k]) for k in range(3)),
                                        jnp.asarray(chan)))
    td = tuple(torch.tensor(d[:, k]) for k in range(3))
    got = sample_env_chan(torch.tensor(env), bg.tolist(), True, td, torch.tensor(chan))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    rgb = sample_env(torch.tensor(env), bg.tolist(), True, torch.tensor(d))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jax_sample_env(pack, jnp.asarray(d))),
                               rtol=0, atol=1e-5)
    plain = sample_env_chan(torch.tensor(env), bg.tolist(), False, td, torch.tensor(chan))
    assert np.array_equal(plain.numpy(), bg[chan])


def test_pure_sky_matches_jax_megakernel(jax_renders):
    """No geometry: every sample is a primary miss, where the JAX deferred
    full-resolution pass and the port's in-kernel lookup compute the same
    mean. Per pixel within 1e-4 (ULPs of atan2/acos and the camera rsqrt);
    rays exactly equal (primaries only)."""
    want, wstats = jax_renders["sky"]
    sc = Scene(Camera(**SKY_CAM))
    sc.env_pixels = gradient_env()
    got, stats = render_mega(sc.compile(), sc.camera, 8, seed=0, max_bounces=3, device="cpu")
    assert stats["rays"] == wstats["rays"] == W * H * 3 * 8
    assert np.abs(got - want).max() < 1e-4


def test_constant_env_demo_matches_jax_megakernel(jax_renders):
    """Under a constant map the mip, the deferred mean and full-resolution
    bilinear coincide, so the DEMO box renders as the JAX megakernel does:
    ray counts exactly equal, the repo's 2% of pixels off by > 1e-3 and
    means within 5e-3 (ULP-level nearest-hit flips,
    tests/test_megakernel.py:202-204)."""
    want, wstats = jax_renders["const"]
    got, stats = _port_demo(CONST_ENV, 4, 1)
    assert stats["rays"] == wstats["rays"]
    diff = np.abs(got - want)
    assert (diff > 1e-3).mean() < 0.02, float((diff > 1e-3).mean())
    assert abs(got.mean() - want.mean()) < 5e-3
    assert got[:, 4:12].mean() > 0.05


def test_gradient_env_demo_matches_jax(jax_renders):
    """The DEMO box under the gradient map.

    Against the JAX megakernel (same draws, so the same paths and ray
    counts): only the env values differ, by its documented mip error, which
    is at most 0.5% of the whole-image mean on smooth maps
    (megakernel.py:96-101); the bound is that 0.5%.

    Against the JAX wavefront path, which has the port's semantics but its
    own random numbers: spp 32 each, whole-image mean within 2% and each
    quadrant's within 10% (Monte-Carlo noise; on the CPU these measure 0.31%
    and at most 1.4%)."""
    want, wstats = jax_renders["gradient"]
    got, stats = _port_demo(gradient_env(), 4, 1)
    assert stats["rays"] == wstats["rays"]
    assert abs(got.mean() - want.mean()) / want.mean() < 0.005

    jsc = jax_demo_scene()
    jsc.env_pixels = gradient_env()
    cam = dataclasses.replace(jsc.camera, width=W, height=H)
    ref, _ = render_radiance(jsc.compile(), cam, 32, method="dense", max_bounces=4,
                             tile_pixels=W * H)
    ref = np.asarray(ref)
    img, _ = _port_demo(gradient_env(), 32, 0)
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) / ref.mean() < 0.02
    for i in range(2):
        for j in range(2):
            a = img[i * 4:(i + 1) * 4, j * 8:(j + 1) * 8].mean()
            b = ref[i * 4:(i + 1) * 4, j * 8:(j + 1) * 8].mean()
            assert abs(a - b) / b < 0.1, (i, j, a, b)
