"""The port's wavefront engine against the JAX package's, on the CPU:
`integrator.trace_paths` and `render.render_radiance` with the same keys
(the port draws `jax.random`'s numbers through `prng`).

Bounds (the repo's megakernel bound, tests/test_megakernel.py:187-204):
total rays within 0.5% (a difference is printed); radiance off by more than
1e-3 on under 2% of lanes; means within 5e-3. What is left is ULP-level:
XLA's CPU backend contracts products into FMAs inside the jitted function,
its rsqrt is about 1 ULP off and its sin/cos round differently from
torch's, which now and then flips a shadow ray's visibility, a nearest-hit
winner or a reflect/refract draw against kr. Measured with these cases:
total rays equal; 0.0% and 0.5% of lanes off by more than 1e-3 in the two
trace_paths cases, 1.6% and 1.1% in the two renders (each pixel averages
four samples, so one flipped sample shows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcpt_tpu.builtin_scenes as JB
from mcpt_tpu.camera import generate_rays as jax_generate_rays
from mcpt_tpu.integrator import trace_paths as jax_trace_paths
from mcpt_tpu.render import render_radiance as jax_render_radiance

import mcpt_tpu_torch.builtin_scenes as TB
from mcpt_tpu_torch import prng
from mcpt_tpu_torch.constants import WAVELEN_UM
from mcpt_tpu_torch.integrator import trace_paths
from mcpt_tpu_torch.kernels import intersect_prims
from mcpt_tpu_torch.render import render_radiance
from mcpt_tpu_torch.scene import pack_to


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU thread pool costs far more than it saves at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agree(r, r2, rays, rays2):
    if rays != rays2:
        print(f"total rays differ: {rays} vs JAX {rays2}")
    assert abs(rays - rays2) <= 0.005 * rays2, (rays, rays2)
    assert np.isfinite(r).all()
    d = np.abs(r - r2)
    off, dmean = (d > 1e-3).mean(), abs(float(r.mean()) - float(r2.mean()))
    print(f"lanes off by more than 1e-3: {off:.4f}; mean diff {dmean:.3e}; rays {rays}")
    assert off < 0.02, off
    assert dmean < 5e-3


def _primary(w, h, seed):
    """The DEMO's primary rays of a w×h view, three channel lanes per pixel,
    from JAX's generate_rays (as numpy): rows o, d, lam, chan."""
    cam = dataclasses.replace(JB.demo_scene().camera, width=w, height=h)
    o, d = jax_generate_rays(cam, jnp.arange(w * h, dtype=jnp.int32), jax.random.key(seed))
    rep = lambda x: np.repeat(np.asarray(x), 3, axis=0)
    chan = np.tile(np.arange(3, dtype=np.int32), w * h)
    return rep(o), rep(d), WAVELEN_UM[chan], chan


@pytest.mark.parametrize("w,h,mb,jax_method,method", [
    (16, 8, 4, "dense", "dense"),
    (8, 8, 2, "pallas", "kernel"),  # the kernel's plain version vs K2 (interpret)
])
def test_trace_paths_matches_jax(w, h, mb, jax_method, method):
    o, d, lam, chan = _primary(w, h, 2)
    jr, js = jax_trace_paths(JB.demo_scene().compile(), jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(lam), jnp.asarray(chan), jax.random.key(5),
                             max_bounces=mb, method=jax_method)
    pack = pack_to(TB.demo_scene().compile(), "cpu")
    before = intersect_prims.intersect_prims_c.launches
    tr, ts = trace_paths(pack, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lam),
                         torch.from_numpy(chan), prng.key(5), max_bounces=mb, method=method)
    assert intersect_prims.intersect_prims_c.launches == before  # no kernel on the CPU
    _agree(tr.numpy(), np.asarray(jr), int(ts.rays), int(js.rays))


def test_early_exit_changes_nothing():
    """Stopping the bounce loop once no lane is alive gives the same
    radiance and ray count as running every bounce."""
    o, d, lam, chan = (torch.from_numpy(x) for x in _primary(8, 8, 3))
    pack = pack_to(TB.demo_scene().compile(), "cpu")
    runs = [trace_paths(pack, o, d, lam, chan, prng.key(4), max_bounces=6, method="dense",
                        early_exit=e) for e in (True, False)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert int(runs[0][1].rays) == int(runs[1][1].rays)


@pytest.mark.parametrize("w,h,dof", [(16, 16, False), (23, 15, True)])
def test_render_radiance_matches_jax(w, h, dof):
    kw = dict(max_bounces=3, method="dense", tile_pixels=128, spp_chunk=2)
    cam_j = dataclasses.replace(JB.demo_scene().camera, width=w, height=h, use_dof=dof,
                                focal_distance=800.0, aperture_radius=8.0)
    cam_t = dataclasses.replace(TB.demo_scene().camera, width=w, height=h, use_dof=dof,
                                focal_distance=800.0, aperture_radius=8.0)
    fj, sj = jax_render_radiance(JB.demo_scene(), cam_j, 4, jax.random.key(1), **kw)
    ft, st = render_radiance(TB.demo_scene(), cam_t, 4, prng.key(1), device="cpu", **kw)
    assert ft.shape == (h, w, 3) and ft.dtype == np.float32
    assert set(st) == set(sj)
    _agree(ft, np.asarray(fj), st["rays"], sj["rays"])
