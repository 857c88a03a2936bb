"""The occlusion sweep's fan form (`intersect_prims_c(..., occlusion=True,
fan=S)`: B origins, S·B directions, ray k·B + i from origin i) on the CPU,
where its plain version expands the origins and sweeps.

Held bitwise (float32 as int32 bits, so +0 and -0 differ) to the generic
occlusion query on the origins expanded by hand, and fan by fan, on the
DEMO (one shared-memory tile on the card) and on a soup of more than 1024
rows (tiled); against JAX's K2 (`intersect_prims_pallas_c`, interpret mode)
on the same expanded rays within tests/test_torch_wavefront.py's bounds for
K2; and the wavefront's NEE (`direct_lighting_c`, through `trace_paths_c`)
returns the same bits with the fan form as with the expanded call.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcpt_tpu.builtin_scenes as JB
from mcpt_tpu.kernels.intersect_pallas import intersect_prims_pallas_c

import mcpt_tpu_torch.integrator as integrator
import mcpt_tpu_torch.builtin_scenes as TB
from mcpt_tpu_torch import prng
from mcpt_tpu_torch.intersect import occlude_t_c
from mcpt_tpu_torch.kernels.intersect_prims import intersect_prims_c
from mcpt_tpu_torch.kernels.wavefront import camera_rays
from mcpt_tpu_torch.materials import Material
from mcpt_tpu_torch.scene import Scene, Sphere, TriangleMesh, pack_to

AGREE = 0.999  # tests/test_torch_wavefront.py's share of agreeing rays


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU thread pool costs far more than it saves at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soup(n=1100):
    """n random triangles in [-1, 1]^3 (more than 1024 rows) and two spheres."""
    rng = np.random.default_rng(11)
    v0 = rng.uniform(-1.0, 1.0, (n, 3))
    pos = np.stack([v0, v0 + rng.uniform(-0.2, 0.2, (n, 3)),
                    v0 + rng.uniform(-0.2, 0.2, (n, 3))], 1).astype(np.float32)
    sc = Scene(TB.demo_scene().camera)
    sc.add(TriangleMesh(pos, np.zeros((n, 3, 2), np.float32), Material(), "soup"))
    sc.add(Sphere((0.3, 0.2, -0.4), 0.35, Material(), "a"))
    sc.add(Sphere((-0.5, -0.3, 0.5), 0.25, Material(), "b"))
    return sc.compile()


# scene: (pack, origin box, box the directions aim into)
SCENES = {
    "demo": (TB.demo_scene, ((1.0, 1.0, 1.0), (555.0, 547.0, 558.0)),
             ((0.0, 0.0, 0.0), (555.0, 548.0, 559.0))),
    "soup": (_soup, ((-3.0,) * 3, (3.0,) * 3), ((-1.0,) * 3, (1.0,) * 3)),
}


def _fan(scene, b, s, seed):
    """(pack, origins (b,) x3, directions (s·b,) x3 as numpy): fan k of
    origin i aims at a uniform point of the scene's aim box."""
    make, (lo, hi), aim = SCENES[scene]
    pack = make().compile() if scene == "demo" else make()
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (b, 3)).astype(np.float32)
    d = rng.uniform(*aim, (s * b, 3)) - np.tile(o, (s, 1))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return pack, o, d


def _cols(x):
    return tuple(torch.from_numpy(np.ascontiguousarray(x[:, k])) for k in range(3))


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("scene", ["demo", "soup"])
@pytest.mark.parametrize("s", [1, 4, 33])
def test_fan_plain_version_bitwise_to_the_expanded_sweep(scene, s):
    """The fan form's answers equal the generic occlusion query's on the
    origins expanded (numpy's tile), as one batch and fan by fan."""
    b = 24
    pack, o, d = _fan(scene, b, s, seed=s)
    tri, sph = torch.from_numpy(pack.tri_sc), torch.from_numpy(pack.sph_geom)
    assert (tri.shape[0] > 1024) == (scene == "soup")
    got = intersect_prims_c(tri, sph, pack.t_pad, _cols(o), _cols(d), occlusion=True, fan=s)
    assert got[1:] == (None, None, None) and got[0].shape == (s * b,)
    want = intersect_prims_c(tri, sph, pack.t_pad, _cols(np.tile(o, (s, 1))), _cols(d),
                             occlusion=True)[0]
    assert torch.equal(_bits(got[0]), _bits(want))
    assert (want < 1e30).float().mean().item() > 0.3
    for k in range(s):
        one = intersect_prims_c(tri, sph, pack.t_pad, _cols(o), _cols(d[k * b:(k + 1) * b]),
                                occlusion=True)[0]
        assert torch.equal(_bits(got[0][k * b:(k + 1) * b]), _bits(one))


@pytest.mark.parametrize("s", [1, 4, 33])
def test_fan_agrees_with_pallas_k2(s):
    """On the DEMO, the fan form against JAX's K2 in occlusion mode on the
    same rays, the origins expanded (`_kernel_sc`, interpret mode): about
    2,000 rays, so that the 0.1% of ULP-level winner flips that the bounds
    allow is at least one ray."""
    b = 2048 // s
    pack, o, d = _fan("demo", b, s, seed=40 + s)
    jp = JB.demo_scene().compile()
    ox = np.tile(o, (s, 1))
    want = np.asarray(intersect_prims_pallas_c(
        jp.tri_sc, jp.sph_geom, jp.n_tris, tuple(jnp.asarray(ox[:, k]) for k in range(3)),
        tuple(jnp.asarray(d[:, k]) for k in range(3)), interpret=True, occlusion=True)[0])
    t = intersect_prims_c(torch.from_numpy(pack.tri_sc), torch.from_numpy(pack.sph_geom),
                          pack.n_tris, _cols(o), _cols(d), occlusion=True, fan=s)[0].numpy()
    ok = (t < 1e30) == (want < 1e30)
    assert ok.mean() >= AGREE
    scale = np.maximum(np.maximum(want, np.abs(ox).max(axis=1)), 1.0)
    assert np.mean(np.abs(t - want) <= 1e-5 * scale) >= AGREE


@pytest.mark.parametrize("method", ["kernel", "dense"])
def test_direct_lighting_fan_bitwise_to_the_expanded_call(monkeypatch, method):
    """The wavefront's paths (NEE through `direct_lighting_c`) on the CPU:
    the same radiance and ray count, bit for bit, whether the shadow rays go
    to `occlude_t_c` as a fan or with their origins expanded."""
    sc = TB.demo_scene()
    cam = dataclasses.replace(sc.camera, width=8, height=6)
    pack = pack_to(sc.compile(), "cpu")
    o, d = camera_rays(cam, torch.arange(48), prng.key(3))
    o, d = tuple(x.repeat_interleave(3) for x in o), tuple(x.repeat_interleave(3) for x in d)
    chan = torch.arange(3).repeat(48)
    lam = torch.tensor([0.65, 0.55, 0.45])[chan]
    fans = []

    def run():
        return integrator.trace_paths_c(pack, o, d, lam, chan, prng.key(7), max_bounces=4,
                                        method=method)

    def expanded(pack, oc, dc, method="auto", fan=None):
        fans.append(fan)
        oc = tuple(x.repeat(fan) for x in oc) if fan else oc
        return occlude_t_c(pack, oc, dc, method=method)

    r_fan, st_fan = run()
    monkeypatch.setattr(integrator, "occlude_t_c", expanded)
    r_exp, st_exp = run()
    assert fans and all(f == pack.n_dir_sample for f in fans)
    assert torch.equal(_bits(r_fan), _bits(r_exp))
    assert int(st_fan.rays) == int(st_exp.rays)
    assert float(r_fan.abs().sum()) > 0.0


def test_fan_refuses_what_it_does_not_take():
    """fan= is a form of the occlusion query, with fan·B directions."""
    pack, o, d = _fan("demo", 8, 4, seed=1)
    tri, sph = torch.from_numpy(pack.tri_sc), torch.from_numpy(pack.sph_geom)
    with pytest.raises(ValueError, match="occlusion"):
        intersect_prims_c(tri, sph, pack.t_pad, _cols(o), _cols(d), fan=4)
    with pytest.raises(ValueError, match="fan=3"):
        intersect_prims_c(tri, sph, pack.t_pad, _cols(o), _cols(d), occlusion=True, fan=3)
    with pytest.raises(ValueError, match="fan=0"):
        intersect_prims_c(tri, sph, pack.t_pad, _cols(o), _cols(d), occlusion=True, fan=0)
