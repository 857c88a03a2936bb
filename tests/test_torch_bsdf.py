"""The wavefront's BSDF wrappers (`mcpt_tpu_torch/bsdf.py`) against
`mcpt_tpu/bsdf.py` on random inputs, on the CPU.

Lanes of each of the four material types of the DEMO's material table, each
at a random wavelength channel; random unit normals and incident
directions, uniforms from numpy, identical on both sides. Half the lanes
are forced textured, so `reflectance_c` takes the chessboard on them. The
functions after the microfacet sample (`fresnel_c`, `refract_c`, `pdf_c`,
`eval_bsdf_c`) take JAX's sample on both sides, as tests/test_torch_shading.py
does; `pdf_c` and `eval_bsdf_c` run on both branches (reflect and refract)
with wi the branch's own direction, and with random wi.

Tolerance: float outputs within rtol 1e-5, atol 1e-6, the tolerance of
tests/test_torch_shading.py, for its reason: the sample's `sin` and `cos`
differ by ULPs between XLA's CPU code and torch. Total internal reflection
is held exactly: the dielectric lanes where the JAX refraction returns the
zero vector are the port's, and both Fresnel terms are 1 there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcpt_tpu.bsdf as JB
from mcpt_tpu.builtin_scenes import demo_scene as jax_demo_scene
from mcpt_tpu.constants import WAVELEN_UM
from mcpt_tpu.materials import MaterialType

import mcpt_tpu_torch.bsdf as TB
from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.scene import pack_to

TYPES = list(MaterialType)
LANES = 2048  # per material type
RTOL, ATOL = 1e-5, 1e-6


def _unit(rng, n):
    v = rng.normal(size=(3, n))
    return tuple((v / np.linalg.norm(v, axis=0, keepdims=True)).astype(np.float32))


def _jx(x):
    return tuple(jnp.asarray(c) for c in x) if isinstance(x, tuple) else jnp.asarray(x)


def _th(x):
    return tuple(torch.tensor(c) for c in x) if isinstance(x, tuple) else torch.tensor(x)


def _np(x):
    if isinstance(x, (tuple, list)):
        return np.stack([_np(c) for c in x])
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _reflect(wo, h):  # 2 (wo·h) h - wo, as the kernels bounce
    s = 2.0 * (wo[0] * h[0] + wo[1] * h[1] + wo[2] * h[2])
    return tuple((h[k] * s - wo[k]).astype(np.float32) for k in range(3))


@pytest.fixture(scope="module")
def results():
    jpack = jax_demo_scene().compile()
    tpack = pack_to(demo_scene().compile(), "cpu")
    table = np.asarray(jpack.mat_fat)
    rng = np.random.default_rng(7)
    mat_id = np.concatenate([
        rng.choice(np.nonzero(table[:, 0] == float(t))[0], LANES) for t in TYPES
    ]).astype(np.int32)
    n_all = mat_id.size
    chan = rng.integers(0, 3, n_all).astype(np.int32)
    lam = np.asarray(WAVELEN_UM, np.float32)[chan]
    textured = rng.random(n_all) < 0.5
    n, d, wr = _unit(rng, n_all), _unit(rng, n_all), _unit(rng, n_all)
    wo = tuple(-c for c in d)
    xi1, xi2 = (rng.random(n_all).astype(np.float32) for _ in range(2))
    uv = tuple(rng.random((2, n_all)).astype(np.float32))

    jm = JB.gather_material(jpack, jnp.asarray(mat_id))
    jm = jm._replace(textured=jnp.asarray(textured))
    tm = TB.gather_material(tpack, torch.from_numpy(mat_id), torch.from_numpy(chan))
    tm["textured"] = torch.from_numpy(textured.astype(np.float32))
    jl, tl, jc = jnp.asarray(lam), torch.from_numpy(lam), jnp.asarray(chan)

    out = {"mtype": (jm.mtype, tm["mtype"])}
    out["reflectance_c"] = (JB.reflectance_c(jm, _jx(uv), jc), TB.reflectance_c(tm, _th(uv)))
    jmfn = JB.sample_mfn_c(jm, _jx(n), jnp.asarray(xi1), jnp.asarray(xi2))
    out["sample_mfn_c"] = (jmfn, TB.sample_mfn_c(tm, _th(n), _th(xi1), _th(xi2)))
    mfn = tuple(np.asarray(c) for c in jmfn)
    out["fresnel_c"] = (JB.fresnel_c(jm, _jx(d), _jx(mfn), jl),
                        TB.fresnel_c(tm, _th(d), _th(mfn), tl))
    jrefr = JB.refract_c(jm, _jx(d), _jx(mfn), jl)
    out["refract_c"] = (jrefr, TB.refract_c(tm, _th(d), _th(mfn), tl))
    refr = tuple(np.asarray(c) for c in jrefr)
    wis = {"reflect": _reflect(wo, mfn), "refract": refr, "random": wr}
    for branch, wi in wis.items():
        for is_reflect in (True, False):
            if branch != "random" and is_reflect != (branch == "reflect"):
                continue
            flag = np.full(n_all, is_reflect)
            key = f"wi {branch}, is_reflect={is_reflect}"
            out[f"pdf_c {key}"] = (
                JB.pdf_c(jm, _jx(wi), _jx(wo), _jx(n), jl, jnp.asarray(flag)),
                TB.pdf_c(tm, _th(wi), _th(wo), _th(n), tl, torch.from_numpy(flag)))
            out[f"eval_bsdf_c {key}"] = (
                JB.eval_bsdf_c(jm, _jx(wi), _jx(wo), _jx(n), jl, _jx(uv), jc, jnp.asarray(flag)),
                TB.eval_bsdf_c(tm, _th(wi), _th(wo), _th(n), tl, _th(uv), torch.from_numpy(flag)))
    return {k: (_np(a), _np(b)) for k, (a, b) in out.items()}, textured


@pytest.mark.parametrize("mtype", TYPES, ids=lambda m: m.name.lower())
def test_bsdf_wrappers_match_jax(results, mtype):
    res, textured = results
    i = TYPES.index(mtype)
    rows = slice(i * LANES, (i + 1) * LANES)
    assert (res["mtype"][0][rows] == int(mtype)).all()
    assert (res["mtype"][1][rows] == float(mtype)).all()
    assert 0.3 < textured[rows].mean() < 0.7
    for name, (want, got) in res.items():
        if name == "mtype":
            continue
        np.testing.assert_allclose(got[..., rows], want[..., rows], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    # both branches give the values the paths read: nonzero on some lanes
    for branch in ("reflect", "refract"):
        if branch == "refract" and mtype in (MaterialType.SMOOTH_CONDUCTOR,
                                             MaterialType.ROUGH_CONDUCTOR):
            continue
        ev = res[f"eval_bsdf_c wi {branch}, is_reflect={branch == 'reflect'}"][1][rows]
        assert (ev != 0.0).mean() > 0.05, branch


@pytest.mark.parametrize("mtype", [MaterialType.SMOOTH_DIELECTRIC, MaterialType.ROUGH_DIELECTRIC],
                         ids=lambda m: m.name.lower())
def test_total_internal_reflection_matches_jax(results, mtype):
    res, _ = results
    i = TYPES.index(mtype)
    rows = slice(i * LANES, (i + 1) * LANES)
    want, got = res["refract_c"]
    tir = (want[:, rows] == 0.0).all(axis=0)
    assert 0.02 < tir.mean() < 0.5
    np.testing.assert_array_equal((got[:, rows] == 0.0).all(axis=0), tir)
    for k in (0, 1):  # JAX's, the port's Fresnel
        assert (res["fresnel_c"][k][rows][tir] == 1.0).all()
