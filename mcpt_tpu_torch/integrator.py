"""Wavefront path-tracing integrator (counterpart of
`mcpt_tpu/integrator.py:91-390`).

Semantics are the reference's recursive `Scene::castRay` and
`Scene::directLighting` (Scene.cpp:56-184), as in the JAX package: a bounce
loop over a pool of lanes, each carrying (origin, direction, nearest hit,
alive), records per bounce (l_dir, weight, leaf, terminal) and a reverse
fold that reproduces the nested per-level firefly clamps exactly:

    L_d = terminal_d ? leaf_d : clamp15(l_dir_d) + clamp5(w_d · L_{d+1})

The random numbers are `jax.random`'s, reproduced by `prng`: per bounce
`kd = fold_in(key, depth)`, the vertex draws `uniform(fold_in(kd, 0), (B,
4))` and the light draws `uniform(fold_in(kd, 1), (S·B, 4))`, so a lane
draws what it draws in the JAX function. The NEE problem keeps the (S, B)
plane-major layout; its S·B shadow rays go to `occlude_t_c` as one batch,
in its fan form: the B points once, ray k·B + i from point i.

With `early_exit` the bounce loop is a Python loop that stops once no lane
is alive (one host sync per bounce); records are preallocated (D, B).
Autograd follows the whole pass (`diff.py`) as the detached-sampling
estimator of the JAX package: every hit's t, u and v are detached
(`_detach_hit`), so gradients flow through the shading terms (eval, pdf,
Fresnel, emission, the reparameterized GGX draw), not through the
intersector.
"""

from typing import NamedTuple

import torch

from mcpt_tpu_torch import prng
from mcpt_tpu_torch.bsdf import (
    eval_bsdf_c,
    fresnel_c,
    gather_material,
    pdf_c,
    refract_c,
    sample_mfn_c,
)
from mcpt_tpu_torch.constants import CLAMP_DIRECT, CLAMP_INDIRECT, EPSILON, REL_EPS
from mcpt_tpu_torch.envmap import sample_env_chan
from mcpt_tpu_torch.intersect import Hit, intersect_c, occlude_t_c, surface_at_c
from mcpt_tpu_torch.kernels.megakernel_ref import _dot, _neg, _reflect, _where3
from mcpt_tpu_torch.kernels.megakernel_ref import sqrt_f32 as _sqrt
from mcpt_tpu_torch.lights import sample_light_c


def _detach_hit(hit: Hit) -> Hit:
    """Hit distances and barycentrics held fixed by the sampled path
    (`mcpt_tpu/integrator.py:75-88`): the kernel's outputs carry no
    gradient, and the CPU's routes would carry one through t."""
    return Hit(t=hit.t.detach(), prim=hit.prim, u=hit.u.detach(), v=hit.v.detach())


def _env(pack, d, chan):
    bg = tuple(float(b) for b in pack.background)
    return sample_env_chan(pack.env_pixels, bg, pack.use_env, d, chan)


def direct_lighting_c(pack, key, wo, p, n, uv, m, lam, chan, is_reflect, method):
    """NEE estimator (Scene.cpp:56-82): the un-weighted sum over the lane's
    `n_dir_sample` light samples (the caller applies the kr / (1 - kr)
    Fresnel weight)."""
    b = p[0].shape[0]
    if pack.n_emitters == 0:
        return torch.zeros(b, dtype=torch.float32, device=p[0].device)
    s = pack.n_dir_sample
    u = prng.uniform(key, (s * b, 4))
    ls = sample_light_c(pack, u, chan.expand(s, b).reshape(-1))
    lp = tuple(x.reshape(s, b) for x in ls.p)
    ln = tuple(x.reshape(s, b) for x in ls.n)
    emit = ls.emit.reshape(s, b)
    lpdf = ls.pdf.reshape(s, b)

    delta = tuple(lp[k] - p[k] for k in range(3))  # (S, B) by broadcast
    dist = _sqrt(torch.clamp_min(_dot(delta, delta), 1e-20))
    inv_dist = 1.0 / dist
    ws = tuple(x * inv_dist for x in delta)
    if pack.enable_shadow:
        # a fan of s shadow rays from each of the b points, ray k·b + i from p[i]
        sh_t = occlude_t_c(pack, p, tuple(x.reshape(s * b) for x in ws), method=method,
                           fan=s).reshape(s, b)
        # no hit strictly closer than the light sample, by a relative margin
        visible = sh_t >= dist - torch.clamp_min(REL_EPS * dist, EPSILON)
    else:
        visible = torch.ones((s, b), dtype=torch.bool, device=dist.device)
    ev = eval_bsdf_c(m, ws, wo, n, lam, uv, is_reflect)
    # Scene.cpp:76-78: emit · eval · (ws·n) · (−ws·n_light) / dist² / pdf / S
    contrib = (
        emit * ev * _dot(ws, n) * -_dot(ws, ln) * (inv_dist * inv_dist)
        / lpdf / torch.full_like(lpdf, s)
    )
    contrib = torch.where(visible, contrib, 0.0)
    total = contrib[0]
    for k in range(1, s):
        total = total + contrib[k]
    return total


class PathStats(NamedTuple):
    rays: torch.Tensor  # () total rays traced (primary + shadow + bounce)


def _bounce(pack, o, d, hit, alive, depth, key, lam, chan, method):
    """One bounce of the pool: the records of `depth` and the next carry."""
    b = o[0].shape[0]
    kd = prng.fold_in(key, depth)
    surf = surface_at_c(pack, o, d, hit)
    happened = surf.happened
    wo = _neg(d)

    env_leaf = _env(pack, d, chan)  # miss: env/background (Scene.cpp:88-95)
    m = gather_material(pack, surf.mat, chan)
    # depth-0 emitter hit (Scene.cpp:102-107)
    b_leaf = torch.clamp(m["emit"] * torch.abs(_dot(wo, surf.n)), 0.0, 1.0)
    is_b = happened & surf.emissive if depth == 0 else torch.zeros_like(happened)
    at_vertex = alive & happened & ~is_b

    # microfacet normal + Fresnel split (Scene.cpp:109-110)
    xi = prng.uniform(prng.fold_in(kd, 0), (b, 4))
    mfn = sample_mfn_c(m, surf.n, xi[:, 0], xi[:, 1])
    kr = fresnel_c(m, d, mfn, lam)

    # NEE from the scale-relative ε-offset point (Scene.cpp:113-119)
    p = surf.p
    off_scale = torch.clamp_min(
        REL_EPS * torch.maximum(torch.abs(p[0]), torch.maximum(torch.abs(p[1]), torch.abs(p[2]))),
        EPSILON,
    )
    p_dl = tuple(p[k] + surf.n[k] * off_scale for k in range(3))
    inner = _dot(wo, surf.n) < 0.0
    l_dir_raw = direct_lighting_c(
        pack, prng.fold_in(kd, 1), wo, p_dl, surf.n, surf.uv, m, lam, chan, ~inner, method
    )
    l_dir = torch.where(inner, 1.0 - kr, kr) * l_dir_raw

    # Russian roulette + stochastic reflect/refract (Scene.cpp:121-159)
    rr_kill = xi[:, 2] >= float(pack.rr_rate)
    branch_reflect = xi[:, 3] < kr
    sign_reflect = torch.where(_dot(wo, mfn) < 0.0, -1.0, 1.0)
    sign = torch.where(branch_reflect, sign_reflect, -sign_reflect)
    p_new = tuple(p[k] + surf.n[k] * (off_scale * sign) for k in range(3))
    wi = _where3(branch_reflect, _reflect(wo, mfn), refract_c(m, d, mfn, lam))
    nxt = _detach_hit(intersect_c(pack, p_new, wi, method=method))
    nprim = nxt.prim.to(torch.int64)
    nxt_emissive = (nprim >= 0) & (pack.prim_emissive[nprim.clamp(min=0), 0] > 0.5)

    inv_rr = float(pack.inv_rr)
    ev = eval_bsdf_c(m, wi, wo, surf.n, lam, surf.uv, branch_reflect)
    pv = pdf_c(m, wi, wo, surf.n, lam, branch_reflect)
    # indirect weight (Scene.cpp:135-144,162-171), the reference's |wo·n|
    pv_ok = torch.abs(pv) > 1e-10
    w_rough = torch.where(
        pv_ok, ev * torch.abs(_dot(wo, surf.n)) / torch.where(pv_ok, pv, 1.0) * inv_rr, 0.0
    )
    w = torch.where(m["dirac"] > 0.5, ev * inv_rr, w_rough)

    cont = at_vertex & ~rr_kill & (nprim >= 0) & ~nxt_emissive
    env_ind = _env(pack, wi, chan) * ev * inv_rr
    leaf = torch.where(
        ~alive,
        0.0,
        torch.where(
            ~happened,
            env_leaf,
            torch.where(
                is_b,
                b_leaf,
                torch.where(
                    rr_kill,
                    l_dir,  # raw early return (Scene.cpp:129,156)
                    torch.clamp(l_dir, 0.0, CLAMP_DIRECT)
                    + torch.clamp(env_ind, 0.0, CLAMP_INDIRECT),
                ),
            ),
        ),
    )
    shadow_rays = pack.n_dir_sample if pack.n_emitters else 0
    n_rays = at_vertex.sum() * (1 + shadow_rays)
    return (p_new, wi, nxt, cont), (l_dir, w, leaf, ~cont, n_rays)


def trace_paths_c(pack, o, d, lam, chan, key, max_bounces=8, method="auto", early_exit=True):
    """Radiance for a batch of primary rays (component form): o, d 3-tuples
    of (B,) tensors, lam (B,) wavelength in µm, chan (B,) RGB channel, key
    a `prng` key. Returns (radiance (B,), PathStats). `early_exit` stops
    the bounce loop once every lane has terminated (the same result)."""
    b = o[0].shape[0]
    dev = o[0].device
    hit = _detach_hit(intersect_c(pack, o, d, method=method))
    carry = (o, d, hit, torch.ones(b, dtype=torch.bool, device=dev))
    l_dirs = torch.zeros((max_bounces, b), dtype=torch.float32, device=dev)
    ws = torch.zeros_like(l_dirs)
    leaves = torch.zeros_like(l_dirs)
    terminals = torch.ones((max_bounces, b), dtype=torch.bool, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(max_bounces):
        if early_exit and not bool(carry[3].any()):
            break
        carry, rec = _bounce(pack, *carry, depth, key, lam, chan, method)
        l_dirs[depth], ws[depth], leaves[depth], terminals[depth] = rec[:4]
        rays = rays + rec[4]

    # reverse fold reproducing the nested per-level clamps (Scene.cpp:180-183)
    radiance = torch.zeros(b, dtype=torch.float32, device=dev)
    for depth in range(max_bounces - 1, -1, -1):
        radiance = torch.where(
            terminals[depth],
            leaves[depth],
            torch.clamp(l_dirs[depth], 0.0, CLAMP_DIRECT)
            + torch.clamp(ws[depth] * radiance, 0.0, CLAMP_INDIRECT),
        )
    return radiance, PathStats(rays=rays + b)


def trace_paths(pack, o, d, lam, chan, key, max_bounces=8, method="auto", early_exit=True):
    """(B, 3)-row wrapper over `trace_paths_c`."""
    return trace_paths_c(
        pack,
        tuple(o[:, k] for k in range(3)),
        tuple(d[:, k] for k in range(3)),
        lam, chan, key, max_bounces=max_bounces, method=method, early_exit=early_exit,
    )
