"""Plain PyTorch versions of the wavefront kernels (`csrc/wavefront.cu`):
the camera rays, the two halves of a bounce around the intersector, and the
reverse clamp fold. They replace no Pallas kernel: they are what XLA
compiles of `mcpt_tpu/camera.py:55-107` (`generate_rays_c`) and of
`mcpt_tpu/integrator.py:172-365` (`trace_paths_c`: its bounce body, with
`direct_lighting_c`, and its reverse fold) under `jit`.

Each function computes what its kernel computes, in the kernel's order:
one lane at a time in the kernel, all lanes at once here. The random
numbers are drawn per element at the flat index the kernel uses
(`prng.uniform_at`), which equals `prng.uniform(k, shape)` element for
element: the vertex draws (B, 4) at index 4i + c, the light draws (S·B, 4)
plane-major at 4(k·B + i) + c, the camera's (P, 4) at 4i + c.

A bounce is `shade_pre` (the surface, the material, the depth-0 emitter and
env leaves, the microfacet normal and Fresnel kr, the ε-offset points, the
S light samples with their shadow directions, visibility thresholds and
unshadowed contributions, roulette, the reflect/refract branch, the next
ray and its weight), then the intersector (the shadow fan and the next
ray's nearest hit), then `shade_post` (visibility, the NEE sum, `l_dir`,
`leaf`, `cont`, the depth's records and the ray count). These are also the
training path's forward: autograd follows them (`integrator.trace_paths_c`
takes them, not the kernels, when a pack tensor requires grad).
"""

import math
from typing import NamedTuple

import numpy as np
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
from mcpt_tpu_torch.intersect import surface_at_c
from mcpt_tpu_torch.kernels.megakernel_ref import _dot, _neg, _reflect, _where3
from mcpt_tpu_torch.kernels.megakernel_ref import sqrt_f32 as _sqrt
from mcpt_tpu_torch.lights import sample_light_c


class PreOut(NamedTuple):
    """What `shade_pre` hands the intersector and `shade_post`, per lane
    (B,) unless noted; vectors are 3-tuples."""

    p_new: tuple  # the next ray's origin
    wi: tuple  # the next ray's direction
    p_dl: tuple  # the shadow fan's origin (the ε-offset point)
    ws: tuple  # 3 x (S·B,) shadow directions, ray k·B + i from p_dl[i]
    thr: torch.Tensor  # (S·B,) visible when the fan's t >= thr
    contrib: torch.Tensor  # (S·B,) a light sample's contribution if visible
    fac: torch.Tensor  # the Fresnel weight of the NEE sum: 1 - kr inside, kr outside
    leaf_pre: torch.Tensor  # the leaf of a lane that is no vertex: 0, env, or emitter
    env_c: torch.Tensor  # the clamped env term of a vertex's leaf
    w: torch.Tensor  # the indirect weight (the depth's `w` record)
    at_vertex: torch.Tensor  # bool: alive, hit, not the depth-0 emitter leaf
    rr_kill: torch.Tensor  # bool: Russian roulette ends the path here


class Records(NamedTuple):
    """The bounce loop's per-depth records, each (D, B)."""

    l_dir: torch.Tensor
    w: torch.Tensor
    leaf: torch.Tensor
    terminal: torch.Tensor  # bool


def new_records(depth: int, b: int, device) -> Records:
    """Records of `depth` bounces for `b` lanes: a depth the loop never
    reaches stays terminal with a zero leaf."""
    l_dir = torch.zeros((depth, b), dtype=torch.float32, device=device)
    return Records(l_dir, torch.zeros_like(l_dir), torch.zeros_like(l_dir),
                   torch.ones((depth, b), dtype=torch.bool, device=device))


def n_samples(pack) -> int:
    """Light samples (shadow rays) a vertex: none without emitters."""
    return pack.n_dir_sample if pack.n_emitters else 0


def _draws(key, rows: int, device):
    """The (rows, 4) uniforms of `prng.uniform(key, (rows, 4))`, each
    drawn at its own flat index."""
    idx = 4 * torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    return prng.uniform_at(key, idx + torch.arange(4, device=device))


def camera_rays(camera, pixel_ids, key, lanes_per_pixel: int = 1):
    """Primary rays of the flat pixel ids (row-major, i = id % W, j = id //
    W) with the draws of `prng.uniform(key, (P, 4))` (Renderer.cpp:44-76):
    pinhole, or a thin lens with r = R·sqrt(u2), θ = 2π·u3 and the focal
    point at (x, y, 1)·focal_distance. Each ray repeats for
    `lanes_per_pixel` consecutive lanes (the render's three channels).
    Returns (o, d), 3-tuples of (P·lanes_per_pixel,) float32; d is unit
    length."""
    w, h = camera.width, camera.height
    scale = float(np.float32(np.tan(np.deg2rad(camera.fov * 0.5))))
    aspect = float(np.float32(w / float(h)))
    om = camera.orientation().tolist()
    i = (pixel_ids % w).to(torch.float32)
    j = torch.div(pixel_ids, w, rounding_mode="floor").to(torch.float32)
    u = _draws(key, pixel_ids.shape[0], pixel_ids.device)
    # true division by tensors: CUDA torch multiplies by the reciprocal of
    # a Python scalar divisor, which rounds differently
    x = (1.0 - 2.0 * (i + u[:, 0]) / torch.full_like(i, w)) * aspect * scale
    y = (1.0 - 2.0 * (j + u[:, 1]) / torch.full_like(j, h)) * scale

    def rot(v):
        return tuple(om[k][0] * v[0] + om[k][1] * v[1] + om[k][2] * v[2] for k in range(3))

    if camera.use_dof:
        fd = float(np.float32(camera.focal_distance))
        r = float(np.float32(camera.aperture_radius)) * _sqrt(u[:, 2])
        theta = 2.0 * math.pi * u[:, 3]
        dx = r * torch.cos(theta)
        dy = r * torch.sin(theta)
        lens_w = rot((dx, dy, torch.zeros_like(dx)))
        origins = tuple(float(np.float32(camera.position[k])) + lens_w[k] for k in range(3))
        dirs = (x * fd - dx, y * fd - dy, torch.ones_like(x) * fd)
    else:
        dirs = (x, y, torch.ones_like(x))
        origins = tuple(torch.full_like(x, float(np.float32(camera.position[k]))) for k in range(3))
    inv = 1.0 / _sqrt(dirs[0] * dirs[0] + dirs[1] * dirs[1] + dirs[2] * dirs[2])
    d = rot(tuple(c * inv for c in dirs))
    if lanes_per_pixel != 1:
        origins = tuple(c.repeat_interleave(lanes_per_pixel) for c in origins)
        d = tuple(c.repeat_interleave(lanes_per_pixel) for c in d)
    return origins, d


def env_chan(pack, d, chan):
    """The env map (or the background) along d at each lane's channel."""
    bg = tuple(float(b) for b in pack.background)
    return sample_env_chan(pack.env_pixels, bg, pack.use_env, d, chan)


def _light_samples(pack, key, wo, p, n, uv, m, lam, chan, is_reflect):
    """The light-sample half of the NEE estimator (Scene.cpp:56-82): per
    sample k of lane i (row k·B + i) the shadow direction from p, its
    visibility threshold and its contribution if visible:
    emit · eval · (ws·n) · (−ws·n_light) / dist² / pdf / S."""
    b = p[0].shape[0]
    s = n_samples(pack)
    if s == 0:
        empty = p[0].new_empty((0,))
        return (empty, empty, empty), empty, empty
    ls = sample_light_c(pack, _draws(key, s * b, p[0].device), chan.expand(s, b).reshape(-1))
    lp = tuple(x.reshape(s, b) for x in ls.p)
    ln = tuple(x.reshape(s, b) for x in ls.n)
    emit = ls.emit.reshape(s, b)
    lpdf = ls.pdf.reshape(s, b)

    delta = tuple(lp[k] - p[k] for k in range(3))  # (S, B) by broadcast
    dist = _sqrt(torch.clamp_min(_dot(delta, delta), 1e-20))
    inv_dist = 1.0 / dist
    ws = tuple(x * inv_dist for x in delta)
    # no hit strictly closer than the light sample, by a relative margin
    thr = dist - torch.clamp_min(REL_EPS * dist, EPSILON)
    ev = eval_bsdf_c(m, ws, wo, n, lam, uv, is_reflect)
    contrib = (
        emit * ev * _dot(ws, n) * -_dot(ws, ln) * (inv_dist * inv_dist)
        / lpdf / torch.full_like(lpdf, s)
    )
    return tuple(x.reshape(s * b) for x in ws), thr.reshape(s * b), contrib.reshape(s * b)


def shade_pre(pack, o, d, hit, alive, depth: int, key, lam, chan) -> PreOut:
    """The first half of bounce `depth` for the lanes (o, d) with nearest
    hit `hit` (Scene.cpp:85-159 up to the two ray queries): `key` is the
    path key; the bounce draws from fold_in(fold_in(key, depth), 0) (B, 4)
    and fold_in(fold_in(key, depth), 1) (S·B, 4)."""
    b = o[0].shape[0]
    kd = prng.fold_in(key, depth)
    surf = surface_at_c(pack, o, d, hit)
    happened = surf.happened
    wo = _neg(d)

    env_leaf = env_chan(pack, d, chan)  # miss: env/background (Scene.cpp:88-95)
    m = gather_material(pack, surf.mat, chan)
    # depth-0 emitter hit (Scene.cpp:102-107)
    b_leaf = torch.clamp(m["emit"] * torch.abs(_dot(wo, surf.n)), 0.0, 1.0)
    is_b = happened & surf.emissive if depth == 0 else torch.zeros_like(happened)
    at_vertex = alive & happened & ~is_b

    # microfacet normal + Fresnel split (Scene.cpp:109-110)
    xi = _draws(prng.fold_in(kd, 0), b, o[0].device)
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
    ws, thr, contrib = _light_samples(pack, prng.fold_in(kd, 1), wo, p_dl, surf.n, surf.uv, m,
                                      lam, chan, ~inner)
    fac = torch.where(inner, 1.0 - kr, kr)

    # Russian roulette + stochastic reflect/refract (Scene.cpp:121-159)
    rr_kill = xi[:, 2] >= float(pack.rr_rate)
    branch_reflect = xi[:, 3] < kr
    sign_reflect = torch.where(_dot(wo, mfn) < 0.0, -1.0, 1.0)
    sign = torch.where(branch_reflect, sign_reflect, -sign_reflect)
    p_new = tuple(p[k] + surf.n[k] * (off_scale * sign) for k in range(3))
    wi = _where3(branch_reflect, _reflect(wo, mfn), refract_c(m, d, mfn, lam))

    inv_rr = float(pack.inv_rr)
    ev = eval_bsdf_c(m, wi, wo, surf.n, lam, surf.uv, branch_reflect)
    pv = pdf_c(m, wi, wo, surf.n, lam, branch_reflect)
    # indirect weight (Scene.cpp:135-144,162-171), the reference's |wo·n|
    pv_ok = torch.abs(pv) > 1e-10
    w_rough = torch.where(
        pv_ok, ev * torch.abs(_dot(wo, surf.n)) / torch.where(pv_ok, pv, 1.0) * inv_rr, 0.0
    )
    w = torch.where(m["dirac"] > 0.5, ev * inv_rr, w_rough)
    env_ind = env_chan(pack, wi, chan) * ev * inv_rr
    leaf_pre = torch.where(~alive, 0.0, torch.where(~happened, env_leaf, b_leaf))
    return PreOut(
        p_new=p_new, wi=wi, p_dl=p_dl, ws=ws, thr=thr, contrib=contrib, fac=fac,
        leaf_pre=leaf_pre, env_c=torch.clamp(env_ind, 0.0, CLAMP_INDIRECT), w=w,
        at_vertex=at_vertex, rr_kill=rr_kill,
    )


def shade_post(pack, pre: PreOut, sh_t, nxt_prim, rec: Records, depth: int, rays):
    """The second half of bounce `depth`: the fan's visibility (`sh_t`, the
    occlusion query's t per shadow ray; None when shadows are off), the NEE
    sum over the samples from k = 0 up, `l_dir`, `leaf` (a roulette kill
    keeps the raw `l_dir`, Scene.cpp:129,156) and `cont` from the next
    ray's hit `nxt_prim`. Writes row `depth` of `rec`, adds the bounce's
    rays (1 + S a vertex) to `rays` (a 0-dim int64 tensor), and returns
    `cont`, the lanes still alive."""
    b = pre.fac.shape[0]
    s = n_samples(pack)
    if s:
        contrib = pre.contrib.reshape(s, b)
        if sh_t is not None:
            contrib = torch.where(sh_t.reshape(s, b) >= pre.thr.reshape(s, b), contrib, 0.0)
        total = contrib[0]
        for k in range(1, s):
            total = total + contrib[k]
    else:
        total = torch.zeros_like(pre.fac)
    l_dir = pre.fac * total

    nprim = nxt_prim.to(torch.int64)
    nxt_emissive = (nprim >= 0) & (pack.prim_emissive[nprim.clamp(min=0), 0] > 0.5)
    cont = pre.at_vertex & ~pre.rr_kill & (nprim >= 0) & ~nxt_emissive
    vertex_leaf = torch.where(
        pre.rr_kill,
        l_dir,  # raw early return (Scene.cpp:129,156)
        torch.clamp(l_dir, 0.0, CLAMP_DIRECT) + pre.env_c,
    )
    rec.l_dir[depth] = l_dir
    rec.w[depth] = pre.w
    rec.leaf[depth] = torch.where(pre.at_vertex, vertex_leaf, pre.leaf_pre)
    rec.terminal[depth] = ~cont
    rays += pre.at_vertex.sum() * (1 + s)
    return cont


def fold(rec: Records):
    """Radiance per lane from the records (Scene.cpp:180-183), the reverse
    fold reproducing the nested per-level clamps:
    L_d = terminal_d ? leaf_d : clamp15(l_dir_d) + clamp5(w_d · L_{d+1})."""
    radiance = torch.zeros_like(rec.leaf[0])
    for depth in range(rec.leaf.shape[0] - 1, -1, -1):
        radiance = torch.where(
            rec.terminal[depth],
            rec.leaf[depth],
            torch.clamp(rec.l_dir[depth], 0.0, CLAMP_DIRECT)
            + torch.clamp(rec.w[depth] * radiance, 0.0, CLAMP_INDIRECT),
        )
    return radiance
