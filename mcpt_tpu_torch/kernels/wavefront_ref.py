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
`leaf`, `cont`, the depth's records and the ray count). `shade_pre` is
`_vertex`, then `_samples` for the vertex's light samples.

The backward kernels' plain versions close the module, each written out by
hand in its kernel's order: `shade_pre_bwd` recomputes the vertex and its
light samples and runs them back through the reverses of their pieces
(`vertex_ref`, the plain versions of `csrc/wf_vertex.cuh`'s), and
`shade_post_bwd` and `fold_bwd`. Autograd through the forward functions
here is the tests' oracle of them (the route `plain (autograd)`).
"""

import math
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from mcpt_tpu_torch import prng
from mcpt_tpu_torch.bsdf import ior_of
from mcpt_tpu_torch.constants import CLAMP_DIRECT, CLAMP_INDIRECT, EPSILON, REL_EPS
from mcpt_tpu_torch.envmap import sample_env_chan
from mcpt_tpu_torch.intersect import surface_math, surface_rows
from mcpt_tpu_torch.kernels.megakernel_ref import (
    _dot,
    _neg,
    _reflect,
    _scale,
    _where3,
    eval_bsdf,
    fold_rows,
    fresnel,
    mat_fields,
    mat_rows,
    pdf,
    reflectance,
    refract,
    sample_mfn,
    take_rows,
)
from mcpt_tpu_torch.kernels.megakernel_ref import sqrt_f32 as _sqrt
from mcpt_tpu_torch.kernels.vertex_ref import (
    _acc,
    _sum3,
    _twice,
    dsqrt,
    env_bwd,
    eval_bsdf_bwd,
    fresnel_bwd,
    light_point_bwd,
    mask,
    pdf_bwd,
    reflect_bwd,
    refract_bwd,
    sample_mfn_bwd,
    sgn,
    surface_bwd,
)
from mcpt_tpu_torch.lights import light_point, pick


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


# shade_pre's outputs that carry a gradient but the light samples', in the
# backward seeds' order
RAY_OUT = ("p_new0", "p_new1", "p_new2", "wi0", "wi1", "wi2")
LEAF_OUT = ("fac", "leaf_pre", "env_c", "w")


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


# ---------------------------------------------------------------------------
# shade_pre: the vertex of each lane (`_vertex`), then its light samples
# (`_samples`); the reverse mode below recomputes both
# ---------------------------------------------------------------------------


def _vertex(pack, o, d, hit, alive, depth: int, kd, lam, chan):
    """The vertex of bounce `depth` for each lane (Scene.cpp:85-159 up to
    the ray queries): the surface, the material, the depth-0 emitter and
    env leaves, the microfacet normal and Fresnel kr, the ε-offset points,
    roulette, the reflect/refract branch, the next ray and its weight, with
    the values the reverse mode reads (a namespace; vectors are 3-tuples).
    The draws are fold_in(kd, 0)'s (B, 4)."""
    b = o[0].shape[0]
    v = SimpleNamespace(o=o, d=d, lam=lam, chan=chan, alive=alive)
    happened, is_tri, ts, ss, mat, emissive = surface_rows(pack, hit)
    rows, v.ok, v.mat_idx = mat_rows(pack.mat_fat, mat.float())
    xi = _draws(prng.fold_in(kd, 0), b, o[0].device)
    v.xi = [xi[:, c] for c in range(4)]
    v.happened, v.is_tri, v.ss = happened, is_tri, [ss[:, k] for k in range(3)]
    v.t_eff = torch.where(happened, hit.t, 0.0)
    v.p, v.n, uv = surface_math(o, d, hit.t, hit.u, hit.v, happened, is_tri,
                                [ts[:, k] for k in range(11)], [ss[:, k] for k in range(5)])
    v.wo = wo = _neg(d)
    n, p = v.n, v.p
    v.env_leaf = env_chan(pack, d, chan)  # miss: env/background (Scene.cpp:88-95)
    v.m = m = mat_fields([rows[:, k] for k in range(13)], v.ok, chan)
    # depth-0 emitter hit (Scene.cpp:102-107)
    v.won = _dot(wo, n)
    v.awon = torch.abs(v.won)
    v.b_leaf = torch.clamp(m["emit"] * v.awon, 0.0, 1.0)
    is_b = happened & emissive if depth == 0 else torch.zeros_like(happened)
    v.at_vertex = alive & happened & ~is_b
    v.ior = ior = ior_of(m, lam)
    v.refl = reflectance(m, uv)

    # microfacet normal + Fresnel split (Scene.cpp:109-110)
    v.mfn = mfn = sample_mfn(m, n, v.xi[0], v.xi[1])
    v.kr = kr = fresnel(m, ior, d, mfn)

    # NEE from the scale-relative ε-offset point (Scene.cpp:113-119)
    v.a = [torch.abs(p[k]) for k in range(3)]
    v.mx = torch.maximum(v.a[0], torch.maximum(v.a[1], v.a[2]))
    v.off_scale = torch.clamp_min(REL_EPS * v.mx, EPSILON)
    v.p_dl = tuple(p[k] + n[k] * v.off_scale for k in range(3))
    v.inner = v.won < 0.0
    v.fac = torch.where(v.inner, 1.0 - kr, kr)

    # Russian roulette + stochastic reflect/refract (Scene.cpp:121-159)
    v.rr_kill = v.xi[2] >= float(pack.rr_rate)
    v.branch = v.xi[3] < kr
    sign_reflect = torch.where(_dot(wo, mfn) < 0.0, -1.0, 1.0)
    v.sign = torch.where(v.branch, sign_reflect, -sign_reflect)
    v.p_new = tuple(p[k] + n[k] * (v.off_scale * v.sign) for k in range(3))
    v.wi = wi = _where3(v.branch, _reflect(wo, mfn), refract(ior, d, mfn))

    inv_rr = float(pack.inv_rr)
    v.ev = ev = eval_bsdf(m, ior, v.refl, wi, wo, n, v.branch)
    v.pv = pdf(m, ior, wi, wo, n, v.branch)
    # indirect weight (Scene.cpp:135-144,162-171), the reference's |wo·n|
    v.pv_ok = torch.abs(v.pv) > 1e-10
    v.pvs = torch.where(v.pv_ok, v.pv, 1.0)
    v.wr = ev * v.awon / v.pvs
    v.dirac = m["dirac"] > 0.5
    v.w = torch.where(v.dirac, ev * inv_rr, torch.where(v.pv_ok, v.wr * inv_rr, 0.0))
    v.env_wi = env_chan(pack, wi, chan)
    v.env_ind = v.env_wi * ev * inv_rr
    v.leaf_pre = torch.where(~alive, 0.0, torch.where(~happened, v.env_leaf, v.b_leaf))
    return v


def _samples(pack, v, k_light, s: int):
    """The light-sample half of the NEE estimator (Scene.cpp:56-82) for the
    S samples of each lane's vertex `v` (each value (S, B), sample k of
    lane i at [k, i], with the draws of uniform(k_light, (S·B, 4))): the
    picked emitter row and its point, the shadow direction from p_dl, its
    visibility threshold and its contribution if visible, emit · eval ·
    (ws·n) · (−ws·n_light) / dist² / pdf / s, with the values the reverse
    mode reads."""
    b = v.kr.shape[0]
    u = _draws(k_light, s * b, v.kr.device)
    sm = SimpleNamespace()
    sm.sel, mesh_area = pick(pack, u)
    rows = take_rows(pack.emt_fat, sm.sel).reshape(s, b, 17)
    sm.e = [rows[..., k] for k in range(17)]
    sm.lu2, sm.lu3 = u[:, 2].reshape(s, b), u[:, 3].reshape(s, b)
    ls = light_point(sm.e, mesh_area.reshape(s, b), sm.lu2, sm.lu3, v.chan,
                     bool(pack.n_sph_emitters))
    sm.ln, sm.emit, sm.pdf = ls.n, ls.emit, ls.pdf
    sm.delta = tuple(ls.p[k] - v.p_dl[k] for k in range(3))
    sm.dd = _dot(sm.delta, sm.delta)
    sm.cl = torch.clamp_min(sm.dd, 1e-20)
    dist = _sqrt(sm.cl)
    sm.inv_dist = 1.0 / dist
    sm.ws = tuple(c * sm.inv_dist for c in sm.delta)
    # no hit strictly closer than the light sample, by a relative margin
    sm.thr = dist - torch.clamp_min(REL_EPS * dist, EPSILON)
    sm.ev = eval_bsdf(v.m, v.ior, v.refl, sm.ws, v.wo, v.n, ~v.inner)
    sm.dn = _dot(sm.ws, v.n)
    sm.dl = _dot(sm.ws, sm.ln)
    sm.q = sm.inv_dist * sm.inv_dist
    sm.a1 = sm.emit * sm.ev
    sm.a2 = sm.a1 * sm.dn
    sm.a3 = sm.a2 * -sm.dl
    sm.contrib = sm.a3 * sm.q / sm.pdf / torch.full_like(sm.pdf, s)
    return sm


def shade_pre(pack, o, d, hit, alive, depth: int, key, lam, chan) -> PreOut:
    """The first half of bounce `depth` for the lanes (o, d) with nearest
    hit `hit` (Scene.cpp:85-159 up to the two ray queries): `key` is the
    path key; the bounce draws from fold_in(fold_in(key, depth), 0) (B, 4)
    and fold_in(fold_in(key, depth), 1) (S·B, 4)."""
    kd = prng.fold_in(key, depth)
    v = _vertex(pack, o, d, hit, alive, depth, kd, lam, chan)
    s = n_samples(pack)
    if s:
        sm = _samples(pack, v, prng.fold_in(kd, 1), s)
        ws = tuple(c.reshape(-1) for c in sm.ws)
        thr, contrib = sm.thr.reshape(-1), sm.contrib.reshape(-1)
    else:
        empty = o[0].new_empty((0,))
        ws, thr, contrib = (empty, empty, empty), empty, empty
    return PreOut(
        p_new=v.p_new, wi=v.wi, p_dl=v.p_dl, ws=ws, thr=thr, contrib=contrib, fac=v.fac,
        leaf_pre=v.leaf_pre, env_c=torch.clamp(v.env_ind, 0.0, CLAMP_INDIRECT), w=v.w,
        at_vertex=v.at_vertex, rr_kill=v.rr_kill,
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


# ---------------------------------------------------------------------------
# The backward kernels' plain versions: the reverse modes of shade_pre (over
# `vertex_ref`'s reverses of the vertex's pieces), of shade_post and of fold
# ---------------------------------------------------------------------------


def _sample_bwd(pack, v, sm, g_c, s: int):
    """The reverse of `_samples` for the contributions' adjoints g_c (S, B):
    (the adjoints of the vertex's p_dl, n, wo, ior, rough and reflectance,
    each (S, B) per sample, and the emitter rows' adjoints, 17 of (S, B))."""
    g_a4 = g_c / torch.full_like(g_c, s) / sm.pdf
    g_q = g_a4 * sm.a3
    g_a3 = g_a4 * sm.q
    g_a2 = g_a3 * -sm.dl
    g_dl = -(g_a3 * sm.a2)
    g_a1 = g_a2 * sm.dn
    g_dn = g_a2 * sm.a1
    g_emit = g_a1 * sm.ev
    g_ior, g_alpha, g_refl, g_ws, g_wo, g_n, _ = eval_bsdf_bwd(
        v.m["mtype"], v.ior, v.m["rough"], v.refl, sm.ws, v.wo, v.n, ~v.inner, g_a1 * sm.emit)
    g_ws = tuple(g_ws[k] + (g_dn * v.n[k] + g_dl * sm.ln[k]) for k in range(3))
    g_n = tuple(g_n[k] + g_dn * sm.ws[k] for k in range(3))
    g_inv = _sum3(g_ws, sm.delta) + _twice(g_q, sm.inv_dist)
    g_dd = mask(sm.dd >= 1e-20, dsqrt(-g_inv * (sm.inv_dist * sm.inv_dist), sm.cl))
    g_lp = tuple(g_ws[k] * sm.inv_dist + _twice(g_dd, sm.delta[k]) for k in range(3))
    g_row = light_point_bwd(sm.e, sm.lu2, sm.lu3, v.chan, bool(pack.n_sph_emitters), g_lp,
                            _scale(sm.ws, g_dl), g_emit)
    return (g_lp, g_n, g_wo, g_ior, g_alpha, g_refl), g_row


def shade_pre_bwd(pack, o, d, hit, alive, depth: int, key, lam, chan, grads):
    """The reverse mode of `shade_pre` (the plain version of the backward
    kernel `shade_pre_bwd`): `grads` maps the names of RAY_OUT (all or
    none), LEAF_OUT and "contrib" ((S·B,)) to output gradients. Returns
    (g_o, g_d, g_mat, g_emt): the lanes' o and d adjoints (3-tuples of
    (B,)) and the gradients of `pack.mat_fat` and `pack.emt_fat`, their
    per-lane row adjoints folded into the tables by `fold_rows`.

    Every lane recomputes its vertex (`_vertex`); then its light samples
    run forward and back (`_samples`, `_sample_bwd`), and their adjoints of
    the vertex's values are summed in sample order from k = 0; then the
    vertex runs back, piece by piece, last first (`vertex_ref`)."""
    b = o[0].shape[0]
    s = n_samples(pack)
    kd = prng.fold_in(key, depth)
    v = _vertex(pack, o, d, hit, alive, depth, kd, lam, chan)
    m, ior, inv_rr = v.m, v.ior, float(pack.inv_rr)
    mtype, alpha = m["mtype"], m["rough"]
    zero = torch.zeros_like(v.kr)
    z3 = (zero, zero, zero)
    a_pdl, a_n, a_wo, a_ior, a_alpha, a_refl = z3, z3, z3, zero, zero, zero
    g_emt = pack.emt_fat.new_zeros((0, 17))
    sel = torch.zeros(0, dtype=torch.int64, device=zero.device)
    if s:
        sm = _samples(pack, v, prng.fold_in(kd, 1), s)
        (g_lp, g_n, g_wo, g_ior, g_alpha, g_refl), g_row = _sample_bwd(
            pack, v, sm, grads["contrib"].reshape(s, b), s)
        for k in range(s):
            a_pdl = tuple(a_pdl[j] - g_lp[j][k] for j in range(3))
            a_n = tuple(a_n[j] + g_n[j][k] for j in range(3))
            a_wo = tuple(a_wo[j] + g_wo[j][k] for j in range(3))
            a_ior = a_ior + g_ior[k]
            a_alpha = a_alpha + g_alpha[k]
            a_refl = a_refl + g_refl[k]
        g_emt = torch.stack([c.expand(s, b) for c in g_row], -1).reshape(s * b, 17)
        sel = sm.sel

    # the leaves and the indirect weight
    g_env_ind = mask((v.env_ind >= 0.0) & (v.env_ind <= CLAMP_INDIRECT), grads["env_c"])
    g_leaf, g_w = grads["leaf_pre"], grads["w"]
    g_t = g_env_ind * inv_rr
    g_ev = g_t * v.env_wi + mask(v.dirac, g_w * inv_rr)
    g_wr = mask(v.pv_ok, torch.where(v.dirac, 0.0, g_w)) * inv_rr
    g_num = g_wr / v.pvs
    g_ev = g_ev + g_num * v.awon
    g_awon = g_num * v.ev
    g_pv = mask(v.pv_ok, -g_wr * (v.wr / v.pvs))
    # the next ray's direction: its env term, pdf, BSDF, reflect or refract
    g_wi = tuple(grads[f"wi{k}"] for k in range(3)) if "wi0" in grads else z3
    if pack.use_env:
        g_wi = _acc(g_wi, env_bwd(pack.env_pixels, v.wi, chan, g_t * v.ev))
    gi1, ga1, g_wi1, g_wo1, g_n1 = pdf_bwd(mtype, ior, alpha, v.wi, v.wo, v.n, v.branch, g_pv)
    gi2, ga2, gr2, g_wi2, g_wo2, g_n2, _ = eval_bsdf_bwd(mtype, ior, alpha, v.refl, v.wi, v.wo,
                                                      v.n, v.branch, g_ev)
    g_wi = _acc(_acc(g_wi, g_wi1), g_wi2)
    g_wo3, g_mfn = (tuple(mask(v.branch, x) for x in y) for y in reflect_bwd(v.wo, v.mfn, g_wi))
    gi3, g_d3, g_mfn3 = refract_bwd(ior, v.d, v.mfn, g_wi)
    gi3, g_d3, g_mfn3 = (mask(~v.branch, gi3), tuple(mask(~v.branch, x) for x in g_d3),
                         tuple(mask(~v.branch, x) for x in g_mfn3))
    # fac, then kr and the microfacet normal
    g_kr = torch.where(v.inner, -grads["fac"], grads["fac"])
    gi4, g_d4, g_mfn4 = fresnel_bwd(mtype, ior, v.d, v.mfn, g_kr)
    g_n5, ga5 = sample_mfn_bwd(mtype, alpha, v.n, v.xi[0], v.xi[1],
                               _acc(_acc(g_mfn, g_mfn3), g_mfn4))
    # the next ray's origin p + n·(off_scale·sign) and the fan's p + n·off_scale
    g_pn = tuple(grads[f"p_new{k}"] for k in range(3)) if "p_new0" in grads else z3
    os_ = v.off_scale * v.sign
    g_off = _sum3(g_pn, v.n) * v.sign + _sum3(a_pdl, v.n)
    g_mx = mask(REL_EPS * v.mx >= EPSILON, g_off) * REL_EPS
    a0, a1, a2 = v.a
    m12 = torch.maximum(a1, a2)
    h0 = torch.where(a0 == m12, g_mx * 0.5, g_mx)
    g_m12 = torch.where(a0 > m12, 0.0, h0)
    h1 = torch.where(a1 == a2, g_m12 * 0.5, g_m12)
    g_a = (torch.where(a0 < m12, 0.0, h0), torch.where(a1 < a2, 0.0, h1),
           torch.where(a1 > a2, 0.0, h1))
    g_p = tuple((g_pn[k] + a_pdl[k]) + g_a[k] * sgn(v.p[k]) for k in range(3))
    # the depth-0 emitter leaf clamp(emit·|wo·n|, 0, 1)
    bl = m["emit"] * v.awon
    g_bl = mask(alive & v.happened & (bl >= 0.0) & (bl <= 1.0), g_leaf)
    g_emit = g_bl * v.awon
    g_won = (g_awon + g_bl * m["emit"]) * sgn(v.won)
    g_n = tuple(((((a_n[k] + (g_pn[k] * os_ + a_pdl[k] * v.off_scale)) + g_n1[k]) + g_n2[k])
                 + g_n5[k]) + g_won * v.wo[k] for k in range(3))
    g_wo = tuple((((a_wo[k] + g_wo1[k]) + g_wo2[k]) + g_wo3[k]) + g_won * v.n[k]
                 for k in range(3))
    g_ior = (((a_ior + gi1) + gi2) + gi3) + gi4
    g_alpha = ((a_alpha + ga1) + ga2) + ga5
    g_refl = torch.where(m["textured"] > 0.5, 0.0, a_refl + gr2)
    # the ray: wo = -d, the env leaf of a miss, the surface
    g_d = tuple((g_d3[k] + g_d4[k]) - g_wo[k] for k in range(3))
    if pack.use_env:
        g_d = _acc(g_d, env_bwd(pack.env_pixels, d, chan, mask(alive & ~v.happened, g_leaf)))
    g_o, g_dp = surface_bwd(o, d, v.t_eff, v.is_tri, v.ss, g_p, g_n)
    g_d = _acc(g_d, g_dp)
    # the material row (mat_fields: ior_a, ior_b, rough, refl and emit at chan)
    ok = v.ok
    g_mat = [zero, mask(ok, g_ior), mask(ok, g_ior / (lam * lam)), mask(ok, g_alpha)]
    g_mat += [mask(ok & (chan == c), g_refl) for c in range(3)]
    g_mat += [mask(ok & (chan == c), g_emit) for c in range(3)]
    g_mat += [zero, zero, zero]
    return (g_o, g_d, fold_rows(torch.stack(g_mat, 1), v.mat_idx, pack.mat_fat.shape[0]),
            fold_rows(g_emt, sel, pack.emt_fat.shape[0]))


def shade_post_bwd(pre: PreOut, sh_t, s: int, g_l_dir, g_w, g_leaf):
    """The reverse mode of `shade_post` for the gradients of its record row
    (l_dir, w, leaf): (g_contrib (S·B,), g_fac, g_leaf_pre, g_env_c, g_w),
    each lane's in the kernel `shade_post_bwd`'s order."""
    b = pre.fac.shape[0]
    total = torch.zeros_like(pre.fac)
    vis = None
    if s:
        contrib = pre.contrib.reshape(s, b)
        if sh_t is not None:
            vis = sh_t.reshape(s, b) >= pre.thr.reshape(s, b)
            contrib = torch.where(vis, contrib, 0.0)
        total = contrib[0]
        for k in range(1, s):
            total = total + contrib[k]
    l_dir = pre.fac * total
    gv = torch.where(pre.at_vertex, g_leaf, 0.0)  # the vertex's leaf
    g_leaf_pre = torch.where(pre.at_vertex, 0.0, g_leaf)
    g_env_c = torch.where(pre.rr_kill, 0.0, gv)
    inside = (l_dir >= 0.0) & (l_dir <= CLAMP_DIRECT)
    g_l = (g_l_dir + torch.where(pre.rr_kill, gv, 0.0)
           + torch.where(inside & ~pre.rr_kill, gv, 0.0))
    g_fac = g_l * total
    g_total = g_l * pre.fac
    g_contrib = g_total.repeat(s)
    if vis is not None:
        g_contrib = torch.where(vis.reshape(-1), g_contrib, 0.0)
    return g_contrib, g_fac, g_leaf_pre, g_env_c, g_w


def fold_bwd(rec: Records, g):
    """The reverse mode of `fold` for the radiance gradient `g` (B,):
    (g_l_dir, g_w, g_leaf), each (D, B), autograd's formulas through every
    depth (a terminal depth passes nothing on)."""
    depth = rec.leaf.shape[0]
    radiance = torch.zeros_like(rec.leaf[0])
    nxt = [None] * depth
    for k in range(depth - 1, -1, -1):
        nxt[k] = radiance
        radiance = torch.where(
            rec.terminal[k],
            rec.leaf[k],
            torch.clamp(rec.l_dir[k], 0.0, CLAMP_DIRECT)
            + torch.clamp(rec.w[k] * radiance, 0.0, CLAMP_INDIRECT),
        )
    g_l_dir, g_w, g_leaf = [], [], []
    for k in range(depth):
        g_leaf.append(torch.where(rec.terminal[k], g, 0.0))
        gn = torch.where(rec.terminal[k], 0.0, g)
        inside = (rec.l_dir[k] >= 0.0) & (rec.l_dir[k] <= CLAMP_DIRECT)
        g_l_dir.append(torch.where(inside, gn, 0.0))
        z = rec.w[k] * nxt[k]
        gz = torch.where((z >= 0.0) & (z <= CLAMP_INDIRECT), gn, 0.0)
        g_w.append(gz * nxt[k])
        g = gz * rec.w[k]
    return torch.stack(g_l_dir), torch.stack(g_w), torch.stack(g_leaf)
