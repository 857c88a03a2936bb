"""Plain PyTorch versions of the reverses of the wavefront vertex's pieces
(`csrc/wf_vertex.cuh`): the surface at the hit, the env leaf, the light
sample's point, the microfacet normal, Fresnel, refraction and reflection,
the BSDF and its pdf. Each `*_bwd` takes its function's primal inputs and
the adjoints of its outputs, recomputes its own internals from those
inputs, and returns the adjoints of the inputs that carry a gradient.

The forward functions are `megakernel_ref`'s (and `envmap`'s, `lights`'s);
each reverse recomputes their values in their float32 order and runs
autograd's rules backward through them: clamp passes its closed interval,
maximum halves a tie, abs multiplies by the sign (0 at 0), a float64 sqrt
rounded to float32 takes its derivative in float64 rounded once (`dsqrt`),
`where` sends the adjoint to the side it took. The kernel's device
functions do the same operations in the same order, lane by lane, so on
the card the two agree bit for bit (built with -fmad=false, no fast math).
A block that a lane does not take (a lobe of the BSDF, a branch of the
reverse, Fresnel on a conductor) is computed here for every lane and its
outputs masked to +0 (`mask`); the kernel skips it and takes +0, so even
the signs of zeros agree. Vectors are 3-tuples of tensors; everything
broadcasts.
"""

import math

import torch

from mcpt_tpu_torch.constants import EPSILON
from mcpt_tpu_torch.kernels.megakernel_ref import (
    _add,
    _cross,
    _dot,
    _neg,
    _scale,
    _sub,
    _where3,
    d_ggx,
    fresnel,
    fresnel_schlick,
    g1,
    is_conductor,
    is_rough,
)
from mcpt_tpu_torch.kernels.megakernel_ref import sqrt_f32 as _sqrt

PI = math.pi  # float32(π) where it meets a float32 tensor
TWO_PI = 2.0 * math.pi
ONE_MINUS_EPS = 1.0 - EPSILON


# ---------------------------------------------------------------------------
# autograd's rules, written out
# ---------------------------------------------------------------------------


def dsqrt(g, x):
    """The adjoint of `sqrt_f32` at x for the output adjoint g: g / (2·√x)
    in float64, rounded once."""
    return (g.to(torch.float64) / (2.0 * torch.sqrt(x.to(torch.float64)))).to(torch.float32)


def sgn(x):
    """abs's derivative: 1, -1, or 0 at 0 (and NaN)."""
    return torch.where(x > 0.0, 1.0, torch.where(x < 0.0, -1.0, 0.0))


def mask(c, g):
    """The adjoint where `c`, else 0."""
    return torch.where(c, g, 0.0)


def ssqrt_bwd(g, x):
    """megakernel_ref._ssqrt (sqrt of clamp_min(x, 1e-12)) backward."""
    return mask(x >= 1e-12, dsqrt(g, torch.clamp_min(x, 1e-12)))


def _sum3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _acc(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _twice(g, a):
    """The adjoint of a from a·a: 2·(g·a)."""
    return 2.0 * (g * a)


def normalize_bwd(a, g):
    """megakernel_ref._normalize backward: the adjoint of a."""
    dd = _dot(a, a)
    cl = torch.clamp_min(dd, 1e-20)
    inv = 1.0 / _sqrt(cl)
    g_inv = _sum3(g, a)
    g_dd = mask(dd >= 1e-20, dsqrt(-g_inv * (inv * inv), cl))
    return tuple(g[k] * inv + _twice(g_dd, a[k]) for k in range(3))


def reflect_bwd(wo, n, g):
    """megakernel_ref._reflect (n·2(wo·n) − wo) backward: (g_wo, g_n)."""
    s = 2.0 * _dot(wo, n)
    g_dot = _sum3(g, n) * 2.0
    g_wo = tuple(-g[k] + g_dot * n[k] for k in range(3))
    g_n = tuple(g[k] * s + g_dot * wo[k] for k in range(3))
    return g_wo, g_n


def schlick_bwd(c, f0, g):
    """megakernel_ref.fresnel_schlick backward: (g_c, g_f0)."""
    inv = 1.0 - c
    c2 = inv * inv
    a = 1.0 - f0
    p1 = a * c2
    p2 = p1 * c2
    g_p2 = g * inv
    g_inv = g * p2
    g_p1 = g_p2 * c2
    g_c2 = g_p2 * p1
    g_a = g_p1 * c2
    g_c2 = g_c2 + g_p1 * a
    g_inv = g_inv + _twice(g_c2, inv)
    return -g_inv, g - g_a


# ---------------------------------------------------------------------------
# the surface, the env leaf and the light sample
# ---------------------------------------------------------------------------


def surface_bwd(o, d, t_eff, is_tri, ss, g_p, g_n):
    """intersect.surface_math backward (t detached, the rows constant):
    (g_o, g_d) from the adjoints of the point p = o + d·t_eff and of the
    normal, which depends on p only on a sphere."""
    p = tuple(o[k] + d[k] * t_eff for k in range(3))
    ns = tuple(p[k] - ss[k] for k in range(3))
    sq = ns[0] * ns[0] + ns[1] * ns[1] + ns[2] * ns[2]
    ln = _sqrt(sq)
    inv = 1.0 / torch.clamp_min(ln, 1e-20)
    g_inv = _sum3(g_n, ns)
    g_sq = mask(ln >= 1e-20, dsqrt(-g_inv * (inv * inv), sq))
    g_pp = tuple(g_p[k] + mask(~is_tri, g_n[k] * inv + _twice(g_sq, ns[k])) for k in range(3))
    return g_pp, tuple(g_pp[k] * t_eff for k in range(3))


def env_bwd(env, d, chan, g):
    """envmap.sample_env_chan backward for a map (the background has no
    gradient): the adjoint of the direction d, through the bilinear
    weights (the texels and their indices are constant)."""
    h, w = env.shape[0], env.shape[1]
    n2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    ok = n2 > 1e-12
    n2s = torch.where(ok, n2, 1.0)
    r = 1.0 / _sqrt(n2s)
    inv = torch.where(ok, r, 0.0)
    x_, y_, z_ = d[0] * inv, d[1] * inv, d[2] * inv
    phi = torch.atan2(z_, x_)
    yc = torch.clamp(y_, -1.0, 1.0)
    theta = torch.acos(yc)
    u = (phi + PI) / torch.full_like(phi, TWO_PI)
    v = theta / torch.full_like(theta, PI)
    u = u - torch.floor(u)
    vc = torch.clamp(v, 0.0, 1.0)
    x = u * w - 0.5
    y = vc * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    sx = x - x0
    sy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x0w = torch.remainder(x0i, w)
    x1w = torch.remainder(x0i + 1, w)
    y0c = torch.clamp(y0i, 0, h - 1)
    y1c = torch.clamp(y0i + 1, 0, h - 1)
    c00, c10, c01, c11 = (torch.take(env, t * 3 + chan) for t in (
        y0c * w + x0w, y0c * w + x1w, y1c * w + x0w, y1c * w + x1w))
    c0 = c00 * (1.0 - sx) + c10 * sx
    c1 = c01 * (1.0 - sx) + c11 * sx
    g_c0 = g * (1.0 - sy)
    g_c1 = g * sy
    g_y = g * c1 - g * c0
    g_x = ((g_c0 * c10 - g_c0 * c00) + g_c1 * c11) - g_c1 * c01
    g_v = mask((v >= 0.0) & (v <= 1.0), g_y * h)
    g_phi = (g_x * w) / torch.full_like(phi, TWO_PI)
    g_theta = g_v / torch.full_like(theta, PI)
    g_yc = g_theta * -(1.0 / _sqrt(1.0 - yc * yc))
    g_y_ = mask((y_ >= -1.0) & (y_ <= 1.0), g_yc)
    rr = 1.0 / (z_ * z_ + x_ * x_)
    g_z_ = g_phi * x_ * rr
    g_x_ = g_phi * -z_ * rr
    g_u = (g_x_, g_y_, g_z_)
    g_inv = _sum3(g_u, d)
    g_n2 = mask(ok, dsqrt(-mask(ok, g_inv) * (r * r), n2s))
    return tuple(g_u[k] * inv + _twice(g_n2, d[k]) for k in range(3))


def light_point_bwd(row, u2, u3, chan, spheres: bool, g_p, g_n, g_emit):
    """lights.light_point backward: the adjoint of the emitter row's 17
    columns (a list of tensors, zeros where a column takes none) from the
    adjoints of the point, its normal and its emission (the pdf reads the
    mesh's area, which takes none)."""
    x = _sqrt(u2)
    wx = x * (1.0 - u3)
    wy = x * u3
    zero = torch.zeros_like(g_emit)
    if spheres:
        is_se = row[16] > 0.5
        ys = 1.0 - 2.0 * u2
        s = _sqrt(torch.clamp_min(1.0 - ys * ys, 0.0))
        ph = TWO_PI * u3
        dv = (s * torch.cos(ph), ys, s * torch.sin(ph))
        g_ps = tuple(mask(is_se, g_p[k]) for k in range(3))
        g_p = tuple(torch.where(is_se, 0.0, g_p[k]) for k in range(3))
        g_n = tuple(torch.where(is_se, 0.0, g_n[k]) for k in range(3))
    out = [g_p[0], g_p[1], g_p[2], g_p[0] * wx, g_p[1] * wx, g_p[2] * wx,
           g_p[0] * wy, g_p[1] * wy, g_p[2] * wy, g_n[0], g_n[1], g_n[2],
           mask(chan == 0, g_emit), mask(chan == 1, g_emit), mask(chan == 2, g_emit),
           zero, zero]
    if spheres:
        for k in range(3):
            out[k] = out[k] + g_ps[k]
        out[3] = out[3] + _sum3(g_ps, dv)
    return out


# ---------------------------------------------------------------------------
# the microfacet normal, Fresnel, refraction
# ---------------------------------------------------------------------------


def tangent_frame_bwd(n, g_t, g_b):
    """megakernel_ref.tangent_frame backward: the adjoint of n."""
    nx, ny, nz = n
    ax = torch.abs(nx) > torch.abs(ny)
    sx = nx * nx + nz * nz
    sy = ny * ny + nz * nz
    clx = torch.clamp_min(sx, 1e-30)
    cly = torch.clamp_min(sy, 1e-30)
    lx = _sqrt(clx)
    ly = _sqrt(cly)
    zero = torch.zeros_like(nx)
    t = _where3(ax, (-nz / lx, zero, nx / lx), (zero, nz / ly, -ny / ly))
    g_n = _cross(t, g_b)
    g_t = _acc(g_t, _cross(g_b, n))
    ga = tuple(mask(ax, g_t[k]) for k in range(3))
    gb = tuple(torch.where(ax, 0.0, g_t[k]) for k in range(3))
    # t = (-nz/lx, 0, nx/lx) where ax, else (0, nz/ly, -ny/ly)
    g_lx = -ga[0] * (t[0] / lx) - ga[2] * (t[2] / lx)
    g_ly = -gb[1] * (t[1] / ly) - gb[2] * (t[2] / ly)
    g_sx = mask(sx >= 1e-30, dsqrt(g_lx, clx))
    g_sy = mask(sy >= 1e-30, dsqrt(g_ly, cly))
    gx = g_n[0] + (ga[2] / lx + _twice(g_sx, nx))
    gy = g_n[1] + (-(gb[2] / ly) + _twice(g_sy, ny))
    gz = g_n[2] + ((-(ga[0] / lx) + _twice(g_sx, nz)) + (gb[1] / ly + _twice(g_sy, nz)))
    return gx, gy, gz


def sample_mfn_bwd(mtype, alpha, n, xi1, xi2, g):
    """megakernel_ref.sample_mfn backward: (g_n, g_alpha) from the adjoint
    of the microfacet normal (n itself on a smooth lane)."""
    rough = is_rough(mtype)
    phi = TWO_PI * xi1
    a2 = alpha * alpha
    den0 = 1.0 + (a2 - 1.0) * xi2
    den = torch.clamp_min(den0, 1e-20)
    ratio = torch.clamp_min(1.0 - xi2, 0.0) / den
    cos_t = _sqrt(torch.clamp_min(ratio, 1e-12))
    q = 1.0 - cos_t * cos_t
    sin_t = _sqrt(torch.clamp_min(q, 1e-12))
    cph, sph = torch.cos(phi), torch.sin(phi)
    hx = sin_t * cph
    hy = sin_t * sph
    nx, ny, nz = n
    ax = torch.abs(nx) > torch.abs(ny)
    lx = _sqrt(torch.clamp_min(nx * nx + nz * nz, 1e-30))
    ly = _sqrt(torch.clamp_min(ny * ny + nz * nz, 1e-30))
    zero = torch.zeros_like(nx)
    t = _where3(ax, (-nz / lx, zero, nx / lx), (zero, nz / ly, -ny / ly))
    b = _cross(n, t)
    hu = _add(_add(_scale(t, hx), _scale(b, hy)), _scale(n, cos_t))
    g_hu = normalize_bwd(hu, g)
    g_sin = _sum3(g_hu, t) * cph + _sum3(g_hu, b) * sph
    g_cos = _sum3(g_hu, n) - _twice(ssqrt_bwd(g_sin, q), cos_t)
    g_ratio = ssqrt_bwd(g_cos, ratio)
    g_den0 = mask(den0 >= 1e-20, -g_ratio * (ratio / den))
    g_alpha = _twice(g_den0 * xi2, alpha)
    g_tn = tangent_frame_bwd(n, _scale(g_hu, hx), _scale(g_hu, hy))
    g_n = tuple(torch.where(rough, 0.0, g[k]) + mask(rough, g_hu[k] * cos_t + g_tn[k])
                for k in range(3))
    return g_n, mask(rough, g_alpha)


def fresnel_bwd(mtype, ior, inc, nrm, g):
    """megakernel_ref.fresnel backward: (g_ior, g_inc, g_nrm); a block that
    a conductor or total internal reflection (kr is 1 there) skips."""
    dt = _dot(inc, nrm)
    cosi = torch.clamp(dt, -1.0, 1.0)
    outside = cosi <= 0.0
    etai = torch.where(outside, 1.0, ior)
    etat = torch.where(outside, ior, 1.0)
    q = 1.0 - cosi * cosi
    sq = _sqrt(torch.clamp_min(q, 1e-12))
    ratio = etai / etat
    sint = ratio * sq
    tir = sint >= 1.0
    sint_s = torch.where(tir, 0.0, sint)
    q2 = 1.0 - sint_s * sint_s
    cost = _sqrt(torch.clamp_min(q2, 1e-12))
    aci = torch.abs(cosi)
    rsd0 = etat * aci + etai * cost
    rpd0 = etai * aci + etat * cost
    rs_den = torch.clamp_min(rsd0, 1e-6)
    rp_den = torch.clamp_min(rpd0, 1e-6)
    rs = (etat * aci - etai * cost) / rs_den
    rp = (etai * aci - etat * cost) / rp_den
    gs = g * 0.5
    g_rs = _twice(gs, rs)
    g_rp = _twice(gs, rp)
    g_rsn = g_rs / rs_den
    g_rpn = g_rp / rp_den
    g_rsd = mask(rsd0 >= 1e-6, -g_rs * (rs / rs_den))
    g_rpd = mask(rpd0 >= 1e-6, -g_rp * (rp / rp_den))
    g_etat = ((g_rsd * aci + g_rpd * cost) + g_rsn * aci) - g_rpn * cost
    g_etai = ((g_rsd * cost + g_rpd * aci) - g_rsn * cost) + g_rpn * aci
    g_aci = ((g_rsd * etat + g_rpd * etai) + g_rsn * etat) + g_rpn * etai
    g_cost = ((g_rsd * etai + g_rpd * etat) - g_rsn * etai) - g_rpn * etat
    g_sint = torch.where(tir, 0.0, -_twice(ssqrt_bwd(g_cost, q2), sint_s))
    g_ratio = g_sint * sq
    g_cosi = g_aci * sgn(cosi) - _twice(ssqrt_bwd(g_sint * ratio, q), cosi)
    g_etai = g_etai + g_ratio / etat
    g_etat = g_etat - g_ratio * (ratio / etat)
    live = ~is_conductor(mtype) & ~tir
    g_dt = mask((dt >= -1.0) & (dt <= 1.0), g_cosi)
    return (mask(live, torch.where(outside, g_etat, g_etai)),
            tuple(mask(live, x) for x in _scale(nrm, g_dt)),
            tuple(mask(live, x) for x in _scale(inc, g_dt)))


def refract_bwd(ior, inc, nrm, g):
    """megakernel_ref.refract backward: (g_ior, g_inc, g_nrm); a block that
    total internal reflection (the zero vector) skips."""
    dt = _dot(inc, nrm)
    cosi = torch.clamp(dt, -1.0, 1.0)
    entering = cosi < 0.0
    etai = torch.where(entering, 1.0, ior)
    etat = torch.where(entering, ior, 1.0)
    n = _where3(entering, nrm, _neg(nrm))
    ci = torch.abs(cosi)
    eta = etai / etat
    b = 1.0 - ci * ci
    e2 = eta * eta
    k = 1.0 - e2 * b
    ok = k >= 0.0
    ks = torch.where(ok, k, 1.0)
    coef = eta * ci - _sqrt(torch.clamp_min(ks, 1e-12))
    g_coef = _sum3(g, n)
    g_k = ssqrt_bwd(-g_coef, ks)
    g_eta = (_sum3(g, inc) + g_coef * ci) + _twice(-g_k * b, eta)
    g_ci = g_coef * eta + _twice(-(-g_k * e2), ci)
    g_dt = mask((dt >= -1.0) & (dt <= 1.0), g_ci * sgn(cosi))
    g_ior = torch.where(entering, -g_eta * (eta / etat), g_eta / etat)
    g_inc = tuple(g[j] * eta + g_dt * nrm[j] for j in range(3))
    g_nrm = tuple(torch.where(entering, g[j] * coef, -(g[j] * coef)) + g_dt * inc[j]
                  for j in range(3))
    return mask(ok, g_ior), tuple(mask(ok, x) for x in g_inc), tuple(mask(ok, x) for x in g_nrm)


# ---------------------------------------------------------------------------
# the microfacet terms, the BSDF and its pdf
# ---------------------------------------------------------------------------


def d_ggx_bwd(h, n, alpha, g):
    """megakernel_ref.d_ggx backward: (g_h, g_n, g_alpha)."""
    dh = _dot(n, h)
    noh = torch.abs(dh)
    good = noh > EPSILON
    ns = torch.where(good, noh, 1.0)
    n2 = ns * ns
    tan2 = (1.0 - n2) / n2
    at = alpha + tan2
    den0 = n2 * at
    nz = torch.abs(den0) > 0.0
    den = torch.where(nz, den0, 1.0)
    pd = PI * den
    pdd = pd * den
    d = alpha * alpha / pdd
    gd = mask(good, g)
    g_aa = gd / pdd
    g_pdd = -gd * (d / pdd)
    g_den0 = mask(nz, g_pdd * pd + (g_pdd * den) * PI)
    g_at = g_den0 * n2
    g_n2 = g_den0 * at - g_at / n2 - g_at * (tan2 / n2)
    g_dh = mask(good, _twice(g_n2, ns)) * sgn(dh)
    return _scale(n, g_dh), _scale(h, g_dh), g_at + _twice(g_aa, alpha)


def g1_bwd(v, n, alpha, g):
    """megakernel_ref.g1 backward: (g_v, g_n, g_alpha)."""
    dv = _dot(n, v)
    nov = torch.abs(dv)
    good = nov > EPSILON
    ns = torch.where(good, nov, 1.0)
    q = 1.0 - ns * ns
    sq = _sqrt(torch.clamp_min(q, 1e-12))
    tan_t = sq / ns
    at = alpha * tan_t
    r = 1.0 + at * at
    rc = 1.0 / (1.0 + _sqrt(r))
    g_den = -(mask(good & (tan_t != 0.0), g) * 2.0) * (rc * rc)
    g_at = _twice(dsqrt(g_den, r), at)
    g_tan = g_at * alpha
    g_ns = -g_tan * (tan_t / ns) - _twice(ssqrt_bwd(g_tan / ns, q), ns)
    g_dv = mask(good, g_ns) * sgn(dv)
    return _scale(n, g_dv), _scale(v, g_dv), g_at * tan_t


def eval_bsdf_bwd(mtype, ior, alpha, refl, wi, wo, n, is_reflect, g):
    """megakernel_ref.eval_bsdf backward: (g_ior, g_alpha, g_refl, g_wi,
    g_wo, g_n, the BSDF's value, bitwise eval_bsdf's). A smooth lane takes
    the smooth block (Fresnel at n, or Schlick's for a conductor), a rough
    one the rough block: its lobe (reflection or refraction), then D, G and
    F at the half vector h and h's own reverse."""
    win = _dot(wi, n)
    won = _dot(wo, n)
    ww = win * won
    same = ww > 0.0
    up = win > 0.0
    rc = 1.0 / ior
    eta = torch.where(up, ior, rc)
    nwi = _neg(wi)
    cond = is_conductor(mtype)
    rough = is_rough(mtype)
    hv = _sub(nwi, _scale(wo, eta))
    hs = _add(wi, wo)
    h_s = _scale(hs, 1.0 / _sqrt(torch.clamp_min(_dot(hs, hs), 1e-20)))
    h_t0 = _scale(hv, 1.0 / _sqrt(torch.clamp_min(_dot(hv, hv), 1e-20)))
    flip = _dot(h_t0, n) > 0.0
    h = _where3(is_reflect, _where3(up, h_s, _neg(h_s)), _where3(flip, h_t0, _neg(h_t0)))
    awon = torch.abs(won)

    # the smooth block
    aligned = _dot(h, n) >= ONE_MINUS_EPS
    f_sm = fresnel({"mtype": mtype}, ior, nwi, n)
    f_s = torch.where(is_reflect, torch.where(
        same & aligned, torch.where(cond, fresnel_schlick(awon, refl), f_sm), 0.0), torch.where(
        ~cond & ~same & (ww != 0.0) & aligned, 1.0 - f_sm, 0.0))
    g_sr = mask(is_reflect & same & aligned, g)
    g_st = mask(~is_reflect & ~cond & ~same & (ww != 0.0) & aligned, g)
    g_awon_s, g_refl_s = schlick_bwd(awon, refl, mask(cond, g_sr))
    gi_s, g_nwi_s, g_n_s = fresnel_bwd(mtype, ior, nwi, n, torch.where(cond, 0.0, g_sr) - g_st)
    g_won_s = g_awon_s * sgn(won)

    # the rough block: its lobe
    d_h = d_ggx(h, n, alpha)
    ga = g1(wi, h, alpha)
    gb = g1(wo, h, alpha)
    g_h = ga * gb
    f_h = fresnel({"mtype": mtype}, ior, nwi, h)
    hwo = _dot(h, wo)
    ahwo = torch.abs(hwo)
    f_r = torch.where(cond, fresnel_schlick(ahwo, refl), f_h)
    awin = torch.abs(win)
    a4 = 4.0 * awin
    denom_r = a4 * awon + EPSILON
    rr1 = f_r * d_h
    rr3 = rr1 * g_h / denom_r
    hol = _dot(h, wi)
    hov = _dot(h, wo)
    den_a = hol + eta * hov
    den_b = den_a * den_a
    aww = torch.abs(ww)
    den_c = den_b * aww
    den = torch.clamp_min(den_c, 1e-10)
    omf = 1.0 - f_h
    t1 = omf * d_h
    t2 = t1 * g_h
    t3 = t2 * eta
    t4 = t3 * eta
    hh = hol * hov
    ahh = torch.abs(hh)
    t6 = t4 * ahh / den
    # reflection: f_r·D·G/(4|wi·n||wo·n| + ε) on the same side
    g_rr3 = mask(same, g)
    g_rr2 = g_rr3 / denom_r
    g_denr = -g_rr3 * (rr3 / denom_r)
    g_rr1 = g_rr2 * g_h
    g_fr = g_rr1 * d_h
    g_ahwo, g_refl_r = schlick_bwd(ahwo, refl, mask(cond, g_fr))
    # refraction: (1 − F)·D·G·eta²|h·wi h·wo| / ((h·wi + eta h·wo)² |wi·n wo·n|)
    g_t6 = mask(~(cond | same | (ww == 0.0)), g)
    g_t5 = g_t6 / den
    g_den_c = mask(den_c >= 1e-10, -g_t6 * (t6 / den))
    g_t4 = g_t5 * ahh
    g_hh = (g_t5 * t4) * sgn(hh)
    g_t3 = g_t4 * eta
    g_t2 = g_t3 * eta
    g_t1 = g_t2 * g_h
    g_den_a = _twice(g_den_c * aww, den_a)
    lobe = lambda r, t: torch.where(is_reflect, r, t)  # noqa: E731
    g_gh = lobe(g_rr2 * rr1, g_t2 * t1)
    g_dh = lobe(g_rr1 * f_r, g_t1 * omf)
    g_fh = lobe(torch.where(cond, 0.0, g_fr), -(g_t1 * d_h))
    g_awon = mask(is_reflect, g_denr * a4)
    g_awin = mask(is_reflect, (g_denr * awon) * 4.0)
    g_hwo = mask(is_reflect, g_ahwo * sgn(hwo))
    g_refl = mask(is_reflect, g_refl_r)
    g_hol = lobe(0.0, g_hh * hov + g_den_a)
    g_hov = lobe(0.0, g_hh * hol + g_den_a * eta)
    g_eta = lobe(0.0, (g_t4 * t3 + g_t3 * t2) + g_den_a * hov)
    g_ww = lobe(0.0, (g_den_c * den_b) * sgn(ww))
    # F, G and D at h
    gi, g_nwi, g_hvec = fresnel_bwd(mtype, ior, nwi, h, g_fh)
    g_wi, g_hx, g_al = g1_bwd(wi, h, alpha, g_gh * gb)
    g_wo, g_hy, g_al2 = g1_bwd(wo, h, alpha, g_gh * ga)
    g_hz, g_nd, g_al3 = d_ggx_bwd(h, n, alpha, g_dh)
    g_hvec = _acc(_acc(_acc(g_hvec, g_hx), g_hy), g_hz)
    g_hvec = tuple(g_hvec[k] + ((g_hol * wi[k] + g_hov * wo[k]) + g_hwo * wo[k])
                   for k in range(3))
    # h: ±normalize(wi + wo) for reflection, ±normalize(-wi - eta·wo) else
    g_hs = tuple(mask(is_reflect, x) for x in normalize_bwd(
        hs, tuple(torch.where(up, g_hvec[k], -g_hvec[k]) for k in range(3))))
    g_hv = tuple(mask(~is_reflect, x) for x in normalize_bwd(
        hv, tuple(torch.where(flip, g_hvec[k], -g_hvec[k]) for k in range(3))))
    g_nwi = _acc(g_nwi, g_hv)
    g_eta = g_eta - _sum3(g_hv, wo)
    g_win = g_ww * won + g_awin * sgn(win)
    g_won = g_ww * win + g_awon * sgn(won)
    g_ior = gi + torch.where(up, g_eta, -torch.where(up, 0.0, g_eta) * (rc * rc))
    g_wi = tuple(((g_wi[k] + g_hol * h[k] + g_hs[k]) - g_nwi[k]) + g_win * n[k]
                 for k in range(3))
    g_wo = tuple(((g_wo[k] + (g_hov * h[k] + g_hwo * h[k]) + g_hs[k]) - g_hv[k] * eta)
                 + g_won * n[k] for k in range(3))
    g_n = tuple(g_nd[k] + (g_win * wi[k] + g_won * wo[k]) for k in range(3))

    def pick(r, s_):
        return torch.where(rough, r, s_)

    return (pick(g_ior, gi_s), pick((g_al + g_al2) + g_al3, 0.0), pick(g_refl, g_refl_s),
            tuple(pick(g_wi[k], -g_nwi_s[k]) for k in range(3)),
            tuple(pick(g_wo[k], g_won_s * n[k]) for k in range(3)),
            tuple(pick(g_n[k], g_n_s[k] + g_won_s * wo[k]) for k in range(3)),
            pick(torch.where(is_reflect, torch.where(same, rr3, 0.0),
                             torch.where(cond | same | (ww == 0.0), 0.0, t6)), f_s))


def pdf_bwd(mtype, ior, alpha, wi, wo, n, is_reflect, g):
    """megakernel_ref.pdf backward: (g_ior, g_alpha, g_wi, g_wo, g_n). A
    smooth lane's pdf is a constant; a rough one's D(h)·(n·h)·jacobian runs
    back through D and its lobe's jacobian and half vector."""
    up = _dot(wi, n) > 0.0
    rc = 1.0 / ior
    eta = torch.where(up, ior, rc)
    hs = _add(wi, wo)
    h_s = _scale(hs, 1.0 / _sqrt(torch.clamp_min(_dot(hs, hs), 1e-20)))
    h_r = _where3(up, h_s, _neg(h_s))
    hrwo = _dot(h_r, wo)
    jr0 = 4.0 * torch.abs(hrwo)
    jac_r = 1.0 / torch.clamp_min(jr0, 1e-8)
    hv = _sub(_neg(wi), _scale(wo, eta))
    dd = _dot(hv, hv)
    h_t = _scale(hv, 1.0 / _sqrt(torch.clamp_min(dd, 1e-20)))
    d1 = torch.clamp_min(dd, 1e-12)
    htwo = _dot(h_t, wo)
    jt1 = eta * eta
    jac_t = jt1 * torch.abs(htwo) / d1
    h = _where3(is_reflect, h_r, h_t)
    jac = torch.where(is_reflect, jac_r, jac_t)
    d = d_ggx(h, n, alpha)
    nh = _dot(n, h)
    g_p1 = g * jac
    g_jac = g * (d * nh)
    g_nh = g_p1 * d
    g_h, g_n, g_alpha = d_ggx_bwd(h, n, alpha, g_p1 * nh)
    g_h = tuple(g_h[k] + g_nh * n[k] for k in range(3))
    g_n = tuple(g_n[k] + g_nh * h[k] for k in range(3))
    # reflection: the jacobian 1/(4|h·wo|), h = ±normalize(wi + wo)
    g_jr0 = mask(jr0 >= 1e-8, -g_jac * (jac_r * jac_r))
    g_hrwo = (g_jr0 * 4.0) * sgn(hrwo)
    g_hr = tuple(g_h[k] + g_hrwo * wo[k] for k in range(3))
    g_hs = normalize_bwd(hs, tuple(torch.where(up, g_hr[k], -g_hr[k]) for k in range(3)))
    # refraction: the jacobian eta²|h·wo|/|hv|², h = normalize(hv)
    g_jt2 = g_jac / d1
    g_d1 = -g_jac * (jac_t / d1)
    g_htwo = (g_jt2 * jt1) * sgn(htwo)
    g_hv = normalize_bwd(hv, tuple(g_h[k] + g_htwo * wo[k] for k in range(3)))
    g_dd = mask(dd >= 1e-12, g_d1)
    g_hv = tuple(g_hv[k] + _twice(g_dd, hv[k]) for k in range(3))
    g_eta = _twice(g_jt2 * torch.abs(htwo), eta) - _sum3(g_hv, wo)
    rough = is_rough(mtype)

    def pick(r, t):
        return mask(rough, torch.where(is_reflect, r, t))

    return (pick(0.0, torch.where(up, g_eta, -torch.where(up, 0.0, g_eta) * (rc * rc))),
            mask(rough, g_alpha), tuple(pick(g_hs[k], -g_hv[k]) for k in range(3)),
            tuple(pick(g_hs[k] + g_hrwo * h_r[k], g_htwo * h_t[k] - g_hv[k] * eta)
                  for k in range(3)),
            tuple(mask(rough, x) for x in g_n))
