"""Plain PyTorch version of the path-regeneration megakernel.

Counterpart of `mcpt_tpu/kernels/megakernel.py` (`_mega_kernel_regen`, its
SMEM brute-force sweeps and the per-vertex shading helpers), with the env
lookup of `mcpt_tpu/envmap.py` in place of its TPU mip, and BVH walks over
child-pair rows (near-first for the nearest hit, one shared walk per shadow
fan) in place of the clustered walks of `mcpt_tpu/kernels/cluster.py`.
Every function keeps the JAX helper's name without the leading underscore and
computes the same float32 expressions in the same order, so a CUDA tensor run
through this module and through `csrc/megakernel.cu` agree to the bit except
where `sin`/`cos` round differently. Vectors are 3-tuples of same-shape
tensors (any leading shape, e.g. (lanes,) or (8, 128)); primitives become a
trailing tensor dimension.

Randomness: the only random numbers are the counter hash `murmur`, keyed on
(pixel, sample) for camera draws and (lane, sample, depth, use-site) for path
draws, plus an explicit integer `seed`. No `torch.Generator` is involved, so
the draws are those of the JAX kernel bit for bit, on any device. uint32
arithmetic is done in int64 tensors masked to 32 bits.

No autograd: everything here is the forward render.
"""

import math

import numpy as np
import torch

from mcpt_tpu_torch.constants import (
    BVH_STACK,
    CLAMP_DIRECT,
    CLAMP_INDIRECT,
    DEEP_RUN,
    DEEP_TIER,
    EPSILON,
    REL_EPS,
    T_MAX,
    WAVELEN_UM,
)
from mcpt_tpu_torch.envmap import sample_env_chan

T_MAX_F = float(T_MAX)


def _tally(ops, key, n):
    """Add n to ops[key] when the caller asked for a tally (`ops` a
    `collections.Counter`, see `trace_block_ref`)."""
    if ops is not None:
        ops[key] += int(n)
# Forward-fold constants (megakernel.py:90-91): identity map C and W cap.
FOLD_BIG = 1.0e30
FOLD_W_CAP = 1.0e30
MAX_BOUNCES_LIMIT = 32  # the JAX kernel packs the depth into 5 bits
TWO_PI = 2.0 * math.pi  # rounded to float32 once, like the JAX constant fold
ONE_MINUS_EPS = 1.0 - EPSILON

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Counter-based RNG (megakernel.py:138-158) in int64 masked to uint32
# ---------------------------------------------------------------------------


def mul32(x, k: int):
    """(x * k) mod 2^32 for int64 x in [0, 2^32) and a uint32 constant k,
    split in 16-bit halves so no intermediate leaves the int64 range."""
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def murmur(x):
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def unit(x):
    """uint32 bits -> float32 in [0, 1): the top 24 bits, exactly."""
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def draw(key, ctr):
    """One uniform per lane: `key` the per-lane uint32 id, `ctr` a uint32
    (int or tensor) folding the rest of the counter."""
    return unit(murmur((mul32(key, 0x9E3779B1) + ctr) & _M32))


def cam_key(pix_u, s_act, seed: int, c: int):
    """Camera draw `c` of sample `s_act` at pixel `pix_u`
    (megakernel.py:2027-2034)."""
    mix = (mul32(s_act, 0x0ED5AD4D) + mul32_int(seed, 0x01000193)) & _M32
    return (mul32(pix_u, 0x9E3779B1) + mix + c) & _M32


def path_key_base(lane_u, s_act, d_lane, seed: int):
    """The use-independent part of a path draw's counter
    (megakernel.py:2217-2225); `path_draw` adds the use-site term."""
    return (
        mul32(lane_u, 0x9E3779B1)
        + mul32(s_act, 0x0ED5AD4D)
        + mul32(d_lane, 0x9E3779B9)
        + mul32_int(seed, 0x01000193)
    ) & _M32


def path_draw(base, use: int):
    return unit(murmur((base + ((use * 0x632BE59B) & _M32)) & _M32))


def mul32_int(x: int, k: int) -> int:
    return ((x & _M32) * k) & _M32


def lockstep_sample_key(s: int, seed: int) -> int:
    """The lockstep kernel's per-sample counter base su (megakernel.py:1700);
    its camera draw c is `draw(pixel, murmur(su + 101 + c))`
    (:1704-1711)."""
    return (0x9E3779B9 * (s + 1) + seed) & _M32


def lockstep_depth_key(su: int, depth: int) -> int:
    """The lockstep kernel's per-depth base du (megakernel.py:1759): vertex
    draw `use` is `draw(lane, du + use)` (:1766)."""
    return murmur((su + depth * 0x85EBCA77) & _M32)


# ---------------------------------------------------------------------------
# Vector helpers (3-tuples of tensors)
# ---------------------------------------------------------------------------


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _neg(a):
    return (-a[0], -a[1], -a[2])


def _where3(c, a, b):
    return tuple(torch.where(c, a[i], b[i]) for i in range(3))


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def sqrt_f32(x):
    """Correctly rounded float32 sqrt on every device: torch's CPU kernel
    is not (it misses on ~0.7% of inputs), XLA's and CUDA's sqrtf are. The
    float64 sqrt rounded once to float32 is exact (53 >= 2*24 + 2 bits)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


_sqrt = sqrt_f32


def _normalize(a):
    # 1/sqrt, correctly rounded (the JAX kernel's rsqrt is within ~1 ULP)
    inv = 1.0 / _sqrt(torch.clamp_min(_dot(a, a), 1e-20))
    return _scale(a, inv)


def _ssqrt(x):
    return _sqrt(torch.clamp_min(x, 1e-12))


def _reflect(wo, n):
    s = 2.0 * _dot(wo, n)
    return _sub(_scale(n, s), wo)


def _pick3(chan, a, b, c):
    """Per-lane channel pick of three scalars/tensors (R, G, B)."""
    return torch.where(chan == 0, a, torch.where(chan == 1, b, c))


# ---------------------------------------------------------------------------
# Lanes and the camera
# ---------------------------------------------------------------------------


def lane_to_pixel(lane, width: int):
    """(lane) -> (pixel id, channel, fi, fj, lane, stream), untiled
    (megakernel.py:279-303): the lane IS pixel*3 + channel."""
    pix = lane // 3
    chan = lane - pix * 3
    fi = (pix % width).to(torch.float32)
    fj = (pix // width).to(torch.float32)
    return pix, chan, fi, fj, lane, torch.zeros_like(pix)


def cam_static(camera) -> dict:
    """Static camera floats (megakernel.py:2880-2895): folded in Python
    double and rounded to float32 once where the kernel uses them."""
    om = camera.orientation()
    return {
        "width": camera.width,
        "height": camera.height,
        "xscale": float(
            np.tan(np.deg2rad(camera.fov * 0.5)) * camera.width / camera.height
        ),
        "yscale": float(np.tan(np.deg2rad(camera.fov * 0.5))),
        "om": tuple(tuple(float(om[i, j]) for j in range(3)) for i in range(3)),
        "pos": tuple(float(v) for v in camera.position),
        "use_dof": bool(camera.use_dof),
        "focal": float(camera.focal_distance),
        "aperture": float(camera.aperture_radius),
    }


def _rot(om, v):
    return tuple(om[i][0] * v[0] + om[i][1] * v[1] + om[i][2] * v[2] for i in range(3))


def cam_ray(cam, seed: int, pix_u, fi, fj, s_act):
    """Camera ray of sample `s_act` (megakernel.py:2021-2062,
    Renderer.cpp:44-76); the three channel lanes of a pixel share it."""
    return cam_ray_from(
        cam, fi, fj, lambda c: unit(murmur(cam_key(pix_u, s_act, seed, 0x51ED2701 + c)))
    )


def cam_ray_from(cam, fi, fj, u):
    """The camera ray of pixels (fi, fj) from the sample's draws `u(c)`: 0
    and 1 place it in the pixel, 2 and 3 on the lens (drawn only with DoF
    on)."""
    u0 = u(0)
    u1 = u(1)
    # true division by tensors: CUDA torch turns division by a Python scalar
    # into multiplication by its reciprocal, which rounds differently
    x = (1.0 - 2.0 * (fi + u0) / torch.full_like(fi, cam["width"])) * cam["xscale"]
    y = (1.0 - 2.0 * (fj + u1) / torch.full_like(fj, cam["height"])) * cam["yscale"]
    one = torch.ones_like(x)
    if cam["use_dof"]:
        u2 = u(2)
        u3 = u(3)
        r = cam["aperture"] * _sqrt(u2)
        theta = TWO_PI * u3
        dx = r * torch.cos(theta)
        dy = r * torch.sin(theta)
        lens_w = _rot(cam["om"], (dx, dy, torch.zeros_like(dx)))
        o = tuple(cam["pos"][k] + lens_w[k] for k in range(3))
        fd = cam["focal"]
        dirs = (x * fd - dx, y * fd - dy, one * fd)
    else:
        o = tuple(torch.full_like(x, cam["pos"][k]) for k in range(3))
        dirs = (x, y, one)
    return o, _rot(cam["om"], _normalize(dirs))


# ---------------------------------------------------------------------------
# Brute-force sweeps (megakernel.py:323-863), primitives on the last axis
# ---------------------------------------------------------------------------


def _col(table, c):
    return table[..., c]


def _woop(w, o, d):
    """(t_cand, u, v) of the Woop test (megakernel.py:343-381) for rays
    (o, d) against triangle columns `w` (13 tensors broadcastable with the
    ray components); pad rows carry nr2 = 0 and fail |det| >= ε."""
    o0, o1, o2 = o
    d0, d1, d2 = d
    dp2 = d0 * w[6] + d1 * w[7] + d2 * w[8]
    op2 = o0 * w[6] + o1 * w[7] + o2 * w[8] - w[11]
    det = -(dp2 * w[12])
    okd = torch.abs(det) >= EPSILON
    det_g = torch.where(okd, det, 1.0)
    t_hit = op2 * w[12] / det_g
    dp0 = d0 * w[0] + d1 * w[1] + d2 * w[2]
    op0 = o0 * w[0] + o1 * w[1] + o2 * w[2] - w[9]
    u = op0 + t_hit * dp0
    dp1 = d0 * w[3] + d1 * w[4] + d2 * w[5]
    op1 = o0 * w[3] + o1 * w[4] + o2 * w[5] - w[10]
    v = op1 + t_hit * dp1
    m = torch.minimum(
        torch.minimum(u, v),
        torch.minimum(
            torch.minimum(1.0 - (u + v), t_hit), torch.abs(det) - EPSILON
        ),
    )
    return torch.where(m >= 0.0, t_hit, T_MAX_F), u, v


def _tri_candidates(tri, o, d):
    """Per-(ray, triangle) (t_cand, u, v) over the whole table."""
    return _woop(
        [_col(tri, c) for c in range(13)],
        tuple(x[..., None] for x in o),
        tuple(x[..., None] for x in d),
    )


def sph_roots(a, bq, cq, r):
    """The sphere hit t (T_MAX on a miss) from the quadratic a·t² + bq·t +
    cq of a ray against a sphere of radius r, with the stable q-form roots
    q/a and cq/q (global.hpp:20-35); a ray with a = |d|² <= 1e-12 misses."""
    a_ok = a > 1e-12
    a_safe = torch.clamp_min(a, 1e-12)
    disc = bq * bq - 4.0 * a_safe * cq
    ok = (disc >= 0.0) & a_ok & (r > 0.0)
    sq = _sqrt(torch.clamp_min(disc, 0.0))
    q = torch.where(bq > 0.0, -0.5 * (bq + sq), -0.5 * (bq - sq))
    qs = torch.where(torch.abs(q) > 1e-10, q, 1.0)
    x0 = q / a_safe
    x1 = cq / qs
    lo = torch.minimum(x0, x1)
    hi = torch.maximum(x0, x1)
    t = torch.where(lo < 0.0, hi, lo)
    ok = ok & (t >= 0.0)
    return torch.where(ok, t, T_MAX_F)


def _sph_candidates(sph, o, d):
    """Per-(ray, sphere) t with the q-form roots, general a
    (megakernel.py:383-404)."""
    o0, o1, o2 = (x[..., None] for x in o)
    d0, d1, d2 = (x[..., None] for x in d)
    a = d0 * d0 + d1 * d1 + d2 * d2
    cx, cy, cz, r = (_col(sph, c) for c in range(4))
    l0 = o0 - cx
    l1 = o1 - cy
    l2 = o2 - cz
    bq = 2.0 * (d0 * l0 + d1 * l1 + d2 * l2)
    cq = l0 * l0 + l1 * l1 + l2 * l2 - r * r
    return sph_roots(a, bq, cq, r)


def _take(x, idx):
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _surface(tri, sph, o, d, t_best, ti, si, uw, vw, textured):
    """The hit record of a nearest-hit winner: triangle row `ti` (with its
    barycentrics uw, vw) where ti >= 0, else sphere `si` where si >= 0, else
    a miss (megakernel.py:420-471)."""
    happened = t_best < T_MAX_F
    is_tri = happened & (ti >= 0)
    is_sph = happened & (si >= 0) & ~is_tri
    ti = ti.clamp(min=0)
    si = si.clamp(min=0)
    zero = torch.zeros_like(t_best)

    def tri_col(c):
        return torch.where(is_tri, tri[ti, c], zero)

    def sph_col(c):
        return torch.where(is_sph, sph[si, c], zero)

    if textured:
        w0 = 1.0 - uw - vw
        uvx = w0 * tri[ti, 17] + uw * tri[ti, 19] + vw * tri[ti, 21]
        uvy = w0 * tri[ti, 18] + uw * tri[ti, 20] + vw * tri[ti, 22]
        uv = (torch.where(is_tri, uvx, zero), torch.where(is_tri, uvy, zero))
    else:
        uv = (zero, zero)
    mat = tri_col(23) + sph_col(4)
    em = tri_col(24) + sph_col(5)
    t_eff = torch.where(happened, t_best, 0.0)
    p = tuple(o[k] + d[k] * t_eff for k in range(3))
    nsph = _normalize(tuple(p[k] - sph_col(k) for k in range(3)))
    n = tuple(torch.where(is_sph, nsph[k], tri_col(14 + k)) for k in range(3))
    return t_best, happened, p, n, uv, mat, em > 0.5


def intersect_tile(tri, sph, o, d, occlusion=False, textured=True):
    """Nearest hit of each ray against every triangle, then every sphere,
    with the strict-`<` table-order winner of megakernel.py:420-471 (the
    first minimum wins). Returns t only (occlusion=True) or
    (t, happened, p, n, (uvx, uvy), mat, emissive)."""
    t_tri, u, v = _tri_candidates(tri, o, d)
    t_sph = _sph_candidates(sph, o, d)
    t_all = torch.cat([t_tri, t_sph], dim=-1)
    if occlusion:
        return t_all.min(dim=-1).values
    n_t = tri.shape[0]
    idx = torch.argmin(t_all, dim=-1)
    t_best = _take(t_all, idx)
    ti = torch.where(idx < n_t, idx, -1)
    si = torch.where(idx >= n_t, idx - n_t, -1)
    tc = ti.clamp(min=0)
    return _surface(tri, sph, o, d, t_best, ti, si, _take(u, tc), _take(v, tc), textured)


def _fan_xs(dist):
    return dist - torch.clamp_min(REL_EPS * dist, EPSILON)


def _tri_blocks(w, op0, op1, q, e, xs):
    """The division-free blocked-visibility predicate of the shadow fan
    (megakernel.py:487-591): every Möller-Trumbore condition multiplied
    through by |det|, blocking at t < xs. `op0`, `op1`, `q` are the
    origin's terms against the triangle columns `w`."""
    e0, e1, e2 = e
    dp2 = e0 * w[6] + e1 * w[7] + e2 * w[8]
    det = -(dp2 * w[12])
    dets = torch.abs(det)
    qs = torch.where(det < 0.0, -q, q)
    dp0 = e0 * w[0] + e1 * w[1] + e2 * w[2]
    u_s = op0 * dets + qs * dp0
    dp1 = e0 * w[3] + e1 * w[4] + e2 * w[5]
    v_s = op1 * dets + qs * dp1
    m = torch.minimum(
        torch.minimum(qs, dets - EPSILON),
        torch.minimum(torch.minimum(u_s, v_s), dets - (u_s + v_s)),
    )
    return (m >= 0.0) & (xs * dets - qs > 0.0)


def _origin_terms(w, o):
    o0, o1, o2 = o
    op2 = o0 * w[6] + o1 * w[7] + o2 * w[8] - w[11]
    op0 = o0 * w[0] + o1 * w[1] + o2 * w[2] - w[9]
    op1 = o0 * w[3] + o1 * w[4] + o2 * w[5] - w[10]
    return op0, op1, op2 * w[12]


def _sph_blocks(sph, o, e, xs):
    """Per ray: does any sphere block the unit ray (o, e) before xs (the
    a = 1 q-form roots)?"""
    o0, o1, o2 = (x[..., None] for x in o)
    e0, e1, e2 = (x[..., None] for x in e)
    cx, cy, cz, r = (_col(sph, c) for c in range(4))
    l0 = o0 - cx
    l1 = o1 - cy
    l2 = o2 - cz
    cq = l0 * l0 + l1 * l1 + l2 * l2 - r * r
    hb = e0 * l0 + e1 * l1 + e2 * l2
    disc = hb * hb - cq
    ok = (disc >= 0.0) & (r > 0.0)
    sq = _sqrt(torch.clamp_min(disc, 0.0))
    qq = torch.where(hb > 0.0, -(hb + sq), -(hb - sq))
    qs_ = torch.where(torch.abs(qq) > 1e-10, qq, 1.0)
    x1 = cq / qs_
    lo = torch.minimum(qq, x1)
    hi = torch.maximum(qq, x1)
    t = torch.where(lo < 0.0, hi, lo)
    return (ok & (t >= 0.0) & (t < xs[..., None])).any(dim=-1)


def occlude_shared_origin(occ, sph, o, ds, dists):
    """Visibility of S shadow rays sharing origin `o` (the NEE fan,
    megakernel.py:487-591): True when no primitive blocks the ray at
    t < dist − max(ε, REL_EPS·dist)."""
    w = [_col(occ, c) for c in range(13)]
    op0, op1, q = _origin_terms(w, tuple(x[..., None] for x in o))
    vis = []
    for e, dist in zip(ds, dists):
        xs = _fan_xs(dist)
        blocked = _tri_blocks(
            w, op0, op1, q, tuple(x[..., None] for x in e), xs[..., None]
        ).any(dim=-1)
        vis.append(~(blocked | _sph_blocks(sph, o, e, xs)))
    return vis


def fan_and_nearest(tri, occ, sph, fans, nexts, textured=True):
    """The fused sweep of megakernel.py:594-863: per slot, the shadow fan
    over the occluder table `occ` and the next ray's nearest hit over the
    full triangle table `tri`. Returns (vis_per_slot, hit_per_slot)."""
    vis_out, hit_out = [], []
    for (o_f, ds, dists), (o, d) in zip(fans, nexts):
        vis_out.append(occlude_shared_origin(occ, sph, o_f, ds, dists))
        hit_out.append(intersect_tile(tri, sph, o, d, textured=textured))
    return vis_out, hit_out


# ---------------------------------------------------------------------------
# The BVH walks (replacing mcpt_tpu/kernels/cluster.py:257, 547, 835 for
# scenes over 1024 triangles) over the child-pair rows of
# `tables.bvh_tables`, vectorized over the rays still walking. A walk's item
# is a row (an interior node: both child boxes are tested, one child taken,
# the other pushed onto a per-ray stack) or a leaf (its triangles are
# tested, then the stack is popped); each step takes one item per ray. The
# kernel takes the same items in the same order (csrc/mega_common.cuh
# `nearest_bvh`, `occlude_fan_bvh`: a thread descends rows until it holds a
# leaf, then its warp tests leaves). Triangles use the brute sweep's tests;
# spheres are tested by brute force after the walk, as the cluster kernels
# do (cluster.py:18).
# ---------------------------------------------------------------------------


def _slab(box, o, inv):
    """Entry and exit t of rays (o, 1/d) through boxes min(3) max(3) (k, 6);
    fmin / fmax drop the NaN of 0·inf like CUDA's fminf / fmaxf."""
    ta = [(box[:, k] - o[k]) * inv[k] for k in range(3)]
    tb = [(box[:, 3 + k] - o[k]) * inv[k] for k in range(3)]
    tmin = torch.fmax(
        torch.fmax(torch.fmin(ta[0], tb[0]), torch.fmin(ta[1], tb[1])),
        torch.fmin(ta[2], tb[2]),
    )
    tmax = torch.fmin(
        torch.fmin(torch.fmax(ta[0], tb[0]), torch.fmax(ta[1], tb[1])),
        torch.fmax(ta[2], tb[2]),
    )
    return tmin, tmax


def _passes(tmin, tmax):
    """Does the ray pass through the box (before the bound, which the
    walks test apart: `tmin - EPSILON <= bound`)?"""
    return (tmin - EPSILON <= tmax) & (tmax >= -EPSILON)


class _Walk:
    """The rays of one walk: `lanes` (ray ids), each at its item (`link`,
    `cnt`: a row when cnt is 0, else a leaf of cnt `leaf_tri` rows) with a
    `key` (the entry t of a nearest walk, or the ray mask of a fan walk) and
    a stack of (link, cnt, key) entries, BVH_STACK of them or, for a tree of
    more levels, one a level (`tables.bvh_depth`: the kernels' deep
    instances). Each row a ray loads counts one under `row` in `ops`, and
    `stack` keeps the most entries a ray's stack has held (its high-water
    mark, not a sum). With `tiered`, a deep tree's walk also tallies what
    K3's deep walk's two-tier stack (csrc/deep_stack.cuh) moves between its
    shared-memory tier of DEEP_TIER entries and device memory, DEEP_RUN
    entries at a time: entries written out under `spill`, entries read
    back under `fill`. Per ray, `lo` counts the entries below the tier.
    (The megakernels' deep instances keep every entry in device memory.)"""

    def __init__(self, tables, live, key, ops=None, tiered=False):
        self.nodes = tables.bvh
        self.links = tables.bvh.view(torch.int32)[:, 12:16].to(torch.int64)
        self.leaf = tables.leaf_tri
        n, dev = live.shape[0], live.device
        self.lanes = torch.nonzero(live).flatten()
        self.link = torch.zeros_like(self.lanes)  # row 0, the root's
        self.cnt = torch.zeros_like(self.lanes)
        self.key = key[self.lanes]
        depth = max(BVH_STACK, tables.bvh_depth)
        self.stack = [torch.zeros((n, depth), dtype=t.dtype, device=dev)
                      for t in (self.link, self.cnt, key)]
        self.sp = torch.zeros(n, dtype=torch.int64, device=dev)
        self.tiered = tiered and ops is not None and tables.bvh_depth > BVH_STACK
        if self.tiered:
            self.lo = torch.zeros_like(self.sp)
        self.max_leaf = int(self.links[:, 1::2].max().clamp(min=0).item())
        self.ops = ops

    def children(self, at):
        """The two children of the rows of walking rays `at` (a mask): per
        child its box (k, 6), link, count, and whether it is not empty."""
        rows = self.link[at]
        _tally(self.ops, "row", rows.numel())
        r, lk = self.nodes[rows], self.links[rows]
        return [(r[:, 6 * c: 6 * c + 6], lk[:, 2 * c], lk[:, 2 * c + 1],
                 (lk[:, 2 * c + 1] > 0) | (lk[:, 2 * c] > 0)) for c in (0, 1)]

    def leaf_rows(self, at):
        """Per slot j < max_leaf: (mask into `at`'s rays whose leaf has a
        j-th row, those rows of `leaf_tri`)."""
        link, cnt = self.link[at], self.cnt[at]
        for j in range(self.max_leaf):
            m = j < cnt
            if bool(m.any()):
                yield m, link[m] + j

    def push(self, at, link, cnt, key):
        """Push (link, cnt, key) for the walking rays `at` (a mask)."""
        lanes = self.lanes[at]
        sp = self.sp[lanes]
        for st, v in zip(self.stack, (link, cnt, key)):
            st[lanes, sp] = v
        self.sp[lanes] = sp + 1
        if self.ops is not None and lanes.numel():
            self.ops["stack"] = max(self.ops["stack"], int(sp.max()) + 1)
        if self.tiered:  # a full tier sends its oldest run out
            lo = self.lo[lanes]
            full = sp == lo + DEEP_TIER
            _tally(self.ops, "spill", DEEP_RUN * int(full.sum()))
            self.lo[lanes] = torch.where(full, lo + DEEP_RUN, lo)

    def take(self, at, link, cnt, key):
        """Walking rays `at` (a mask) go on to item (link, cnt) with `key`."""
        self.link[at], self.cnt[at], self.key[at] = link, cnt, key

    def pop(self, at, accept):
        """The walking rays `at` (a mask) pop entries until one passes
        `accept(lanes, key)` -> (ok, key), and go on to it; returns the mask
        of those whose stack ran out."""
        out = torch.zeros_like(at)
        need = at.clone()
        while bool(need.any()):
            idx = torch.nonzero(need).flatten()
            lanes = self.lanes[idx]
            empty = self.sp[lanes] == 0
            out[idx[empty]] = True
            need[idx[empty]] = False
            idx, lanes = idx[~empty], lanes[~empty]
            sp = self.sp[lanes] - 1
            self.sp[lanes] = sp
            if self.tiered:  # an empty tier takes the run below it back
                lo = self.lo[lanes]
                below = sp < lo
                _tally(self.ops, "fill", DEEP_RUN * int(below.sum()))
                self.lo[lanes] = torch.where(below, lo - DEEP_RUN, lo)
            e_link, e_cnt, e_key = (st[lanes, sp] for st in self.stack)
            ok, e_key = accept(lanes, e_key)
            go = idx[ok]
            self.link[go], self.cnt[go], self.key[go] = e_link[ok], e_cnt[ok], e_key[ok]
            need[go] = False
        return out

    def retire(self, done):
        keep = ~done
        self.lanes, self.link, self.cnt, self.key = (
            x[keep] for x in (self.lanes, self.link, self.cnt, self.key))


def _leaf_cols(rows):
    return [rows[:, c] for c in range(13)]


def _within(at, sub):
    """The mask, over all of `at`'s positions, of the positions of `at`
    where `sub` (a mask over `at`'s true positions) holds."""
    out = torch.zeros_like(at)
    out[at] = sub
    return out


def near_first_step(walk, at_leaf, o, inv, best_t, ops=None):
    """One step of a near-first nearest-hit walk after its leaf tests: the
    rays at rows (not `at_leaf`) test both children's boxes, take the one
    entered first (child 0 on equal entry t) and push the other with its
    entry t; a child is entered while its entry t - EPSILON <= `best_t`.
    Rays that tested a leaf, or entered neither child, pop the next entry
    still in reach; those whose stack ran out retire."""
    at_row = ~at_leaf
    lanes = walk.lanes[at_row]
    _tally(ops, "slab", 2 * lanes.numel())
    ol, il, bt = [x[lanes] for x in o], [x[lanes] for x in inv], best_t[lanes]
    kids = []
    for box, link, cnt, full in walk.children(at_row):
        tmin, tmax = _slab(box, ol, il)
        kids.append((tmin, link, cnt, full & _passes(tmin, tmax) & (tmin - EPSILON <= bt)))
    swap = kids[1][0] < kids[0][0]  # child 1 is entered first: it is child a
    ta, la, ca, ea = (torch.where(swap, x1, x0) for x0, x1 in zip(*kids))
    tb, lb, cb, eb = (torch.where(swap, x0, x1) for x0, x1 in zip(*kids))
    walk.push(_within(at_row, ea & eb), lb[ea & eb], cb[ea & eb], tb[ea & eb])
    go = ea | eb
    walk.take(_within(at_row, go), torch.where(ea, la, lb)[go], torch.where(ea, ca, cb)[go],
              torch.where(ea, ta, tb)[go])

    def in_reach(lanes, t_in):
        return t_in - EPSILON <= best_t[lanes], t_in

    walk.retire(walk.pop(at_leaf | _within(at_row, ~go), in_reach))


def bvh_nearest(tables, o, d, live, textured=True, ops=None):
    """Nearest hit through the BVH: the brute sweep's answer, ties included
    (equal t goes to the lower triangle row, triangles beat spheres).

    Near-first: of a row's two children the one the ray enters first is
    taken (child 0 on equal entry t), the other pushed with its entry t. A
    child, or a popped entry, is entered while its entry t - EPSILON <= the
    best t so far: the margin of the brute sweep's box test, which makes the
    answer independent of the order (the winner's boxes are entered by then)."""
    tri, sph = tables.tri, tables.sph
    n = o[0].shape
    dev = tri.device
    best_t = torch.full(n, T_MAX_F, dtype=torch.float32, device=dev)
    best_i = torch.full(n, -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    inv = [1.0 / x for x in d]
    leaf_id = tables.leaf_tri.view(torch.int32)[:, 25].to(torch.int64)
    walk = _Walk(tables, live, torch.zeros_like(best_t), ops)
    while walk.lanes.numel():
        at_leaf = walk.cnt > 0
        for m, rows in walk.leaf_rows(at_leaf):
            ll = walk.lanes[at_leaf][m]
            _tally(ops, "woop", ll.numel())
            t_c, u, v = _woop(_leaf_cols(walk.leaf[rows]), tuple(x[ll] for x in o),
                              tuple(x[ll] for x in d))
            bt, ids = best_t[ll], leaf_id[rows]
            better = (t_c < bt) | ((t_c == bt) & (t_c < T_MAX_F) & (ids < best_i[ll]))
            sel = ll[better]
            best_t[sel] = t_c[better]
            best_i[sel] = ids[better]
            best_u[sel] = u[better]
            best_v[sel] = v[better]
        near_first_step(walk, at_leaf, o, inv, best_t, ops)
    t_sph = _sph_candidates(sph, o, d)
    best_s = torch.full_like(best_i, -1)
    for k in range(sph.shape[0]):
        better = t_sph[..., k] < best_t
        best_t = torch.where(better, t_sph[..., k], best_t)
        best_s = torch.where(better, k, best_s)
    ti = torch.where(best_s >= 0, -1, best_i)
    return _surface(tri, sph, o, d, best_t, ti, best_s, best_u, best_v, textured)


def bvh_fan(tables, o, ds, dists, live, ops=None):
    """Visibility of the shadow fan through the BVH: one walk per origin for
    all its rays (at most 32, which share the origin), then the spheres.
    Each ray keeps the brute fan's predicate over every triangle.

    A walk carries the mask of the rays that entered the current row's box
    and are not yet blocked: a child is entered when any of them passes its
    box before its own bound, with the mask of those that do; a leaf tests
    its rows against them (the origin's terms once a row) and clears the
    rays a row blocks; child 0 is taken, child 1 pushed with its mask; a
    popped entry keeps its rays still open; the walk ends when every ray is
    blocked or the stack runs out. A ray is tested against exactly the
    triangles whose boxes it enters."""
    if len(ds) > 32:
        raise ValueError(f"{len(ds)} rays in one fan walk > 32")
    sph = tables.sph
    xs = [_fan_xs(dist) for dist in dists]
    inv = [[1.0 / x for x in e] for e in ds]
    open_ = torch.where(live, (1 << len(ds)) - 1, 0).to(torch.int64)
    walk = _Walk(tables, live & (open_ != 0), open_, ops)

    def still_open(lanes, m_in):
        m = m_in & open_[lanes]
        return m != 0, m

    while walk.lanes.numel():
        at_leaf = walk.cnt > 0
        for m, rows in walk.leaf_rows(at_leaf):
            ll = walk.lanes[at_leaf][m]
            live_m = walk.key[at_leaf][m] & open_[ll]  # the rays this row still tests
            act = live_m != 0
            ll, rows, live_m = ll[act], rows[act], live_m[act]
            if not ll.numel():
                continue
            w = _leaf_cols(walk.leaf[rows])
            op0, op1, q = _origin_terms(w, tuple(x[ll] for x in o))
            _tally(ops, "fan_origin", ll.numel())
            for si, (e, x) in enumerate(zip(ds, xs)):
                sel = ((live_m >> si) & 1) != 0
                if not bool(sel.any()):
                    continue
                _tally(ops, "fan_tri", sel.sum())
                hit = _tri_blocks([c[sel] for c in w], op0[sel], op1[sel], q[sel],
                                  tuple(c[ll[sel]] for c in e), x[ll[sel]])
                blk = ll[sel][hit]
                open_[blk] = open_[blk] & ~(1 << si)
        at_row = ~at_leaf
        lanes = walk.lanes[at_row]
        mask = walk.key[at_row]
        ol = [x[lanes] for x in o]
        (box0, l0, c0, f0), (box1, l1, c1, f1) = walk.children(at_row)
        m0 = torch.zeros_like(lanes)
        m1 = torch.zeros_like(lanes)
        for si in range(len(ds)):
            sel = ((mask >> si) & 1) != 0
            _tally(ops, "slab", 2 * sel.sum())
            il = [x[lanes] for x in inv[si]]
            for box, full, k in ((box0, f0, 0), (box1, f1, 1)):
                tmin, tmax = _slab(box, ol, il)
                enter = sel & full & _passes(tmin, tmax) & (tmin - EPSILON <= xs[si][lanes])
                bit = enter.to(torch.int64) << si
                if k == 0:
                    m0 = m0 | bit
                else:
                    m1 = m1 | bit
        e0, e1 = m0 != 0, m1 != 0
        walk.push(_within(at_row, e0 & e1), l1[e0 & e1], c1[e0 & e1], m1[e0 & e1])
        go = e0 | e1
        walk.take(_within(at_row, go), torch.where(e0, l0, l1)[go], torch.where(e0, c0, c1)[go],
                  torch.where(e0, m0, m1)[go])
        blocked = open_[walk.lanes] == 0
        done = walk.pop((at_leaf & ~blocked) | _within(at_row, ~go), still_open)
        walk.retire(done | (at_leaf & blocked))
    vis = []
    for si, (e, x) in enumerate(zip(ds, xs)):
        blocked = ((open_ >> si) & 1) == 0
        vis.append(~((live & blocked) | _sph_blocks(sph, o, e, x)))
    return vis


# ---------------------------------------------------------------------------
# Materials and the BSDF (megakernel.py:867-1137)
# ---------------------------------------------------------------------------


# `take_rows`: the lanes a (copy of the table, row) in its backward, and the
# most copies
LANES_PER_COPY = 128
MAX_COPIES = 4096


def gather_mat(mat, mat_id, chan):
    """Per-lane material params with refl/emission channel-picked (ids
    outside the table gather zeros, like the JAX select loop)."""
    rows, ok, _ = mat_rows(mat, mat_id)
    return mat_fields(rows.unbind(-1), ok, chan)


def mat_rows(mat, mat_id):
    """(the rows of `mat` at the float ids `mat_id`, clamped into the table,
    whether each id names a row, the clamped int64 ids)."""
    n_m = mat.shape[0]
    idx = mat_id.to(torch.int64).clamp(0, n_m - 1)
    ok = mat_id == idx.to(torch.float32)
    return take_rows(mat, idx), ok, idx


def mat_fields(cols, ok, chan):
    """`gather_mat`'s fields from a row's columns `cols` (zeros where not
    `ok`), refl and emission picked at `chan`."""
    zero = torch.zeros_like(cols[0])

    def col(c):
        return torch.where(ok, cols[c], zero)

    return {
        "mtype": col(0),
        "ior_a": col(1),
        "ior_b": col(2),
        "rough": col(3),
        "refl": _pick3(chan, col(4), col(5), col(6)),
        "emit": _pick3(chan, col(7), col(8), col(9)),
        "textured": col(10),
        "dirac": col(11),
    }


def take_rows(table, idx):
    """table[idx]: rows of a (rows, cols) table at int64 ids in range (any
    shape), the same gather bit for bit, with a backward that is
    deterministic and parallel. Advanced indexing's CUDA backward sorts the
    lanes by row and sums each row's lanes one after another (seconds for a
    train step's 442,368 lanes over 9 material rows); `F.embedding`'s and
    `index_select`'s are parallel but not deterministic. So lane i reads
    copy i % k of k copies of the table, k chosen for about
    LANES_PER_COPY lanes a (copy, row), and the copies' gradients are summed
    by a reduction."""
    n, r = idx.numel(), table.shape[0]
    k = max(1, min(MAX_COPIES, n // (r * LANES_PER_COPY)))
    if k == 1:
        return table[idx]
    copy = torch.arange(n, device=idx.device).reshape(idx.shape) % k
    return table.repeat(k, 1)[idx + r * copy]


def fold_rows(adj, idx, rows: int):
    """The gradient that `take_rows(table, idx)`'s backward gives `table`
    (`rows` rows) for the per-lane row adjoints `adj` (n, cols): each
    lane's row into copy i % k of k copies, summed per row in sort order
    (`index_put_` with accumulate, deterministic), then over the copies.
    The backward kernels hand their per-lane adjoints to it."""
    n = idx.numel()
    k = max(1, min(MAX_COPIES, n // (rows * LANES_PER_COPY)))
    out = torch.zeros((k * rows, adj.shape[1]), dtype=adj.dtype, device=adj.device)
    at = idx if k == 1 else idx + rows * (torch.arange(n, device=idx.device) % k)
    out.index_put_((at,), adj, accumulate=True)
    return out if k == 1 else out.reshape(k, rows, -1).sum(0)


def is_conductor(mtype):
    return mtype < 1.5


def is_rough(mtype):
    return (torch.abs(mtype - 1.0) < 0.25) | (torch.abs(mtype - 3.0) < 0.25)


def chessboard(u, v):
    """Material.hpp:134-151 with C semantics (trunc toward zero)."""
    col = torch.trunc((u - 0.05) * 10.0)
    row = torch.trunc(v * 12.0)
    in_board = (col >= 3.0) & (col <= 5.0) & (row <= 7.0)
    s = col + row
    is_white = (s - torch.trunc(s * 0.5) * 2.0) == 1.0
    return torch.where(
        in_board & is_white, torch.full_like(u, 0.9), torch.full_like(u, 0.1)
    )


def reflectance(m, uv):
    return torch.where(m["textured"] > 0.5, chessboard(uv[0], uv[1]), m["refl"])


def fresnel_schlick(cos_theta, f0):
    inv = 1.0 - cos_theta
    c2 = inv * inv
    return f0 + (1.0 - f0) * c2 * c2 * inv


def fresnel(m, ior, incident, nrm):
    """Material.hpp:198-226; conductors return 1."""
    cosi = torch.clamp(_dot(incident, nrm), -1.0, 1.0)
    outside = cosi <= 0.0
    etai = torch.where(outside, 1.0, ior)
    etat = torch.where(outside, ior, 1.0)
    sint = etai / etat * _ssqrt(1.0 - cosi * cosi)
    tir = sint >= 1.0
    sint_s = torch.where(tir, 0.0, sint)
    cost = _ssqrt(1.0 - sint_s * sint_s)
    aci = torch.abs(cosi)
    rs_den = torch.clamp_min(etat * aci + etai * cost, 1e-6)
    rp_den = torch.clamp_min(etai * aci + etat * cost, 1e-6)
    rs = (etat * aci - etai * cost) / rs_den
    rp = (etai * aci - etat * cost) / rp_den
    kr = 0.5 * (rs * rs + rp * rp)
    kr = torch.where(tir, 1.0, kr)
    return torch.where(is_conductor(m["mtype"]), 1.0, kr)


def refract(ior, incident, nrm):
    """Material.hpp:227-242; zero vector on TIR."""
    cosi = torch.clamp(_dot(incident, nrm), -1.0, 1.0)
    entering = cosi < 0.0
    etai = torch.where(entering, 1.0, ior)
    etat = torch.where(entering, ior, 1.0)
    n = _where3(entering, nrm, _neg(nrm))
    ci = torch.abs(cosi)
    eta = etai / etat
    k = 1.0 - eta * eta * (1.0 - ci * ci)
    ok = k >= 0.0
    coef = eta * ci - _ssqrt(torch.where(ok, k, 1.0))
    out = _add(_scale(incident, eta), _scale(n, coef))
    zero = torch.zeros_like(out[0])
    return _where3(ok, out, (zero, zero, zero))


def d_ggx(h, n, alpha):
    noh = torch.abs(_dot(n, h))
    good = noh > EPSILON
    noh_s = torch.where(good, noh, 1.0)
    tan2 = (1.0 - noh_s * noh_s) / (noh_s * noh_s)
    denom = (noh_s * noh_s) * (alpha + tan2)
    denom = torch.where(torch.abs(denom) > 0.0, denom, 1.0)
    d = alpha * alpha / (math.pi * denom * denom)
    return torch.where(good, d, 0.0)


def g1(v, n, alpha):
    nov = torch.abs(_dot(n, v))
    good = nov > EPSILON
    nov_s = torch.where(good, nov, 1.0)
    tan_t = _ssqrt(1.0 - nov_s * nov_s) / nov_s
    at = alpha * tan_t
    g = 2.0 / (1.0 + _sqrt(1.0 + at * at))
    g = torch.where(tan_t == 0.0, 1.0, g)
    return torch.where(good, g, 0.0)


def tangent_frame(n):
    nx, ny, nz = n
    ax = torch.abs(nx) > torch.abs(ny)
    lx = _sqrt(torch.clamp_min(nx * nx + nz * nz, 1e-30))
    ly = _sqrt(torch.clamp_min(ny * ny + nz * nz, 1e-30))
    zero = torch.zeros_like(nx)
    tx = _where3(ax, (-nz / lx, zero, nx / lx), (zero, nz / ly, -ny / ly))
    return tx, _cross(n, tx)


def sample_ggx_h(n, alpha, xi1, xi2):
    """GGX NDF importance sample of the half vector (Material.hpp:111-123)."""
    phi = TWO_PI * xi1
    a2 = alpha * alpha
    cos_t = _ssqrt(
        torch.clamp_min(1.0 - xi2, 0.0)
        / torch.clamp_min(1.0 + (a2 - 1.0) * xi2, 1e-20)
    )
    sin_t = _ssqrt(1.0 - cos_t * cos_t)
    hx = sin_t * torch.cos(phi)
    hy = sin_t * torch.sin(phi)
    t, b = tangent_frame(n)
    return _normalize(_add(_add(_scale(t, hx), _scale(b, hy)), _scale(n, cos_t)))


def sample_mfn(m, n, xi1, xi2):
    """GGX NDF half-vector sample for rough lanes, n for smooth
    (Material.hpp:111-123, 268-281)."""
    h = sample_ggx_h(n, m["rough"], xi1, xi2)
    return _where3(is_rough(m["mtype"]), h, n)


def half_reflect(wi, wo, n):
    h = _normalize(_add(wi, wo))
    return _where3(_dot(wi, n) > 0.0, h, _neg(h))


def eval_bsdf(m, ior, refl, wi, wo, n, is_reflect):
    """Material::eval (Material.hpp:330-408) in the JAX kernel's default
    select-the-half-vector-first form (`_EVAL_FUSED=False`)."""
    win = _dot(wi, n)
    won = _dot(wo, n)
    same_side = win * won > 0.0
    eta = torch.where(win > 0.0, ior, 1.0 / ior)
    alpha = m["rough"]
    nwi = _neg(wi)
    conductor = is_conductor(m["mtype"])
    rough_m = is_rough(m["mtype"])
    hv = _sub(nwi, _scale(wo, eta))
    h_r = half_reflect(wi, wo, n)
    h_t0 = _normalize(hv)
    h_t = _where3(_dot(h_t0, n) > 0.0, h_t0, _neg(h_t0))
    h = _where3(is_reflect, h_r, h_t)

    d_h = d_ggx(h, n, alpha)
    g_h = g1(wi, h, alpha) * g1(wo, h, alpha)
    f_h = fresnel(m, ior, nwi, h)

    f_r = torch.where(conductor, fresnel_schlick(torch.abs(_dot(h, wo)), refl), f_h)
    denom_r = 4.0 * torch.abs(win) * torch.abs(won) + EPSILON
    rough_reflect = torch.where(same_side, f_r * d_h * g_h / denom_r, 0.0)

    hol = _dot(h, wi)
    hov = _dot(h, wo)
    den = hol + eta * hov
    den = den * den * torch.abs(win * won)
    den = torch.clamp_min(den, 1e-10)
    rough_refract = (1.0 - f_h) * d_h * g_h * eta * eta * torch.abs(hol * hov) / den
    rough_refract = torch.where(
        conductor | same_side | (win * won == 0.0), 0.0, rough_refract
    )

    aligned = _dot(h, n) >= ONE_MINUS_EPS
    f_sm = fresnel(m, ior, nwi, n)
    smooth_reflect = torch.where(
        same_side & aligned,
        torch.where(conductor, fresnel_schlick(torch.abs(won), refl), f_sm),
        0.0,
    )
    smooth_refract = torch.where(
        (~conductor) & (~same_side) & (win * won != 0.0) & aligned,
        1.0 - f_sm,
        0.0,
    )
    rough = torch.where(is_reflect, rough_reflect, rough_refract)
    smooth = torch.where(is_reflect, smooth_reflect, smooth_refract)
    return torch.where(rough_m, rough, smooth)


def pdf(m, ior, wi, wo, n, is_reflect):
    """Material::pdf (Material.hpp:285-328)."""
    eta = torch.where(_dot(wi, n) > 0.0, ior, 1.0 / ior)
    h_r = half_reflect(wi, wo, n)
    jac_r = 1.0 / torch.clamp_min(4.0 * torch.abs(_dot(h_r, wo)), 1e-8)
    hv = _sub(_neg(wi), _scale(wo, eta))
    h_t = _normalize(hv)
    d1 = torch.clamp_min(_dot(hv, hv), 1e-12)
    jac_t = eta * eta * torch.abs(_dot(h_t, wo)) / d1
    h = _where3(is_reflect, h_r, h_t)
    jac = torch.where(is_reflect, jac_r, jac_t)
    d = d_ggx(h, n, m["rough"])
    p_rough = d * _dot(n, h) * jac
    h_sm_t = _where3(_dot(h_t, n) > 0.0, h_t, _neg(h_t))
    h_sm = _where3(is_reflect, _normalize(_add(wi, wo)), h_sm_t)
    p_smooth = torch.where(torch.abs(_dot(h_sm, n)) > ONE_MINUS_EPS, 1.0, 0.0)
    return torch.where(is_rough(m["mtype"]), p_rough, p_smooth)


# ---------------------------------------------------------------------------
# Per-vertex shading (megakernel.py:1139-1391)
# ---------------------------------------------------------------------------


def make_ctx(tables, chan) -> dict:
    """Shading context for lanes of channel `chan` (the JAX kernel's `ctx`).
    Scalars of the `par` table become Python floats (exact float32 values)."""
    par = tables.par[0].tolist()
    lam = _pick3(
        chan,
        torch.tensor(float(WAVELEN_UM[0]), device=chan.device),
        torch.tensor(float(WAVELEN_UM[1]), device=chan.device),
        torch.tensor(float(WAVELEN_UM[2]), device=chan.device),
    )
    return {
        "mat": tables.mat,
        "emt": tables.emt,
        "emeta": tables.emeta,
        "lcum": tables.lcum,
        "n_emitters": tables.n_emitters,
        "n_sph_emitters": tables.n_sph_emitters,
        "n_dir_sample": tables.n_dir_sample if tables.n_emitters else 0,
        "enable_shadow": tables.enable_shadow,
        "textured": tables.any_textured,
        "chan": chan,
        "lam": lam,
        "bg": (par[0], par[1], par[2]),
        "rr_rate": par[3],
        "inv_rr": par[4],
        "total_area": par[5],
        "env": tables.env,
        "use_env": tables.use_env,
    }


def env_where(ctx, mask, d):
    """The env radiance of direction `d` for the lanes in `mask` (zero on
    the others, which never read it): full-resolution bilinear, fetched
    only where it is used."""
    out = torch.zeros_like(d[0])
    out[mask] = sample_env_chan(
        ctx["env"], ctx["bg"], True, tuple(x[mask] for x in d), ctx["chan"][mask]
    )
    return out


def _pick_light(ctx, v0_, v1_):
    """Light pick: stage 1 counts light meshes with cum < target; stage 2
    takes the first same-mesh emitter row whose sqrt(u) < frac fires, else
    the last same-mesh row, else a zero row (megakernel.py:1209-1255)."""
    target = v0_ * ctx["total_area"]
    lcum = ctx["lcum"][:, 0].tolist()
    mesh = torch.zeros_like(target)
    for c in lcum:
        mesh = mesh + torch.where(c < target, 1.0, 0.0)
    emeta = ctx["emeta"]
    sv1 = _sqrt(v1_)
    sel = torch.full(target.shape, -1, dtype=torch.int64, device=target.device)
    found = torch.zeros_like(target, dtype=torch.bool)
    for ei in range(ctx["n_emitters"]):
        same = emeta[ei, 0] == mesh
        sel = torch.where(same & ~found, ei, sel)
        found = found | (same & (sv1 < emeta[ei, 3]))
    row = ctx["emt"][sel.clamp(min=0)]
    row = torch.where((sel >= 0)[..., None], row, torch.zeros_like(row))
    return [row[..., c] for c in range(row.shape[-1])]


def vertex_pre(ctx, draw_fn, d, p, n, uv, mat_id, happened, emissive, depth0):
    """Occlusion-independent half of per-vertex shading: material gather,
    GGX microfacet sample + Fresnel split, NEE light samples (directions and
    distances), Russian roulette, the reflect/refract branch and the
    indirect weight. `draw_fn(use)` returns one uniform per lane. Returns the
    JAX function's dict."""
    chan = ctx["chan"]
    lam = ctx["lam"]
    wo = _neg(d)
    m = gather_mat(ctx["mat"], mat_id, chan)
    ior = m["ior_a"] + m["ior_b"] / (lam * lam)
    b_leaf = torch.clamp(m["emit"] * torch.abs(_dot(wo, n)), 0.0, 1.0)
    is_b = depth0 & happened & emissive

    xi0 = draw_fn(1)
    xi1 = draw_fn(2)
    xi2 = draw_fn(3)
    xi3 = draw_fn(4)
    mfn = sample_mfn(m, n, xi0, xi1)
    kr = fresnel(m, ior, d, mfn)

    off_scale = torch.clamp_min(
        REL_EPS
        * torch.maximum(
            torch.abs(p[0]), torch.maximum(torch.abs(p[1]), torch.abs(p[2]))
        ),
        EPSILON,
    )
    p_dl = _add(p, _scale(n, off_scale))
    inner = _dot(wo, n) < 0.0
    refl = reflectance(m, uv) if ctx["textured"] else m["refl"]
    samples = []
    if ctx["n_emitters"] > 0:
        for si in range(ctx["n_dir_sample"]):
            base = 16 + 4 * si
            v0_ = draw_fn(base)
            v1_ = draw_fn(base + 1)
            v2_ = draw_fn(base + 2)
            v3_ = draw_fn(base + 3)
            row = _pick_light(ctx, v0_, v1_)
            mesh_area = 1.0 / torch.clamp_min(row[15], 1e-30)
            xs = _sqrt(v2_)
            ys = v3_
            wx = xs * (1.0 - ys)
            wy = xs * ys
            lp = tuple(row[k] + row[3 + k] * wx + row[6 + k] * wy for k in range(3))
            ln = (row[9], row[10], row[11])
            if ctx["n_sph_emitters"]:
                # emissive-sphere row: uniform surface point c + r·dir
                is_se = row[16] > 0.5
                ysp = 1.0 - 2.0 * v2_
                ssp = _sqrt(torch.clamp_min(1.0 - ysp * ysp, 0.0))
                php = TWO_PI * v3_
                dv = (ssp * torch.cos(php), ysp, ssp * torch.sin(php))
                lp = _where3(
                    is_se, tuple(row[k] + row[3] * dv[k] for k in range(3)), lp
                )
                ln = _where3(is_se, dv, ln)
            emit_l = _pick3(chan, row[12], row[13], row[14])
            delta = _sub(lp, p_dl)
            # sqrt-then-divide (not rsqrt): dist feeds the fan's t < dist − ε
            dist = _sqrt(torch.clamp_min(_dot(delta, delta), 1e-20))
            inv_dist = 1.0 / dist
            ws = _scale(delta, inv_dist)
            samples.append((ws, dist, inv_dist, emit_l, mesh_area, ln))

    rr_kill = xi2 >= ctx["rr_rate"]
    branch_reflect = xi3 < kr
    womfn = _dot(wo, mfn)
    sign_reflect = torch.where(womfn < 0.0, -1.0, 1.0)
    sign = torch.where(branch_reflect, sign_reflect, -sign_reflect)
    p_new = _add(p, _scale(n, off_scale * sign))
    wi = _where3(branch_reflect, _reflect(wo, mfn), refract(ior, d, mfn))

    ev = eval_bsdf(m, ior, refl, wi, wo, n, branch_reflect)
    pv = pdf(m, ior, wi, wo, n, branch_reflect)
    pv_ok = torch.abs(pv) > 1e-10
    w_rough = torch.where(
        pv_ok,
        ev * torch.abs(_dot(wo, n)) / torch.where(pv_ok, pv, 1.0) * ctx["inv_rr"],
        0.0,
    )
    w = torch.where(m["dirac"] > 0.5, ev * ctx["inv_rr"], w_rough)
    bg = ctx["bg"]
    bg_l = _pick3(chan, *(torch.tensor(b, device=chan.device) for b in bg))
    env_ind = bg_l * ev * ctx["inv_rr"]
    return {
        "w": w,
        "ev": ev,
        "p_new": p_new,
        "wi": wi,
        "rr_kill": rr_kill,
        "is_b": is_b,
        "b_leaf": b_leaf,
        "bg_l": bg_l,
        "env_ind": env_ind,
        "samples": samples,
        "p_dl": p_dl,
        "m": m,
        "ior": ior,
        "refl": refl,
        "inner": inner,
        "kr": kr,
        "wo": wo,
    }


def nee_shade(ctx, n, V, vis):
    """BSDF-weighted direct-light sum over `V["samples"]` masked by `vis`
    (one bool tensor per sample, or None ⇒ all visible)."""
    inv_s = 1.0 / ctx["n_dir_sample"] if ctx["n_dir_sample"] else 0.0
    l_dir_raw = torch.zeros_like(ctx["lam"])
    for si, (ws, dist, inv_dist, emit_l, mesh_area, ln) in enumerate(V["samples"]):
        ev = eval_bsdf(V["m"], V["ior"], V["refl"], ws, V["wo"], n, ~V["inner"])
        contrib = (
            emit_l
            * ev
            * _dot(ws, n)
            * -_dot(ws, ln)
            * (inv_dist * inv_dist)
            * mesh_area
            * inv_s
        )
        if vis is not None:
            contrib = torch.where(vis[si], contrib, 0.0)
        l_dir_raw = l_dir_raw + contrib
    return torch.where(V["inner"], 1.0 - V["kr"], V["kr"]) * l_dir_raw


# ---------------------------------------------------------------------------
# What both kernels' plain versions share: lanes, queries and the work tally
# ---------------------------------------------------------------------------


def block_lanes(n_lanes, lane_offset, lane_stride, dev):
    """The lane ids of one launch: lane_offset + i·lane_stride, i < n_lanes
    (megakernel.py:1642, :1965). Ids past the image (3·W·H, the sharded
    render's pad lanes) map to pixels below it, as in JAX."""
    return torch.arange(n_lanes, dtype=torch.int64, device=dev) * int(lane_stride) + int(
        lane_offset
    )


def _nearest(tables, o, d, live, textured, ops):
    """The nearest hit of the rays (o, d), through the BVH walk for the
    rays where `live` or by the brute sweep for every ray; tallies the live
    rays' tests."""
    _tally(ops, "sph", live.sum() * tables.sph.shape[0])
    if tables.use_bvh:
        return bvh_nearest(tables, o, d, live, textured=textured, ops=ops)
    _tally(ops, "woop", live.sum() * tables.tri.shape[0])
    return intersect_tile(tables.tri, tables.sph, o, d, textured=textured)


def _tally_fan(ops, tables, at_vertex, vis):
    """A brute-force fan counts a visible shadow ray's whole sweep and one
    test for a blocked ray; the BVH walk tallies its own tests."""
    if ops is None or vis is None:
        return
    n_occ = tables.occ.shape[0]
    for v in vis:
        seen = (at_vertex & v).sum()
        _tally(ops, "sph", seen * tables.sph.shape[0])
        if not tables.use_bvh:
            _tally(ops, "fan_tri", seen * n_occ + (at_vertex & ~v).sum())
    if not tables.use_bvh:
        _tally(ops, "fan_origin", at_vertex.sum() * n_occ)


# ---------------------------------------------------------------------------
# The regen kernel, lockstep over lanes (megakernel.py:1860-2504, 2755-2774)
# ---------------------------------------------------------------------------


def trace_block_ref(tables, cam, seed, lane_offset, spp, n_lanes, max_bounces=8, ops=None,
                    lane_stride=1):
    """Plain version of one regen-kernel launch over lanes
    lane_offset + i·lane_stride, i < n_lanes: returns (mean radiance, ray
    count), two float32 (n_lanes,) tensors on the tables' device.

    Lockstep form of `_iter_live`: every lane runs its own sample stream; per
    iteration each lane either finalizes its pending env-terminal (bounce
    ray missed or reached an emitter) or shades its vertex, folds the
    firefly clamps forward through the min-affine prefix (C, B, W), and on
    termination accumulates and respawns its next camera sample. One nearest
    hit per iteration serves bounce rays and fresh camera rays alike.

    Scenes with a BVH (`tables.use_bvh`) take the BVH walks instead of the
    brute sweeps; env-map scenes (`tables.use_env`) shade a camera miss with
    env(d), unclamped, and a surviving bounce's pending env-terminal with
    env(wi)·eval·invRr (`mcpt_tpu/integrator.py:20-27`), both looked up at
    full resolution per lane.

    `ops`, a `collections.Counter`, receives a tally of the work this
    launch's data needs, from which `chip_smoke.py` reckons the kernel's
    operation bound: camera rays, shaded vertices, env lookups, Woop tests
    (`woop`), sphere tests (`sph`, nearest and fan), box tests (`slab`),
    shadow-fan triangle tests (`fan_tri`), the fan's per-origin triangle
    terms (`fan_origin`) and a BVH walk's row loads (`row`). Only live rays
    count. A brute-force fan counts a
    visible shadow ray's whole sweep and one test for a blocked ray (the
    kernel stops at its blocker)."""
    if max_bounces > MAX_BOUNCES_LIMIT:
        raise ValueError(f"max_bounces {max_bounces} > {MAX_BOUNCES_LIMIT}")
    dev = tables.device
    seed = int(seed)
    lane = block_lanes(n_lanes, lane_offset, lane_stride, dev)
    pix, chan, fi, fj, lane, _ = lane_to_pixel(lane, cam["width"])
    ctx = make_ctx(tables, chan)
    n_dir = ctx["n_dir_sample"]
    textured = ctx["textured"]
    shadow = ctx["enable_shadow"] and n_dir > 0
    use_bvh = tables.use_bvh
    use_env = ctx["use_env"]

    zero_i = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    zero_f = torch.zeros(n_lanes, dtype=torch.float32, device=dev)
    o, d = cam_ray(cam, seed, pix, fi, fj, zero_i)
    all_lanes = torch.ones(n_lanes, dtype=torch.bool, device=dev)
    _tally(ops, "camera", n_lanes)
    hit = _nearest(tables, o, d, all_lanes, textured, ops)
    s_lane = zero_i
    d_lane = zero_i
    has_pend = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    f_c = torch.full_like(zero_f, FOLD_BIG)
    f_b = zero_f
    f_w = torch.ones_like(zero_f)
    pend = zero_f
    rad = zero_f
    rays = torch.ones_like(zero_f)  # sample 0's primary

    while bool((s_lane < spp).any()):
        _, happened, p, n, uv, mat_id, emissive = hit
        active = s_lane < spp
        has_pend = has_pend & active
        ended_env = has_pend & (~happened | emissive)
        proc = active & ~ended_env

        base = path_key_base(lane, s_lane, d_lane, seed)
        V = vertex_pre(
            ctx, lambda use: path_draw(base, use), d, p, n, uv, mat_id,
            happened, emissive, d_lane == 0,
        )
        at_vertex = proc & happened & ~V["is_b"]
        survive_raw = at_vertex & ~V["rr_kill"]
        capped = survive_raw & (d_lane == max_bounces - 1)
        survive = survive_raw & ~capped

        # next ray: survivors bounce, finished paths respawn a camera sample
        write_now = proc & ~survive
        done_now = active & (write_now | ended_env)
        s_new = s_lane + done_now.to(torch.int64)
        need_spawn = done_now & (s_new < spp)
        oc, dc = cam_ray(cam, seed, pix, fi, fj, s_new)
        o_n = _where3(need_spawn, oc, V["p_new"])
        d_n = _where3(need_spawn, dc, _where3(survive, V["wi"], d))

        vis = _fan(tables, V, at_vertex, shadow, ops)
        _tally(ops, "camera", need_spawn.sum())
        hit_n = _nearest(tables, o_n, d_n, need_spawn | survive, textured, ops)
        l_dir = nee_shade(ctx, n, V, vis)
        _tally(ops, "vertex", at_vertex.sum())
        _tally_fan(ops, tables, at_vertex, vis)
        if use_env:
            _tally(ops, "env", (proc & ~happened).sum() + survive.sum())
            miss_leaf = env_where(ctx, proc & ~happened, d)
            env_ind = env_where(ctx, survive, V["wi"]) * V["ev"] * ctx["inv_rr"]
        else:
            miss_leaf, env_ind = V["bg_l"], V["env_ind"]
        leaf_now = torch.where(
            ~happened,
            miss_leaf,
            torch.where(
                V["is_b"],
                V["b_leaf"],
                torch.where(capped, torch.clamp(l_dir, 0.0, CLAMP_DIRECT), l_dir),
            ),
        )
        a_t = torch.clamp(l_dir, 0.0, CLAMP_DIRECT)
        new_pend = a_t + torch.clamp(env_ind, 0.0, CLAMP_INDIRECT)

        # terminal contributions through the composed prefix map; depth-0
        # terminals bypass it (the raw, possibly negative, value)
        f_id = d_lane == 0
        ev_now = torch.minimum(f_c, f_b + f_w * torch.clamp_min(leaf_now, 0.0))
        contrib = torch.where(f_id, leaf_now, ev_now)
        rad = rad + torch.where(
            done_now, torch.where(ended_env, pend, contrib), 0.0
        )
        ev_pend = torch.minimum(f_c, f_b + f_w * new_pend)
        pend = torch.where(survive, torch.where(f_id, new_pend, ev_pend), pend)
        c_c = torch.minimum(f_c, f_b + f_w * (a_t + CLAMP_INDIRECT))
        c_b = f_b + f_w * a_t
        c_w = torch.clamp_max(f_w * V["w"], FOLD_W_CAP)
        f_c = torch.where(need_spawn, FOLD_BIG, torch.where(survive, c_c, f_c))
        f_b = torch.where(need_spawn, 0.0, torch.where(survive, c_b, f_b))
        f_w = torch.where(need_spawn, 1.0, torch.where(survive, c_w, f_w))

        d_lane = torch.where(
            done_now, 0, torch.where(survive, d_lane + 1, d_lane)
        )
        has_pend = survive
        s_lane = s_new
        rays = (
            rays
            + torch.where(at_vertex, float(n_dir), 0.0)
            + survive.to(torch.float32)
            + need_spawn.to(torch.float32)
        )
        d = d_n
        hit = hit_n
    return rad / torch.full_like(rad, spp), rays


def _fan(tables, V, at_vertex, shadow, ops):
    """Visibility of a vertex's shadow rays (one bool tensor per light
    sample), or None when nothing is tested: for the lanes at a vertex, the
    BVH walks as the kernels walk them (the S = 4 instances' four rays in
    one walk, the generic instances' one ray a walk:
    csrc/mega_common.cuh `occlude_fan_bvh`), else the brute fan over the
    occluder table."""
    if not (shadow and V["samples"]):
        return None
    o, ws, dists = V["p_dl"], [s_[0] for s_ in V["samples"]], [s_[1] for s_ in V["samples"]]
    if not tables.use_bvh:
        return occlude_shared_origin(tables.occ, tables.sph, o, ws, dists)
    if len(ws) == 4:
        return bvh_fan(tables, o, ws, dists, at_vertex, ops=ops)
    # each ray alone, all in one walk over (ray, lane) pairs
    r, n = len(ws), at_vertex.shape[0]
    e = tuple(torch.cat([w[k] for w in ws]) for k in range(3))
    vis = bvh_fan(tables, tuple(x.repeat(r) for x in o), [e], [torch.cat(dists)],
                  at_vertex.repeat(r), ops=ops)[0]
    return list(vis.split(n))


# ---------------------------------------------------------------------------
# The lockstep kernel K1b (megakernel.py:1579-1857)
# ---------------------------------------------------------------------------


def trace_block_lockstep_ref(tables, cam, seed, lane_offset, spp, n_lanes, max_bounces=8,
                             lane_stride=1, ops=None):
    """Plain version of one lockstep-kernel launch over lanes
    lane_offset + i·lane_stride, i < n_lanes: returns (mean radiance, ray
    count), two float32 (n_lanes,) tensors on the tables' device.

    Every lane runs sample s at once: the camera ray (keyed per sample,
    `lockstep_sample_key`), then per depth the vertex (`vertex_pre`, the
    fan, `nee_shade`, draws keyed by `lockstep_depth_key`) and the next
    hit, writing a record (rec0, w, terminal) into (max_bounces, 3, n)
    tensors: rec0 is the leaf value where the path ends (a miss: the
    background; an emitter seen from the camera; a Russian-roulette kill:
    the raw l_dir; a bounce ray that misses or reaches an emitter:
    clamp15(l_dir) + clamp5(env_ind)), else l_dir. The depth loop stops when
    no lane is alive (slots left over read terminal 0), and the sample's
    radiance is the reverse fold L = terminal ? rec0 : clamp15(rec0) +
    clamp5(w·L) from L = 0. No env maps: the JAX kernel refuses them. `ops`
    tallies the work as `trace_block_ref` does."""
    if max_bounces > MAX_BOUNCES_LIMIT:
        raise ValueError(f"max_bounces {max_bounces} > {MAX_BOUNCES_LIMIT}")
    if tables.use_env:
        raise ValueError("env-map scenes require the regen megakernel")
    dev = tables.device
    seed = int(seed) & _M32
    lane = block_lanes(n_lanes, lane_offset, lane_stride, dev)
    pix, chan, fi, fj, lane, _ = lane_to_pixel(lane, cam["width"])
    ctx = make_ctx(tables, chan)
    n_dir = ctx["n_dir_sample"]
    textured = ctx["textured"]
    shadow = ctx["enable_shadow"] and n_dir > 0
    all_lanes = torch.ones(n_lanes, dtype=torch.bool, device=dev)
    rad = torch.zeros(n_lanes, dtype=torch.float32, device=dev)
    rays = torch.zeros_like(rad)

    for s in range(spp):
        su = lockstep_sample_key(s, seed)
        o, d = cam_ray_from(
            cam, fi, fj, lambda c, su=su: draw(pix, murmur((su + 101 + c) & _M32))
        )
        _tally(ops, "camera", n_lanes)
        hit = _nearest(tables, o, d, all_lanes, textured, ops)
        alive = all_lanes
        rays_s = torch.ones_like(rad)  # the camera ray
        rec = torch.zeros((max_bounces, 3, n_lanes), dtype=torch.float32, device=dev)
        rec[:, 2] = 1.0
        for depth in range(max_bounces):
            if not bool(alive.any()):
                break
            du = lockstep_depth_key(su, depth)
            _, happened, p, n, uv, mat_id, emissive = hit
            V = vertex_pre(
                ctx, lambda use, du=du: draw(lane, (du + use) & _M32), d, p, n, uv,
                mat_id, happened, emissive, depth == 0,
            )
            at_vertex = alive & happened & ~V["is_b"]
            vis = _fan(tables, V, at_vertex, shadow, ops)
            l_dir = nee_shade(ctx, n, V, vis)
            goes = at_vertex & ~V["rr_kill"]
            nxt = _nearest(tables, V["p_new"], V["wi"], goes, textured, ops)
            cont = goes & nxt[1] & ~nxt[6]
            _tally(ops, "vertex", at_vertex.sum())
            _tally_fan(ops, tables, at_vertex, vis)
            leaf = torch.where(
                ~alive,
                0.0,
                torch.where(
                    ~happened,
                    V["bg_l"],
                    torch.where(
                        V["is_b"],
                        V["b_leaf"],
                        torch.where(
                            V["rr_kill"],
                            l_dir,
                            torch.clamp(l_dir, 0.0, CLAMP_DIRECT)
                            + torch.clamp(V["env_ind"], 0.0, CLAMP_INDIRECT),
                        ),
                    ),
                ),
            )
            rec[depth, 0] = torch.where(cont, torch.where(alive, l_dir, 0.0), leaf)
            rec[depth, 1] = V["w"]
            rec[depth, 2] = (~cont).to(torch.float32)
            survive = goes & (depth < max_bounces - 1)
            rays_s = rays_s + torch.where(at_vertex, float(n_dir), 0.0) + survive.to(
                torch.float32
            )
            d, hit, alive = V["wi"], nxt, cont
        acc = torch.zeros_like(rad)
        for k in reversed(range(max_bounces)):
            acc = torch.where(
                rec[k, 2] > 0.5,
                rec[k, 0],
                torch.clamp(rec[k, 0], 0.0, CLAMP_DIRECT)
                + torch.clamp(rec[k, 1] * acc, 0.0, CLAMP_INDIRECT),
            )
        rad = rad + acc
        rays = rays + rays_s
    return rad / torch.full_like(rad, spp), rays
