"""Ray-scene intersection of the wavefront path (counterpart of
`mcpt_tpu/intersect.py`).

Semantics reproduce the reference exactly: Möller-Trumbore with the
``|det| < EPSILON`` miss and inclusive barycentric bounds, the sphere
quadratic's stable q-form, AABB slabs with ±EPSILON slack, nearest hit wins
(first minimum in table order). Three methods, as in JAX:

- **kernel**: the hand-written CUDA kernel `csrc/intersect_prims.cu`
  (`kernels/intersect_prims.py`), K2/K3 of the JAX package, for a CUDA pack
  of any size: it walks the pack's BVH where the pack has one
  (`pack.walk`, above `cluster_threshold` triangles) and sweeps the table
  where it has none; on a CPU pack its plain version (the sweep).
- **dense**: two (B, 3) @ (3, 3T) products (`torch.matmul` in full float32)
  into every triangle's unit frame, then elementwise accept tests and an
  argmin — what JAX computes outside any Pallas kernel.
- **bvh**: every ray walks the threaded BVH (`pack.bvh_fat`) in lockstep,
  one `.any()` per step; leaves test their primitives with gathered rows.

`auto` picks `kernel` on a CUDA device at any table size and tree depth
(a tree deeper than `constants.BVH_STACK` levels takes the walk whose
stack goes past a shared-memory tier into device memory), and on the CPU `dense`
up to 4096 padded triangles and `bvh` above (JAX's rule). Every function
takes the device pack (`scene.pack_to`); vectors are 3-tuples of (B,)
tensors in the `_c` functions and (B, 3) rows elsewhere.
"""

from contextlib import contextmanager
from typing import NamedTuple

import torch

from mcpt_tpu_torch.constants import EPSILON, T_MAX
from mcpt_tpu_torch.kernels.intersect_prims import intersect_prims_c, load_library
from mcpt_tpu_torch.kernels.intersect_prims_ref import fan_origins
from mcpt_tpu_torch.kernels.megakernel_ref import sph_roots, sqrt_f32
from mcpt_tpu_torch.scene import pack_to

T_MAX_F = float(T_MAX)
# Triangle-table size above which the all-pairs methods give way to the BVH.
DENSE_MAX_TRIS = 4096
# rays per chunk of the dense method: bounds its (rays, 3T) temporaries
DENSE_CHUNK = 1 << 16


class Hit(NamedTuple):
    """Nearest-hit record. prim: triangle row, or n_tris + sphere index, or
    -1 on a miss; t is T_MAX on a miss; (u, v) the winning triangle's
    barycentrics (0 for spheres and misses)."""

    t: torch.Tensor
    prim: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


class SurfaceC(NamedTuple):
    """Shading info at the nearest hit, component form."""

    happened: torch.Tensor  # (B,) bool
    p: tuple  # 3 x (B,)
    n: tuple  # 3 x (B,) geometric normal (not flipped)
    uv: tuple  # 2 x (B,)
    mat: torch.Tensor  # (B,) int64 material id
    emissive: torch.Tensor  # (B,) bool
    t: torch.Tensor


def _gather(table, idx):
    """Rows of `table` at `idx`, a zero row where idx is outside the table
    (as the JAX package's one-hot `gather_rows`)."""
    ok = (idx >= 0) & (idx < table.shape[0])
    rows = table[idx.clamp(0, table.shape[0] - 1)]
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


@contextmanager
def _full_f32_matmul():
    """float32 products at full precision for this block only (TF32 keeps
    ~3 digits, which breaks the visibility test); restores the caller's
    setting."""
    prev = torch.get_float32_matmul_precision()
    if prev != "highest":
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if prev != "highest":
            torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# Sphere test (shared)
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """a·b + c rounded once to float32 (a float32 product is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).float()


def _sphere_t(pack, o, d):
    """(B, S) hit distances of (B, 3) rays against all spheres; T_MAX on a
    miss. b = 2·(d·L) is a contraction in the JAX function (an einsum),
    which accumulates with fused multiply-adds; the roots' cancellation
    turns a one-ULP difference in b into tens of ULPs in t, so b is summed
    the same way here."""
    c = pack.sph_geom[:, :3]
    r = pack.sph_geom[:, 3]
    L = [o[:, None, k] - c[None, :, k] for k in range(3)]  # 3 x (B, S)
    a = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])[:, None]
    b = 2.0 * _fma(d[:, None, 2], L[2], _fma(d[:, None, 1], L[1], d[:, None, 0] * L[0]))
    cc = L[0] * L[0] + L[1] * L[1] + L[2] * L[2] - (r * r)[None, :]
    return sph_roots(a, b, cc, r[None, :])


def _nearest_of(t_tri, u, v, sph_t, t_cnt):
    """The first minimum over triangles then spheres, as a Hit."""
    all_t = torch.cat([t_tri, sph_t], dim=1)
    prim = torch.argmin(all_t, dim=1)
    t_best = torch.gather(all_t, 1, prim[:, None])[:, 0]
    is_tri = prim < t_cnt
    tid = torch.where(is_tri, prim, 0)[:, None]
    u_best = torch.where(is_tri, torch.gather(u, 1, tid)[:, 0], 0.0)
    v_best = torch.where(is_tri, torch.gather(v, 1, tid)[:, 0], 0.0)
    prim = torch.where(t_best < T_MAX_F, prim, -1).to(torch.int32)
    return Hit(t=t_best, prim=prim, u=u_best, v=v_best)


# ---------------------------------------------------------------------------
# Dense (matmul) triangle method
# ---------------------------------------------------------------------------


def _dense_chunk(pack, o, d):
    t_cnt = pack.tri_w.shape[0]
    wf = pack.tri_w.reshape(t_cnt * 3, 3)
    with _full_f32_matmul():
        dp = torch.matmul(d, wf.T).reshape(-1, t_cnt, 3)
        op = torch.matmul(o, wf.T).reshape(-1, t_cnt, 3) - pack.tri_c[None]
    dz = dp[:, :, 2]
    oz = op[:, :, 2]
    det = -dz * pack.tri_nr2[None, :]
    det_g = torch.where(torch.abs(det) >= EPSILON, det, 1.0)
    t_hit = oz * pack.tri_nr2[None, :] / det_g
    u = op[:, :, 0] + t_hit * dp[:, :, 0]
    v = op[:, :, 1] + t_hit * dp[:, :, 1]
    ok = (
        (torch.abs(det) >= EPSILON)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t_hit >= 0.0)
        & pack.tri_valid[None, :]
    )
    t_arr = torch.where(ok, t_hit, T_MAX_F)
    return _nearest_of(t_arr, u, v, _sphere_t(pack, o, d), t_cnt)


def intersect_dense(pack, o, d) -> Hit:
    """Nearest hit of (B, 3) rays through the unit-triangle transforms,
    over chunks of `DENSE_CHUNK` rays."""
    hits = [
        _dense_chunk(pack, o[lo:lo + DENSE_CHUNK], d[lo:lo + DENSE_CHUNK])
        for lo in range(0, max(o.shape[0], 1), DENSE_CHUNK)
    ]
    return Hit(*(torch.cat(f) for f in zip(*hits)))


# ---------------------------------------------------------------------------
# Gathered single-primitive tests (BVH leaves)
# ---------------------------------------------------------------------------


def _cross(a, b):
    return torch.stack(
        [
            a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
        ],
        dim=-1,
    )


def _sum3(x):
    return x[..., 0] + x[..., 1] + x[..., 2]


def _mt(v0, e1, e2, o, d, valid):
    """Möller-Trumbore of (B, 3) rays against (B, 3) triangles."""
    pvec = _cross(d, e2)
    det = _sum3(e1 * pvec)
    det_safe = torch.where(torch.abs(det) >= EPSILON, det, 1.0)
    inv = 1.0 / det_safe
    tvec = o - v0
    u = _sum3(tvec * pvec) * inv
    qvec = _cross(tvec, e1)
    v = _sum3(d * qvec) * inv
    t = _sum3(e2 * qvec) * inv
    ok = (
        (torch.abs(det) >= EPSILON)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= 0.0)
        & valid
    )
    return torch.where(ok, t, T_MAX_F), u, v


def _tri_test_gather(pack, pid, o, d):
    row = pack.tri_mt[pid]
    return _mt(row[:, 0:3], row[:, 3:6], row[:, 6:9], o, d, pack.tri_valid[pid])


def _sphere_test_gather(pack, sid, o, d):
    row = pack.sph_geom[sid]
    L = o - row[:, 0:3]
    return sph_roots(_sum3(d * d), 2.0 * _sum3(d * L), _sum3(L * L) - row[:, 3] * row[:, 3],
                     row[:, 3])


# ---------------------------------------------------------------------------
# Stackless lockstep BVH traversal
# ---------------------------------------------------------------------------


def intersect_bvh(pack, o, d) -> Hit:
    """Every ray walks the threaded BVH in lockstep: one fat-row gather per
    node visit, one gathered test per leaf slot, one `.any()` per step."""
    if pack.bvh_fat is None:
        raise ValueError("the pack has no bvh_fat: move it with pack_to(..., bvh=True)")
    b = o.shape[0]
    n_tris = pack.n_tris
    n_sph = pack.sph_geom.shape[0]
    fat = pack.bvh_fat
    leaf_size = fat.shape[1] - 8
    dinv = 1.0 / d
    dev = o.device
    node = torch.zeros(b, dtype=torch.int64, device=dev)
    t_best = torch.full((b,), T_MAX_F, dtype=torch.float32, device=dev)
    prim_best = torch.full((b,), -1, dtype=torch.int64, device=dev)
    u_best = torch.zeros_like(t_best)
    v_best = torch.zeros_like(t_best)
    while bool((node >= 0).any()):
        active = node >= 0
        row = fat[node.clamp(min=0)]
        vt1 = (row[:, 0:3] - o) * dinv
        vt2 = (row[:, 3:6] - o) * dinv
        tmin = torch.amax(torch.minimum(vt1, vt2), dim=-1)
        tmax = torch.amin(torch.maximum(vt1, vt2), dim=-1)
        miss = row[:, 6].to(torch.int64)
        count = row[:, 7]
        hit_box = (tmin - EPSILON <= tmax) & (tmax >= -EPSILON) & active
        hit_box = hit_box & (tmin - EPSILON <= t_best)
        is_leaf = (count > 0.0) & hit_box
        for s in range(leaf_size):
            pid = row[:, 8 + s].to(torch.int64)
            slot_ok = is_leaf & (pid >= 0)
            pid = torch.where(slot_ok, pid, 0)
            is_tri = pid < n_tris
            t_tri, u_tri, v_tri = _tri_test_gather(pack, pid.clamp(max=n_tris - 1), o, d)
            sid = (pid - n_tris).clamp(0, n_sph - 1)
            t_sph = _sphere_test_gather(pack, sid, o, d)
            t_cand = torch.where(is_tri, t_tri, t_sph)
            t_cand = torch.where(slot_ok, t_cand, T_MAX_F)
            better = t_cand < t_best
            t_best = torch.where(better, t_cand, t_best)
            prim_best = torch.where(better, pid, prim_best)
            u_best = torch.where(better & is_tri, u_tri, torch.where(better, 0.0, u_best))
            v_best = torch.where(better & is_tri, v_tri, torch.where(better, 0.0, v_best))
        interior_hit = hit_box & (count <= 0.0)
        nxt = torch.where(interior_hit, node + 1, miss)
        node = torch.where(active, nxt, -1)
    prim_best = torch.where(t_best < T_MAX_F, prim_best, -1).to(torch.int32)
    return Hit(t=t_best, prim=prim_best, u=u_best, v=v_best)


# ---------------------------------------------------------------------------
# The kernel method and the dispatch
# ---------------------------------------------------------------------------


def intersect_kernel_c(pack, oc, dc) -> Hit:
    """All primitives in one launch of the CUDA kernel (its plain version
    on a CPU pack): the walk over the pack's BVH where it has one, else the
    sweep (K2 for at most 1024 triangle rows)."""
    t, prim, u, v = intersect_prims_c(pack.tri_sc, pack.sph_geom, pack.n_tris, oc, dc,
                                      walk=pack.walk)
    return Hit(t=t, prim=prim, u=u, v=v)


def resolve_method(pack, method: str) -> str:
    """`auto`: the kernel on a CUDA pack at any table size (it walks the
    pack's BVH where it has one), `dense` on the CPU up to DENSE_MAX_TRIS
    padded triangles and `bvh` above."""
    if method == "auto":
        if pack.tri_sc.device.type == "cuda":
            return "kernel"
        return "bvh" if pack.n_tris > DENSE_MAX_TRIS else "dense"
    if method not in ("kernel", "dense", "bvh"):
        raise ValueError(f"unknown intersect method {method!r}")
    return method


def wavefront_pack(host, device, method: str = "auto"):
    """(`host`, a compiled `ScenePack`, moved to `device` as the wavefront
    reads it, the method it resolves to there): the card's kernel walks the
    scene's BVH where it has one, at any depth, and the `bvh` method gets
    its node rows."""
    pack = pack_to(host, device)
    method = resolve_method(pack, method)
    walk = method == "kernel" and pack.tri_sc.device.type == "cuda"
    if method == "bvh" or (walk and host.use_bvh):
        pack = pack_to(host, device, bvh=method == "bvh", walk=walk)
    if walk:
        load_library()  # build outside the timed region
    return pack, method


def _rows(c):
    return torch.stack(c, dim=-1)


def intersect_c(pack, oc, dc, method: str = "auto") -> Hit:
    """Component-form nearest hit: oc/dc are 3-tuples of (B,) tensors."""
    method = resolve_method(pack, method)
    if method == "kernel":
        return intersect_kernel_c(pack, oc, dc)
    if method == "dense":
        return intersect_dense(pack, _rows(oc), _rows(dc))
    return intersect_bvh(pack, _rows(oc), _rows(dc))


def occlude_t_c(pack, oc, dc, method: str = "auto", fan=None) -> torch.Tensor:
    """Nearest-hit distance only (T_MAX on a miss), the shadow-ray query;
    the kernel runs its occlusion mode, which keeps no winner. With
    `fan=S`, `oc` holds B origins and `dc` S·B directions, ray k·B + i from
    origin i: the kernel's sweep takes them as they are, every other route
    expands the origins first."""
    method = resolve_method(pack, method)
    if method == "kernel":
        return intersect_prims_c(
            pack.tri_sc, pack.sph_geom, pack.n_tris, oc, dc, occlusion=True, walk=pack.walk,
            fan=fan,
        )[0]
    if fan:
        oc = fan_origins(oc, fan)
    return intersect_c(pack, oc, dc, method=method).t


# ---------------------------------------------------------------------------
# Shading info
# ---------------------------------------------------------------------------


def surface_at_c(pack, oc, dc, hit: Hit) -> SurfaceC:
    """Shading info for the winning primitive per lane; barycentrics come
    from the Hit record, so nothing is re-intersected."""
    happened, is_tri, ts, ss, mat, emissive = surface_rows(pack, hit)
    p, n, uv = surface_math(oc, dc, hit.t, hit.u, hit.v, happened, is_tri, ts.unbind(1),
                            ss.unbind(1))
    return SurfaceC(happened=happened, p=p, n=n, uv=uv, mat=mat, emissive=emissive, t=hit.t)


def surface_rows(pack, hit: Hit):
    """The discrete half of `surface_at_c`: (happened, is_tri, the
    tri_shade row (a zero row when not a triangle), the sph_shade row (a
    zero row when not a sphere), the int64 material id, emissive)."""
    n_tris = pack.n_tris
    prim = hit.prim.to(torch.int64)
    happened = prim >= 0
    is_tri = happened & (prim < n_tris)
    tid = torch.where(is_tri, prim, -1)
    sid = torch.where(happened & ~is_tri, prim - n_tris, -1)
    ts = _gather(pack.tri_shade, tid)
    ss = _gather(pack.sph_shade, sid)
    mat = torch.where(is_tri, ts[:, 9], ss[:, 3]).to(torch.int64)
    mat = torch.where(happened, mat, 0)
    emissive = happened & (torch.where(is_tri, ts[:, 10], ss[:, 4]) > 0.5)
    return happened, is_tri, ts, ss, mat, emissive


def surface_math(oc, dc, t, u, v, happened, is_tri, ts, ss):
    """The arithmetic half of `surface_at_c` (ts, ss: the rows' columns):
    (p, n, uv). Missed lanes keep p = o (o + d*T_MAX would overflow
    downstream)."""
    t_eff = torch.where(happened, t, 0.0)
    p = tuple(oc[k] + dc[k] * t_eff for k in range(3))
    w0 = 1.0 - u - v
    uv_tri = (
        w0 * ts[3] + u * ts[5] + v * ts[7],
        w0 * ts[4] + u * ts[6] + v * ts[8],
    )
    ns = tuple(p[k] - ss[k] for k in range(3))
    inv = 1.0 / torch.clamp_min(sqrt_f32(ns[0] * ns[0] + ns[1] * ns[1] + ns[2] * ns[2]), 1e-20)
    n = tuple(torch.where(is_tri, ts[k], ns[k] * inv) for k in range(3))
    zero = torch.zeros_like(u)
    uv = (torch.where(is_tri, uv_tri[0], zero), torch.where(is_tri, uv_tri[1], zero))
    return p, n, uv


# ---------------------------------------------------------------------------
# Brute-force oracle (tests): direct per-(ray, triangle) Möller-Trumbore
# ---------------------------------------------------------------------------


def intersect_brute(pack, o, d) -> Hit:
    t_cnt = pack.tri_mt.shape[0]
    b = o.shape[0]
    mt = pack.tri_mt[None].expand(b, t_cnt, 9).reshape(-1, 9)
    oo = o[:, None].expand(b, t_cnt, 3).reshape(-1, 3)
    dd = d[:, None].expand(b, t_cnt, 3).reshape(-1, 3)
    t_tri, u, v = _mt(
        mt[:, 0:3], mt[:, 3:6], mt[:, 6:9], oo, dd,
        pack.tri_valid[None].expand(b, t_cnt).reshape(-1),
    )
    return _nearest_of(
        t_tri.reshape(b, t_cnt), u.reshape(b, t_cnt), v.reshape(b, t_cnt),
        _sphere_t(pack, o, d), t_cnt,
    )
