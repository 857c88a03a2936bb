"""Plain PyTorch version of the wavefront intersectors K2, K3 and K4
(`mcpt_tpu/kernels/intersect_pallas.py` `_kernel_sc`, `_kernel_mm`,
`_kernel`), the function `csrc/intersect_prims.cu` computes.

Per (ray, triangle row) it runs `_tri_candidate`'s arithmetic in its order
(`megakernel_ref._woop`, the same Woop test the megakernel's sweeps use)
plus K3/K4's `valid` test, and per (ray, sphere) `_sph_candidate`'s q-form
(`megakernel_ref._sph_candidates`). The nearest hit is the first minimum in
table order, triangles before spheres: the kernels' strict `<` winner, in
both modes (occlusion returns t alone, where equal t can differ only in the
sign of a zero: the first minimum's sign). The rows are swept in chunks so
that the (rays, rows) temporaries stay bounded.

`intersect_walk_ref` is the plain version of the kernel's walk mode: the
same answers, bit for bit, from a walk over the pack's BVH that takes the
kernel's items in the kernel's order, so its tally (`ops`) is the kernel's
work.
"""

from types import SimpleNamespace

import torch

from mcpt_tpu_torch.constants import BVH_STACK
from mcpt_tpu_torch.kernels.megakernel_ref import (
    T_MAX_F,
    _sph_candidates,
    _tally,
    _Walk,
    _woop,
    near_first_step,
)
from mcpt_tpu_torch.kernels.tables import WALK_ID

# (rays x rows) elements per chunk of the sweep
CHUNK_PAIRS = 1 << 22


def _tri_test(rows, o, d):
    """(t_cand, u, v) of the rays (o, d) against the tri_sc rows `rows`
    (broadcast against the ray components): the Woop test, then `valid`."""
    t, u, v = _woop([rows[..., c] for c in range(13)], o, d)
    return torch.where(rows[..., 13] > 0.5, t, T_MAX_F), u, v


def _with_spheres(best, sph, sph_base, oc, dc, occlusion):
    """The spheres after the triangles: a sphere wins only with a strictly
    smaller t. `best` is (t, prim int64, u, v); returns the function's
    result."""
    t_best, prim, u_best, v_best = best
    if sph.shape[0]:
        ts = _sph_candidates(sph, oc, dc)
        idx = torch.argmin(ts, dim=1)
        tc = torch.gather(ts, 1, idx[:, None])[:, 0]
        better = tc < t_best
        t_best = torch.where(better, tc, t_best)
        prim = torch.where(better, sph_base + idx, prim)
        u_best = torch.where(better, 0.0, u_best)
        v_best = torch.where(better, 0.0, v_best)
    if occlusion:
        return t_best, None, None, None
    return t_best, prim.to(torch.int32), u_best, v_best


def _no_hit(b, dev):
    """(t, prim, u, v) of b rays that hit nothing yet."""
    t = torch.full((b,), T_MAX_F, dtype=torch.float32, device=dev)
    prim = torch.full((b,), -1, dtype=torch.int64, device=dev)
    return t, prim, torch.zeros_like(t), torch.zeros_like(t)


def fan_origins(oc, fan):
    """The fan form's origins expanded to one a ray: ray k·B + i of a fan
    of `fan` rays from each of B origins starts at origin i."""
    return tuple(x.repeat(fan) for x in oc)


def intersect_prims_ref(tri, sph, sph_base, oc, dc, occlusion=False, fan=None):
    """Nearest hit of the rays (oc, dc) (3-tuples of (B,) float32) against
    the triangle rows `tri` (T, 16) in tri_sc's layout and the spheres `sph`
    (S, 4), S = 0 for triangles only. Returns (t, prim, u, v): t float32
    (T_MAX on a miss), prim int32 (-1 on a miss, `sph_base + s` for sphere
    s), u and v (0 unless a triangle wins); occlusion=True returns t and
    three Nones. With `fan`, `oc` holds one origin per fan (`fan_origins`)."""
    if fan:
        oc = fan_origins(oc, fan)
    b = oc[0].shape[0]
    t_best, prim, u_best, v_best = _no_hit(b, oc[0].device)
    step = max(8, CHUNK_PAIRS // max(b, 1))
    for lo in range(0, tri.shape[0], step):
        t, u, v = _tri_test(tri[lo:lo + step], tuple(x[:, None] for x in oc),
                            tuple(x[:, None] for x in dc))
        idx = torch.argmin(t, dim=1, keepdim=True)
        tc = torch.gather(t, 1, idx)[:, 0]
        better = tc < t_best
        t_best = torch.where(better, tc, t_best)
        prim = torch.where(better, lo + idx[:, 0], prim)
        u_best = torch.where(better, torch.gather(u, 1, idx)[:, 0], u_best)
        v_best = torch.where(better, torch.gather(v, 1, idx)[:, 0], v_best)
    return _with_spheres((t_best, prim, u_best, v_best), sph, sph_base, oc, dc, occlusion)


def intersect_walk_ref(bvh, leaf_sc, sph, sph_base, oc, dc, occlusion=False, ops=None,
                       depth=BVH_STACK):
    """`intersect_prims_ref`'s answers, bit for bit, through the pack's BVH
    (`kernels/tables.py::walk_tables`: child-pair rows `bvh` (R, 16), tri_sc
    rows in leaf order `leaf_sc` (L, 16)), then the spheres by brute force.

    The walk is the kernel's (`megakernel_ref.bvh_nearest`'s, over these
    tables): near-first, a child or popped entry taken while its entry
    t - EPSILON <= the best t so far, a ray descending rows until it holds
    a leaf. Nearest: the lowest t, equal t to the lower tri_sc row (the
    sweep's first minimum), u and v from that row. Occlusion: the same
    winner's t alone. Tallies under `ops` (a Counter) the rows loaded
    (`row`), box tests (`slab`), triangle tests (`woop`) and sphere tests
    (`sph`), and keeps the stack's high-water mark (`stack`). `depth`, the
    tree's levels, sizes the walk's stack above BVH_STACK (the kernel's
    deep walk)."""
    b = oc[0].shape[0]
    best_t, best_i, best_u, best_v = _no_hit(b, oc[0].device)
    inv = [1.0 / x for x in dc]
    leaf_id = leaf_sc.view(torch.int32)[:, WALK_ID].to(torch.int64)
    walk = _Walk(SimpleNamespace(bvh=bvh, leaf_tri=leaf_sc, bvh_depth=depth),
                 torch.ones(b, dtype=torch.bool, device=best_t.device),
                 torch.zeros_like(best_t), ops, tiered=True)
    while walk.lanes.numel():
        at_leaf = walk.cnt > 0
        for m, rows in walk.leaf_rows(at_leaf):
            ll = walk.lanes[at_leaf][m]
            _tally(ops, "woop", ll.numel())
            t_c, u, v = _tri_test(walk.leaf[rows], tuple(x[ll] for x in oc),
                                  tuple(x[ll] for x in dc))
            bt, ids = best_t[ll], leaf_id[rows]
            better = (t_c < bt) | ((t_c == bt) & (t_c < T_MAX_F) & (ids < best_i[ll]))
            best_t[ll[better]] = t_c[better]
            best_i[ll[better]] = ids[better]
            best_u[ll[better]] = u[better]
            best_v[ll[better]] = v[better]
        near_first_step(walk, at_leaf, oc, inv, best_t, ops)
    _tally(ops, "sph", b * sph.shape[0])
    return _with_spheres((best_t, best_i, best_u, best_v), sph, sph_base, oc, dc, occlusion)
