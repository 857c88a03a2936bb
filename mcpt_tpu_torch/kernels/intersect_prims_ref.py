"""Plain PyTorch version of the wavefront intersectors K2, K3 and K4
(`mcpt_tpu/kernels/intersect_pallas.py` `_kernel_sc`, `_kernel_mm`,
`_kernel`), the function `csrc/intersect_prims.cu` computes.

Per (ray, triangle row) it runs `_tri_candidate`'s arithmetic in its order
(`megakernel_ref._woop`, the same Woop test the megakernel's sweeps use)
plus K3/K4's `valid` test, and per (ray, sphere) `_sph_candidate`'s q-form
(`megakernel_ref._sph_candidates`). The nearest hit is the first minimum in
table order, triangles before spheres: the kernels' strict `<` winner. The
rows are swept in chunks so that the (rays, rows) temporaries stay bounded.
"""

import torch

from mcpt_tpu_torch.kernels.megakernel_ref import T_MAX_F, _sph_candidates, _woop

# (rays x rows) elements per chunk of the sweep
CHUNK_PAIRS = 1 << 22


def _tri_chunk(tri, o, d):
    """(t_cand, u, v) of every ray against the rows `tri` (k, 16)."""
    t, u, v = _woop(
        [tri[:, c] for c in range(13)],
        tuple(x[:, None] for x in o),
        tuple(x[:, None] for x in d),
    )
    return torch.where(tri[:, 13] > 0.5, t, T_MAX_F), u, v


def intersect_prims_ref(tri, sph, sph_base, oc, dc, occlusion=False):
    """Nearest hit of the rays (oc, dc) (3-tuples of (B,) float32) against
    the triangle rows `tri` (T, 16) in tri_sc's layout and the spheres `sph`
    (S, 4), S = 0 for triangles only. Returns (t, prim, u, v): t float32
    (T_MAX on a miss), prim int32 (-1 on a miss, `sph_base + s` for sphere
    s), u and v (0 unless a triangle wins); occlusion=True returns t and
    three Nones."""
    b = oc[0].shape[0]
    dev = oc[0].device
    t_best = torch.full((b,), T_MAX_F, dtype=torch.float32, device=dev)
    prim = torch.full((b,), -1, dtype=torch.int64, device=dev)
    u_best = torch.zeros_like(t_best)
    v_best = torch.zeros_like(t_best)
    step = max(8, CHUNK_PAIRS // max(b, 1))
    for lo in range(0, tri.shape[0], step):
        t, u, v = _tri_chunk(tri[lo:lo + step], oc, dc)
        if occlusion:
            t_best = torch.minimum(t_best, t.min(dim=1).values)
            continue
        idx = torch.argmin(t, dim=1, keepdim=True)
        tc = torch.gather(t, 1, idx)[:, 0]
        better = tc < t_best
        t_best = torch.where(better, tc, t_best)
        prim = torch.where(better, lo + idx[:, 0], prim)
        u_best = torch.where(better, torch.gather(u, 1, idx)[:, 0], u_best)
        v_best = torch.where(better, torch.gather(v, 1, idx)[:, 0], v_best)
    if sph.shape[0]:
        ts = _sph_candidates(sph, oc, dc)
        if occlusion:
            t_best = torch.minimum(t_best, ts.min(dim=1).values)
        else:
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
