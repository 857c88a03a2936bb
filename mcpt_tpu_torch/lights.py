"""Area-light sampling over the emitter rows (counterpart of
`mcpt_tpu/lights.py:40-106`).

The reference's two-stage pick: an emitter mesh with probability ∝ its area
(`Scene::sampleLight`, Scene.cpp:23-37), then a triangle of that mesh by the
BVH area descent with its √u warp (BVH.cpp:131-135), then a point with the
x = √u barycentric warp (Triangle.hpp:71-76); pdf = 1/mesh_area. Emissive
spheres get a uniform point on their surface.
"""

import math
from typing import NamedTuple

import torch

from mcpt_tpu_torch.kernels.megakernel_ref import sqrt_f32 as _sqrt
from mcpt_tpu_torch.kernels.megakernel_ref import take_rows


class LightSampleC(NamedTuple):
    p: tuple  # 3 x (B,) point on the light
    n: tuple  # 3 x (B,) light normal
    emit: torch.Tensor  # (B,) emission at the lane's channel
    pdf: torch.Tensor  # (B,) area pdf (1/mesh_area)


def _sphere_point(row, u2, u3):
    """Uniform point on an emissive sphere row (columns `row`: c = 0:3, r =
    3): y = 1 - 2a, azimuth 2πb."""
    ys = 1.0 - 2.0 * u2
    s = _sqrt(torch.clamp_min(1.0 - ys * ys, 0.0))
    ph = 2.0 * math.pi * u3
    dv = (s * torch.cos(ph), ys, s * torch.sin(ph))
    r = row[3]
    p = tuple(row[k] + r * dv[k] for k in range(3))
    return p, dv


def pick(pack, u):
    """The two-stage emitter pick: (int64 emitter row, mesh_area). The mesh
    is the count of lmesh_cum's entries below u0 · total area (a binary
    search); the row is the mesh's first whose intra-mesh cumulative area
    exceeds sqrt(u1) · mesh_area, else its last (a binary search over the
    mesh's rows, `ScenePack.lmesh_first` and `lmesh_count`), both as
    `csrc/wf_lights.cuh` light_pick searches."""
    e = pack.emt_mesh.shape[0]
    target = u[:, 0] * float(pack.emit_total_area)
    mesh = torch.searchsorted(pack.lmesh_cum, target, right=False)
    mesh = mesh.clamp(0, pack.lmesh_cum.shape[0] - 1)
    mesh_area = pack.lmesh_area[mesh]
    p_tgt = _sqrt(u[:, 1]) * mesh_area
    lo = pack.lmesh_first[mesh].to(torch.int64)
    end = lo + pack.lmesh_count[mesh].to(torch.int64)
    hi = end
    for _ in range(int(pack.lmesh_count.max()).bit_length()):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        active = lo < hi
        right = ~(p_tgt < pack.emt_intra_cum[mid.clamp(max=e - 1)])
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    sel = torch.where(lo < end, lo, end - 1).clamp(0, e - 1)
    return sel, mesh_area


def light_point(row, mesh_area, u2, u3, chan, spheres: bool) -> LightSampleC:
    """The sample on the picked emitter row (its 17 columns `row`) from the
    draws u2, u3: p = v0 + e1·x(1-y) + e2·xy with x = √u2, y = u3, or with
    `spheres` a uniform point where the row is an emissive sphere."""
    x, y = _sqrt(u2), u3
    wx = x * (1.0 - y)
    wy = x * y
    p = tuple(row[k] + row[3 + k] * wx + row[6 + k] * wy for k in range(3))
    n = (row[9], row[10], row[11])
    if spheres:
        is_se = row[16] > 0.5
        ps, ns = _sphere_point(row, u2, u3)
        p = tuple(torch.where(is_se, ps[k], p[k]) for k in range(3))
        n = tuple(torch.where(is_se, ns[k], n[k]) for k in range(3))
    emit = torch.where(chan == 0, row[12], torch.where(chan == 1, row[13], row[14]))
    pdf = 1.0 / torch.clamp_min(mesh_area, 1e-20)
    return LightSampleC(p=p, n=n, emit=emit, pdf=pdf)


def sample_light_c(pack, u, chan) -> LightSampleC:
    """u: (B, 4) uniforms, chan (B,) → a light sample per lane. Requires
    pack.n_emitters > 0."""
    sel, mesh_area = pick(pack, u)
    row = take_rows(pack.emt_fat, sel).unbind(1)
    return light_point(row, mesh_area, u[:, 2], u[:, 3], chan, bool(pack.n_sph_emitters))
