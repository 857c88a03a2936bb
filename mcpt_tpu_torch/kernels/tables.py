"""The megakernel's scene tables (counterpart of
`mcpt_tpu/kernels/megakernel.py:2822-2877` `mega_tables`).

`mega_tables(pack)` cuts the eight tables the brute-force regen kernel reads
from a `ScenePack`, with the same layouts and float32 arithmetic as the JAX
function (so they are bitwise equal to it). `bvh_tables(pack)` lays out the
BVH that the kernel walks for scenes above `MEGA_MAX_TRIS` triangles, and the
env map rides along at full resolution. `SceneTables` holds them all as
registered buffers of an `nn.Module`, so `.to(device)` moves the scene, plus
the static ints the kernel specializes on.
"""

import numpy as np
import torch
from torch import nn

from mcpt_tpu_torch.constants import EPSILON, T_MAX
from mcpt_tpu_torch.scene import MEGA_MAX_TRIS

# Table name → row width. Layouts (mega_tables docstring in mcpt_tpu):
#   tri  (T8, 25): tri_sc cols 0-13 (w 9, c 3, nr2, valid), 14-16 normal,
#                  17-22 uv t0,t1,t2, 23 mat, 24 emissive
#   occ  (T8o, 16): shadow-fan occluder rows (tri_sc layout)
#   sph  (S, 6): center(3), r, mat, emissive
#   mat  (M, 13): mat_fat
#   emt  (E, 17): emt_fat
#   emeta (E, 4): mesh ordinal, intra_cum, mesh_area, intra_cum/mesh_area
#   lcum (L, 1): inclusive cumulative light-mesh areas, pad rows = T_MAX
#   par  (1, 8): bg r, g, b, rr_rate, inv_rr, total emitter area, 0, 0
TABLE_COLS = {
    "tri": 25, "occ": 16, "sph": 6, "mat": 13, "emt": 17, "emeta": 4,
    "lcum": 1, "par": 8,
}
# Further buffers (dummies when unused):
#   env  (H, W, 3): the env map, full resolution; (1, 1, 3) without one
#   bvh  (N, 8): per node min(3), max(3) (inflated by BVH_PAD), miss link,
#                leaf code start*16 + count (-1 on interior nodes)
#   prims (P,) int32: leaf-ordered triangle rows of `tri`; -1 for padding
#                and spheres (the kernel tests spheres by brute force)
EXTRA = ("env", "bvh", "prims")
STATIC = (
    "n_emitters", "n_sph_emitters", "n_dir_sample", "enable_shadow",
    "any_textured", "use_env", "use_bvh",
)
MAX_LEAF = 15  # leaf counts live in the code's low 4 bits
MAX_LEAF_START = 1 << 20  # start*16 + count stays an exact float32 integer


def mega_tables(pack) -> dict:
    """Dict of the eight (rows, cols) float32 numpy tables for `pack`."""
    t8 = pack.tri_sc.shape[0]
    f32 = np.float32
    tri = np.concatenate([pack.tri_sc[:, :14], pack.tri_shade[:t8, :]], axis=1)
    sph = np.concatenate([pack.sph_geom, pack.sph_shade[:, 3:5]], axis=1)
    emeta = np.stack(
        [
            pack.emt_mesh.astype(f32),
            pack.emt_intra_cum,
            pack.emt_mesh_area,
            pack.emt_intra_cum / np.maximum(pack.emt_mesh_area, f32(1e-20)),
        ],
        axis=1,
    )
    # pad rows past the real light-mesh count must never be counted by the
    # kernel's "cum < target" pick, so they become +big
    lcum = np.where(pack.lmesh_cum > 0.0, pack.lmesh_cum, T_MAX)[:, None]
    bg = np.asarray(pack.background, f32)
    par = np.array(
        [[bg[0], bg[1], bg[2], pack.rr_rate, pack.inv_rr,
          pack.emit_total_area, 0.0, 0.0]],
        f32,
    )
    out = {
        "tri": tri, "occ": pack.tri_occ_sc, "sph": sph, "mat": pack.mat_fat,
        "emt": pack.emt_fat, "emeta": emeta, "lcum": lcum, "par": par,
    }
    return {k: np.ascontiguousarray(v, dtype=f32) for k, v in out.items()}


def bvh_tables(pack) -> tuple:
    """(bvh (N, 8) float32, prims (P,) int32) for the kernel's BVH walk,
    from the pack's flat BVH (`bvh_*` fields, sphere ids >= `t_pad`).

    Node boxes are inflated by max(EPSILON, 1e-5 x the largest coordinate):
    the Woop test can accept a hit a few float32 ULPs of the coordinates
    outside its triangle's exact box, and the slab test rounds too, so exact
    boxes could cull a grazing hit that the brute sweep finds. The walk stays
    exact: inflation only adds node visits."""
    if not pack.use_bvh:
        return np.zeros((1, 8), np.float32), np.full(1, -1, np.int32)
    lo = np.asarray(pack.bvh_min, np.float64)
    hi = np.asarray(pack.bvh_max, np.float64)
    count = np.asarray(pack.bvh_leaf_count, np.int64)
    start = np.asarray(pack.bvh_leaf_start, np.int64)
    if count.max(initial=0) > MAX_LEAF or start.max(initial=0) >= MAX_LEAF_START:
        raise ValueError(f"BVH leaves must hold <= {MAX_LEAF} prims, start < {MAX_LEAF_START}")
    finite = np.isfinite(lo) & np.isfinite(hi)
    scale = float(np.abs(np.where(finite, lo, 0.0)).max(initial=0.0))
    scale = max(scale, float(np.abs(np.where(finite, hi, 0.0)).max(initial=0.0)))
    pad = max(EPSILON, 1e-5 * scale)
    bvh = np.empty((lo.shape[0], 8), np.float32)
    bvh[:, 0:3] = lo - pad
    bvh[:, 3:6] = hi + pad
    bvh[:, 6] = pack.bvh_miss
    bvh[:, 7] = np.where(start >= 0, start * 16 + count, -1)
    prims = np.asarray(pack.bvh_prims, np.int32)
    prims = np.where(prims >= pack.t_pad, -1, prims).astype(np.int32)
    return bvh, prims


class SceneTables(nn.Module):
    """The megakernel's scene: eight float32 buffers (see `TABLE_COLS`),
    the `EXTRA` buffers and the static ints `STATIC`. No parameters; the
    module exists so that `.to(device)` moves the whole scene."""

    def __init__(
        self,
        tables: dict,
        *,
        n_emitters: int,
        n_sph_emitters: int,
        n_dir_sample: int,
        enable_shadow: bool,
        any_textured: bool,
        use_env: bool = False,
        use_bvh: bool = False,
        device=None,
    ):
        super().__init__()
        for name, cols in TABLE_COLS.items():
            t = torch.tensor(np.asarray(tables[name], np.float32))
            if t.ndim != 2 or t.shape[1] != cols or t.shape[0] < 1:
                raise ValueError(f"table {name}: shape {tuple(t.shape)}, want (rows, {cols})")
            self.register_buffer(name, t.to(device).contiguous())
        env = tables.get("env", np.zeros((1, 1, 3), np.float32))
        bvh = tables.get("bvh", np.zeros((1, 8), np.float32))
        prims = tables.get("prims", np.full(1, -1, np.int32))
        for name, arr, dtype in (
            ("env", env, np.float32), ("bvh", bvh, np.float32), ("prims", prims, np.int32)
        ):
            self.register_buffer(name, torch.tensor(np.asarray(arr, dtype)).to(device).contiguous())
        if self.env.ndim != 3 or self.env.shape[2] != 3 or self.bvh.ndim != 2 or self.bvh.shape[1] != 8:
            raise ValueError("env must be (H, W, 3) and bvh (N, 8)")
        self.n_emitters = int(n_emitters)
        self.n_sph_emitters = int(n_sph_emitters)
        self.n_dir_sample = int(n_dir_sample)
        self.enable_shadow = bool(enable_shadow)
        self.any_textured = bool(any_textured)
        self.use_env = bool(use_env)
        self.use_bvh = bool(use_bvh)

    @classmethod
    def from_pack(cls, pack, device=None) -> "SceneTables":
        if not pack.use_bvh and pack.tri_sc.shape[0] > MEGA_MAX_TRIS:
            # such a pack's occluder table is a dummy (mcpt_tpu/scene.py:559)
            raise ValueError(
                f"{pack.tri_sc.shape[0]} triangle rows > {MEGA_MAX_TRIS} and no BVH: "
                "compile the scene with cluster_threshold <= its triangle count"
            )
        tables = mega_tables(pack)
        tables["bvh"], tables["prims"] = bvh_tables(pack)
        tables["env"] = pack.env_pixels if pack.use_env else np.zeros((1, 1, 3), np.float32)
        return cls(
            tables,
            n_emitters=pack.n_emitters,
            n_sph_emitters=pack.n_sph_emitters,
            n_dir_sample=pack.n_dir_sample,
            enable_shadow=pack.enable_shadow,
            any_textured=bool(np.asarray(pack.mat_textured).any()),
            use_env=pack.use_env,
            use_bvh=pack.use_bvh,
            device=device,
        )

    @property
    def device(self) -> torch.device:
        return self.tri.device

    def static(self) -> dict:
        return {k: getattr(self, k) for k in STATIC}

    def extra_repr(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self.static().items())
