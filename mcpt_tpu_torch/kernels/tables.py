"""The megakernel's scene tables (counterpart of
`mcpt_tpu/kernels/megakernel.py:2822-2877` `mega_tables`).

`mega_tables(pack)` cuts the eight tables the brute-force regen kernel reads
from a `ScenePack`, with the same layouts and float32 arithmetic as the JAX
function (so they are bitwise equal to it). `bvh_tables(pack, tri)` lays out
the BVH that the kernel walks for scenes above `MEGA_MAX_TRIS` triangles, and the
env map rides along at full resolution. `SceneTables` holds them all as
registered buffers of an `nn.Module`, so `.to(device)` moves the scene, plus
the static ints the kernel specializes on. `walk_tables(pack)` cuts the same
tree for the wavefront intersector's walk (`csrc/intersect_prims.cu`).
"""

from typing import NamedTuple

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
#   bvh  (R, 16): the BVH's child-pair rows, one per interior node (row 0
#                the root's): child 0's box min(3) max(3), child 1's box
#                min(3) max(3), both inflated (`bvh_tables`), then per child
#                (link, count) as int32 bit-cast to float32 (none negative,
#                so no NaN patterns): count > 0 a leaf of `count` rows of
#                `leaf_tri` from row `link`; count 0 an interior child whose
#                row is `link` >= 1 (row 0 is no child), or empty if link 0
#                (so is a leaf that holds spheres only)
#   leaf_tri (L, 28): the triangle rows of `tri` (cols 0-24) in leaf order,
#                at the kernel's 16-byte row stride; col 25 the row's index
#                in `tri` (int32 bit-cast), which breaks ties; spheres stay
#                out (the kernel tests them by brute force)
EXTRA = ("env", "bvh", "leaf_tri")
STATIC = (
    "n_emitters", "n_sph_emitters", "n_dir_sample", "enable_shadow",
    "any_textured", "use_env", "use_bvh", "bvh_depth",
)
NODE_COLS = 16
LEAF_COLS = 28  # csrc/mega_common.cuh kTriSmem
# the column of `leaf_tri` that holds a row's index in `tri`
LEAF_ID = 25
# the column of a walk leaf row (tri_sc's layout) that holds its index in
# tri_sc, as int32 bits: tri_sc's last pad column (csrc/intersect_prims.cu
# kWalkId)
WALK_ID = 15


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


def bvh_children(miss, leaf) -> list:
    """[(i + 1, miss[i + 1]) for each interior node i] of the flat tree
    (`bvh.FlatBVH` layout: DFS preorder, `leaf` marks the leaves), checking
    that they are i's children: the right child follows the left child's
    subtree and inherits i's miss link."""
    kids = []
    for i in np.flatnonzero(~leaf):
        c0, c1 = i + 1, miss[i + 1]
        if not (c0 < c1 and miss[c1] == miss[i]):
            raise ValueError(f"BVH node {i}: not a threaded DFS preorder")
        kids.append((c0, c1))
    return kids


def bvh_depth(miss, leaf) -> int:
    """Levels of the flat tree, from the root to its deepest leaf."""
    depth = np.ones(len(miss), np.int64)
    for i, (c0, c1) in zip(np.flatnonzero(~leaf), bvh_children(miss, leaf)):
        depth[c0] = depth[c1] = depth[i] + 1  # parents precede their children
    return int(depth.max(initial=0))


def bvh_tables(pack, tri) -> tuple:
    """(bvh (R, 16) float32, leaf_tri (L, 28) float32) for the kernel's BVH
    walks (see `EXTRA`), from the pack's flat BVH (`bvh_*` fields, sphere
    ids >= `t_pad`) and the triangle table `tri` (`mega_tables`).

    The flat tree is threaded in DFS preorder: interior node i's children
    are i + 1 and miss[i + 1], and the right child inherits its parent's
    miss link, which this function checks. A root that is a leaf becomes
    one row with an empty second child. Any depth is taken: the walks of a
    tree deeper than BVH_STACK levels keep their stack in device memory
    (`SceneTables.bvh_depth` picks them).

    Child boxes are inflated by max(EPSILON, 1e-5 x the largest coordinate):
    the Woop test can accept a hit a few float32 ULPs of the coordinates
    outside its triangle's exact box, and the slab test rounds too, so exact
    boxes could cull a grazing hit that the brute sweep finds. The walks stay
    exact: inflation only adds node visits."""
    if not pack.use_bvh:
        return np.zeros((1, NODE_COLS), np.float32), np.zeros((1, LEAF_COLS), np.float32)
    lo = np.asarray(pack.bvh_min, np.float64)
    hi = np.asarray(pack.bvh_max, np.float64)
    miss = np.asarray(pack.bvh_miss, np.int64)
    start = np.asarray(pack.bvh_leaf_start, np.int64)
    count = np.asarray(pack.bvh_leaf_count, np.int64)
    prims = np.asarray(pack.bvh_prims, np.int64)
    leaf = start >= 0
    finite = np.isfinite(lo) & np.isfinite(hi)
    scale = float(np.abs(np.where(finite, lo, 0.0)).max(initial=0.0))
    scale = max(scale, float(np.abs(np.where(finite, hi, 0.0)).max(initial=0.0)))
    pad = max(EPSILON, 1e-5 * scale)
    box = np.empty((lo.shape[0], 6), np.float32)
    box[:, 0:3] = lo - pad
    box[:, 3:6] = hi + pad

    # leaf triangle rows in leaf (preorder) order; a leaf's (first row, count)
    rows, first, n_tri = [], np.zeros(len(miss), np.int64), np.zeros(len(miss), np.int64)
    at = 0
    for i in np.flatnonzero(leaf):
        ids = prims[start[i]: start[i] + count[i]]
        ids = ids[ids < pack.t_pad]  # spheres stay out
        rows.append(ids)
        first[i], n_tri[i] = at, ids.size
        at += ids.size
    tri_ids = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    leaf_tri = np.zeros((max(at, 1), LEAF_COLS), np.float32)
    leaf_tri[:at, : tri.shape[1]] = tri[tri_ids]
    leaf_tri[:at, LEAF_ID] = tri_ids.astype(np.int32).view(np.float32)

    interior = np.flatnonzero(~leaf)
    row_of = np.full(len(miss), -1, np.int64)
    row_of[interior] = np.arange(interior.size)

    def child(c):  # (link, count) of node c; a leaf of spheres only is empty
        if not leaf[c]:
            return row_of[c], 0
        return (first[c], n_tri[c]) if n_tri[c] else (0, 0)

    # one row per interior node; a root that is a leaf, one row with an
    # empty second child
    kids = bvh_children(miss, leaf) if interior.size else [(0, -1)]
    bvh = np.zeros((len(kids), NODE_COLS), np.float32)
    links = np.zeros((len(kids), 4), np.int32)
    for r, (c0, c1) in enumerate(kids):
        bvh[r, 0:6] = box[c0]
        links[r, 0:2] = child(c0)
        if c1 >= 0:
            bvh[r, 6:12] = box[c1]
            links[r, 2:4] = child(c1)
    bvh[:, 12:16] = links.view(np.float32)
    return bvh, leaf_tri


def pack_depth(pack) -> int:
    """Levels of the pack's flat BVH (0 without one)."""
    if not pack.use_bvh:
        return 0
    return bvh_depth(np.asarray(pack.bvh_miss, np.int64), np.asarray(pack.bvh_leaf_start) >= 0)


class WalkTables(NamedTuple):
    """The wavefront intersector's BVH walk tables (`walk_tables`), numpy
    arrays or, on a moved pack (`scene.pack_to`), tensors."""

    bvh: object  # (R, 16) float32: `bvh_tables`' child-pair rows
    leaf: object  # (L, 16) float32: tri_sc rows in leaf order, col WALK_ID the row
    depth: int  # the tree's levels: above BVH_STACK the kernel walks with a device stack


def walk_tables(pack) -> WalkTables:
    """The tables of the wavefront intersector's walk mode for a pack with a
    BVH: the child-pair rows exactly as `bvh_tables` lays them out (the
    same inflation, empty children for leaves of spheres only, any depth),
    and the pack's tri_sc rows in
    leaf order in tri_sc's 16-column layout, column WALK_ID holding each
    row's index in tri_sc as non-negative int32 bits (the tie rule and the
    returned prim). Spheres stay out: the kernel tests them after the walk."""
    if not pack.use_bvh:
        raise ValueError("the pack has no BVH to walk")
    bvh, rows = bvh_tables(pack, np.asarray(pack.tri_sc))
    leaf = np.ascontiguousarray(rows[:, :NODE_COLS])
    leaf[:, WALK_ID] = rows[:, LEAF_ID]
    return WalkTables(bvh, leaf, pack_depth(pack))


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
        bvh_depth: int = 0,
        device=None,
    ):
        super().__init__()
        for name, cols in TABLE_COLS.items():
            t = torch.tensor(np.asarray(tables[name], np.float32))
            if t.ndim != 2 or t.shape[1] != cols or t.shape[0] < 1:
                raise ValueError(f"table {name}: shape {tuple(t.shape)}, want (rows, {cols})")
            self.register_buffer(name, t.to(device).contiguous())
        env = tables.get("env", np.zeros((1, 1, 3), np.float32))
        bvh = tables.get("bvh", np.zeros((1, NODE_COLS), np.float32))
        leaf_tri = tables.get("leaf_tri", np.zeros((1, LEAF_COLS), np.float32))
        for name, arr in (("env", env), ("bvh", bvh), ("leaf_tri", leaf_tri)):
            self.register_buffer(name, torch.tensor(np.asarray(arr, np.float32)).to(device).contiguous())
        if (self.env.ndim != 3 or self.env.shape[2] != 3 or self.bvh.shape[1:] != (NODE_COLS,)
                or self.leaf_tri.shape[1:] != (LEAF_COLS,)):
            raise ValueError(f"env must be (H, W, 3), bvh (N, {NODE_COLS}), "
                             f"leaf_tri (L, {LEAF_COLS})")
        self.n_emitters = int(n_emitters)
        self.n_sph_emitters = int(n_sph_emitters)
        self.n_dir_sample = int(n_dir_sample)
        self.enable_shadow = bool(enable_shadow)
        self.any_textured = bool(any_textured)
        self.use_env = bool(use_env)
        self.use_bvh = bool(use_bvh)
        # the tree's levels: above BVH_STACK the kernels take their deep
        # instances, whose walk stacks live in device memory
        self.bvh_depth = int(bvh_depth)

    @classmethod
    def from_pack(cls, pack, device=None) -> "SceneTables":
        if not pack.use_bvh and pack.tri_sc.shape[0] > MEGA_MAX_TRIS:
            # such a pack's occluder table is a dummy (mcpt_tpu/scene.py:559)
            raise ValueError(
                f"{pack.tri_sc.shape[0]} triangle rows > {MEGA_MAX_TRIS} and no BVH: "
                "compile the scene with cluster_threshold <= its triangle count"
            )
        tables = mega_tables(pack)
        tables["bvh"], tables["leaf_tri"] = bvh_tables(pack, tables["tri"])
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
            bvh_depth=pack_depth(pack),
            device=device,
        )

    @property
    def device(self) -> torch.device:
        return self.tri.device

    def static(self) -> dict:
        return {k: getattr(self, k) for k in STATIC}

    def extra_repr(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self.static().items())
