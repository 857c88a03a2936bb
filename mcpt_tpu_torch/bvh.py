"""Host-side BVH construction, flattened for stackless traversal (a numpy
copy of `mcpt_tpu/bvh.py`, same algorithm and output bit for bit).

Median split on the longest centroid-bounds axis (the reference's "NAIVE"
method, `BVH.cpp:27-93`) or a binned SAH. ONE tree over every primitive
(all mesh triangles and spheres), emitted in DFS preorder in the threaded
("miss-link") layout: an interior node's hit-successor is ``i + 1`` and every
node stores a miss-successor, so a traversal is one index walk with no
stack. The wavefront's `bvh` method walks it so; the megakernels walk the
child-pair rows that `kernels/tables.py::bvh_tables` cuts from it.

`native/` holds the C++ copy of this builder that the JAX package has
(`Scene.compile` takes it where g++ builds it); its SAH tree is this one,
bit for bit.
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class FlatBVH:
    node_min: np.ndarray  # (N, 3) float32
    node_max: np.ndarray  # (N, 3) float32
    node_miss: np.ndarray  # (N,) int32; -1 = traversal done
    leaf_start: np.ndarray  # (N,) int32 into prim_ids; -1 for interior nodes
    leaf_count: np.ndarray  # (N,) int32
    prim_ids: np.ndarray  # (P,) int32, leaf-grouped permutation of input prims

    @property
    def n_nodes(self) -> int:
        return self.node_min.shape[0]

    @property
    def max_leaf_count(self) -> int:
        return int(self.leaf_count.max()) if self.leaf_count.size else 0


def build_bvh(
    aabb_min: np.ndarray,
    aabb_max: np.ndarray,
    leaf_size: int = 4,
    method: str = "median",
    sah_bins: int = 16,
) -> FlatBVH:
    """Build a flattened BVH over primitives given their AABBs.

    method="median": longest-centroid-axis median split (reference
    BVH.cpp:50-89 semantics, argpartition instead of full sort).
    method="sah": binned surface-area heuristic (better trees, same layout).
    """
    n = int(aabb_min.shape[0])
    if n == 0:
        return FlatBVH(
            node_min=np.zeros((1, 3), np.float32),
            node_max=np.full((1, 3), -np.inf, np.float32),
            node_miss=np.full(1, -1, np.int32),
            leaf_start=np.zeros(1, np.int32),
            leaf_count=np.zeros(1, np.int32),
            prim_ids=np.zeros(0, np.int32),
        )
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    centroids = 0.5 * (aabb_min + aabb_max)

    # --- Phase 1: build the topology with an explicit work stack. ---------
    # Children are produced depth-first with the left child processed first,
    # so nodes are already in the DFS order the flat layout wants.
    bmin: list[np.ndarray] = []
    bmax: list[np.ndarray] = []
    left: list[int] = []  # -1 for leaves
    leaf_prims: list[np.ndarray | None] = []

    # Each stack frame: (prim ids, parent index, is_right_child).
    stack: list[tuple[np.ndarray, int, bool]] = [
        (np.arange(n, dtype=np.int64), -1, False)
    ]
    right_child: dict[int, int] = {}
    while stack:
        ids, par, is_right = stack.pop()
        idx = len(bmin)
        bmin.append(aabb_min[ids].min(axis=0))
        bmax.append(aabb_max[ids].max(axis=0))
        left.append(-1)
        leaf_prims.append(None)
        if par >= 0:
            if is_right:
                right_child[par] = idx
            else:
                left[par] = idx
        if ids.shape[0] <= leaf_size:
            leaf_prims[idx] = ids
            continue
        c = centroids[ids]
        split = _sah_split(ids, c, aabb_min, aabb_max, sah_bins) if method == "sah" else None
        if split is None:
            ext = c.max(axis=0) - c.min(axis=0)
            axis = int(np.argmax(ext))
            mid = ids.shape[0] // 2
            if ext[axis] <= 0.0:
                left_ids, right_ids = ids[:mid], ids[mid:]
            else:
                part = np.argpartition(c[:, axis], mid)
                left_ids, right_ids = ids[part[:mid]], ids[part[mid:]]
        else:
            left_ids, right_ids = split
        # Push right first so left pops first (DFS order in the arrays).
        stack.append((right_ids, idx, True))
        stack.append((left_ids, idx, False))

    n_nodes = len(bmin)

    # --- Phase 2: miss links. The pop order above IS DFS preorder (left
    # subtree fully emitted before the right child), so a node's array index
    # is already its flat index and an interior node's hit-successor is i+1.
    # The left child misses to the right sibling; the right child inherits
    # the parent's miss (parents precede children, so one forward pass).
    node_miss = np.full(n_nodes, -1, dtype=np.int32)
    leaf_start = np.full(n_nodes, -1, dtype=np.int32)
    leaf_count = np.zeros(n_nodes, dtype=np.int32)
    prim_out: list[np.ndarray] = []
    cursor = 0
    # node_miss[root]=-1; propagate top-down (parents precede children in DFS).
    for i in range(n_nodes):
        if left[i] >= 0:
            l, r = left[i], right_child[i]
            node_miss[l] = r  # right sibling = l + size[l], and r == l+size[l]
            node_miss[r] = node_miss[i]
        else:
            prims = leaf_prims[i]
            leaf_start[i] = cursor
            leaf_count[i] = prims.shape[0]
            prim_out.append(prims)
            cursor += prims.shape[0]

    return FlatBVH(
        node_min=np.asarray(bmin, np.float32),
        node_max=np.asarray(bmax, np.float32),
        node_miss=node_miss,
        leaf_start=leaf_start,
        leaf_count=leaf_count,
        prim_ids=np.concatenate(prim_out).astype(np.int32),
    )


def _sah_split(node_ids, c, aabb_min, aabb_max, nbins):
    """Binned SAH split; returns (left_ids, right_ids) or None to fall back."""
    ext = c.max(axis=0) - c.min(axis=0)
    axis = int(np.argmax(ext))
    if ext[axis] <= 0.0:
        return None
    lo = c[:, axis].min()
    binw = ext[axis] / nbins
    bins = np.minimum(((c[:, axis] - lo) / binw).astype(np.int32), nbins - 1)
    pmin, pmax = aabb_min[node_ids], aabb_max[node_ids]

    def surf(bm, bx):
        d = np.maximum(bx - bm, 0.0)
        return 2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2])

    counts = np.bincount(bins, minlength=nbins)
    best_cost, best_bin = np.inf, -1
    for b in range(1, nbins):
        nl = int(counts[:b].sum())
        nr = node_ids.shape[0] - nl
        if nl == 0 or nr == 0:
            continue
        lmask = bins < b
        sl = surf(pmin[lmask].min(axis=0), pmax[lmask].max(axis=0))
        sr = surf(pmin[~lmask].min(axis=0), pmax[~lmask].max(axis=0))
        cost = sl * nl + sr * nr
        if cost < best_cost:
            best_cost, best_bin = cost, b
    if best_bin < 0:
        return None
    lmask = bins < best_bin
    return node_ids[lmask], node_ids[~lmask]
