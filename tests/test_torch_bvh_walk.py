"""The BVH walks over child-pair rows, on the CPU: `kernels/tables.py`'s
`bvh_tables` against the flat tree it is cut from, and the plain versions'
near-first `bvh_nearest` and shared-mask `bvh_fan` against the brute-force
sweeps, on the x4-scaled Cornell box of tests/test_megakernel.py:207-279
(chessboard-scale coordinates) with cluster_threshold=8.

- The node table encodes the flat tree: walking it from row 0 reaches every
  row once and every leaf triangle once, each child box is the flat node's
  box inflated as `bvh_tables` says, a leaf of spheres only is the empty
  child, and the tree fits the walks' stack. On a chain whose every other
  leaf holds a sphere only, both walks equal the brute sweeps.
- A tree of more levels than the kernels' local stack (`chain_pack`, from
  chip_smoke.py) is taken, and walked to the brute sweep's answers, as is
  one of exactly as many. A flat tree that is not threaded in DFS preorder
  is refused.
- `bvh_nearest` gives the brute sweep's hit record bitwise (t, the triangle
  row on equal t, spheres after triangles) on random rays and on rays aimed
  at edges two triangles share, where equal t occurs; `bvh_fan` gives the
  brute fan's visibility bits for fans of 1 to 32 rays from one origin.

This file imports neither jax nor mcpt_tpu: the card's test file
(tests/test_torch_cuda.py) borrows it, and with
tests/test_torch_intersect_walk.py `fold_case`, the intersector walk's
signed-zero ties.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import chain_pack, cornell_x4
from mcpt_tpu_torch.constants import BVH_STACK, EPSILON, T_MAX
from mcpt_tpu_torch.kernels.megakernel_ref import (
    _tri_candidates,
    bvh_fan,
    bvh_nearest,
    intersect_tile,
    occlude_shared_origin,
)
from mcpt_tpu_torch.kernels.tables import (
    WALK_ID,
    SceneTables,
    WalkTables,
    bvh_depth,
    mega_tables,
)
from mcpt_tpu_torch.materials import Material
from mcpt_tpu_torch.scene import Scene, TriangleMesh, pack_to

K = 4.0


@pytest.fixture(scope="module")
def x4():
    """(pack with a BVH, brute-force tables, BVH tables) of the x4 box."""
    sc = cornell_x4(sky=False)
    pack = sc.compile(cluster_threshold=8)
    return pack, SceneTables.from_pack(sc.compile()), SceneTables.from_pack(pack)


def _t3(x):
    return tuple(torch.tensor(np.ascontiguousarray(x[:, k], np.float32)) for k in range(3))


def fold_case():
    """Two triangles that meet at the origin in different planes, their
    tri_sc rows (0 and 1) held by hand-made walk tables in one leaf in the
    other order (row 1 tested first), and 64 rays from the origin: each
    triangle returns t = +0 or -0 there (the sign of zero follows the
    direction's side of its plane). Returns (pack, tables, oc, dc, tie),
    `tie` marking the rays whose two zeros differ in sign."""
    pos = np.float32([[[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 0, 0], [0, 0, 1], [1, 0, 0]]])
    sc = Scene()
    sc.add(TriangleMesh(pos, np.zeros((2, 3, 2), np.float32), Material(), "fold"))
    pack = pack_to(sc.compile(), "cpu")
    node = np.zeros((1, 16), np.float32)
    node[0, 0:6] = (-1.0, -1.0, -1.0, 2.0, 2.0, 2.0)  # child 0's box; child 1 empty
    node.view(np.int32)[0, 12:16] = (0, 2, 0, 0)  # child 0: leaf rows 0-1
    leaf = pack.tri_sc[[1, 0]].clone()
    leaf.view(torch.int32)[:, WALK_ID] = torch.tensor([1, 0], dtype=torch.int32)
    tables = WalkTables(torch.from_numpy(node), leaf, 1)
    d = np.random.default_rng(1).normal(size=(64, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    oc, dc = _t3(np.zeros((64, 3), np.float32)), _t3(d)
    t, _, _ = _tri_candidates(pack.tri_sc[:2], oc, dc)
    tie = (t[:, 0] == 0) & (t[:, 1] == 0) & (torch.signbit(t[:, 0]) != torch.signbit(t[:, 1]))
    return pack, tables, oc, dc, tie


def _random_rays(rng, n):
    lo = np.float32([0.0, 0.0, -200.0 * K])
    hi = np.float32([556.0 * K, 548.8 * K, 559.2 * K])
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _shared_edge_points(pack, rng, n):
    """n points on edges that two triangles of the pack share."""
    mt = np.asarray(pack.tri_mt)[np.asarray(pack.tri_valid)]
    v = np.stack([mt[:, 0:3], mt[:, 0:3] + mt[:, 3:6], mt[:, 0:3] + mt[:, 6:9]], 1)
    owners = {}
    for t, tri in enumerate(v):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((tuple(tri[a].round(3)), tuple(tri[b].round(3)))))
            owners.setdefault(key, []).append((tri[a], tri[b]))
    edges = [e[0] for e in owners.values() if len(e) >= 2]
    assert len(edges) >= 8
    pick = rng.integers(0, len(edges), n)
    s = rng.uniform(0.05, 0.95, (n, 1))
    a = np.stack([edges[i][0] for i in pick])
    b = np.stack([edges[i][1] for i in pick])
    return (a + s * (b - a)).astype(np.float32)


def _edge_rays(pack, rng, n):
    """Rays from random points in the box aimed at shared edges."""
    target = _shared_edge_points(pack, rng, n)
    o, _ = _random_rays(rng, n)
    d = target - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _fields(rec):  # (t, happened, p, n, uv, mat, emissive), tuples flattened
    return [x for f in rec for x in (f if isinstance(f, tuple) else (f,))]


def _check_node_table(pack, bvh):
    """Walking the node table from row 0 reaches every row once and every
    leaf triangle once, in the flat tree's order; each child box is the flat
    node's, inflated; a leaf child is its rows of `leaf_tri`, or the empty
    child (0, 0) when it holds spheres only."""
    nodes = bvh.bvh.numpy()
    links = nodes.view(np.int32)[:, 12:16]
    leaf_tri = bvh.leaf_tri.numpy()
    ids = leaf_tri.view(np.int32)[:, 25]
    miss = np.asarray(pack.bvh_miss)
    start, count = np.asarray(pack.bvh_leaf_start), np.asarray(pack.bvh_leaf_count)
    prims = np.asarray(pack.bvh_prims)
    lo, hi = np.asarray(pack.bvh_min, np.float64), np.asarray(pack.bvh_max, np.float64)
    pad = max(EPSILON, 1e-5 * max(np.abs(lo).max(), np.abs(hi).max()))
    rows_seen = np.zeros(nodes.shape[0], int)
    leaf_seen = np.zeros(leaf_tri.shape[0], int)
    stack = [(0, 0)]  # (row, flat node)
    while stack:
        row, i = stack.pop()
        rows_seen[row] += 1
        for k, c in enumerate((i + 1, miss[i + 1])):
            np.testing.assert_array_equal(nodes[row, 6 * k: 6 * k + 3], (lo[c] - pad).astype(np.float32))
            np.testing.assert_array_equal(nodes[row, 6 * k + 3: 6 * k + 6], (hi[c] + pad).astype(np.float32))
            link, cnt = links[row, 2 * k: 2 * k + 2]
            if start[c] >= 0:  # a leaf: its triangle rows, in the flat tree's order
                want = prims[start[c]: start[c] + count[c]]
                want = want[want < pack.t_pad]
                assert (link, cnt) == (0, 0) if want.size == 0 else cnt == want.size
                np.testing.assert_array_equal(ids[link: link + cnt], want)
                leaf_seen[link: link + cnt] += 1
            else:
                assert cnt == 0 and link >= 1
                stack.append((link, c))
    assert (rows_seen == 1).all() and (leaf_seen == 1).all()
    tri = mega_tables(pack)["tri"]
    np.testing.assert_array_equal(leaf_tri[:, :25], tri[ids])
    assert sorted(ids) == sorted(prims[(prims >= 0) & (prims < pack.t_pad)])
    return miss, start


def test_node_table_encodes_the_flat_tree(x4):
    pack, _, bvh = x4
    miss, start = _check_node_table(pack, bvh)
    assert bvh_depth(miss, start >= 0) <= BVH_STACK


def test_tree_deeper_than_the_stack_is_refused(x4):
    """Nothing is refused any more: a tree of BVH_STACK + 1 levels (past the
    kernels' local stack) is taken with its depth, and both walks over it,
    like one of exactly BVH_STACK levels, give the brute sweeps' answers
    bitwise."""
    _, brute, _ = x4
    o, d = _random_rays(np.random.default_rng(5), 512)
    want = intersect_tile(brute.tri, brute.sph, _t3(o), _t3(d))
    for levels in (BVH_STACK, BVH_STACK + 1):
        deep = SceneTables.from_pack(chain_pack(levels))
        assert deep.bvh_depth == levels
        got = bvh_nearest(deep, _t3(o), _t3(d), torch.ones(512, dtype=torch.bool))
        for a, b in zip(_fields(got), _fields(want), strict=True):
            assert torch.equal(a, b)


def test_tree_out_of_preorder_is_refused():
    """A flat tree whose miss links do not thread a DFS preorder (here a
    right child that does not inherit its parent's miss link) is refused."""
    pack = chain_pack(4)
    miss = np.asarray(pack.bvh_miss).copy()
    miss[2] = 1  # interior node 2, node 0's right child: its miss must be -1
    with pytest.raises(ValueError, match="preorder"):
        SceneTables.from_pack(dataclasses.replace(pack, bvh_miss=miss))


def test_sphere_only_leaves_are_empty_children(x4):
    """Leaves that hold a sphere and no triangle (every other leaf of a
    chain) become empty children, not links into rows of the table, and
    both walks over them equal the brute sweeps, spheres included."""
    _, brute, _ = x4
    pack = chain_pack(12, sphere_leaves=True)
    tables = SceneTables.from_pack(pack)
    _check_node_table(pack, tables)
    rng = np.random.default_rng(3)
    n = 1024
    o, d = _random_rays(rng, n)
    live = torch.ones(n, dtype=torch.bool)
    want = intersect_tile(brute.tri, brute.sph, _t3(o), _t3(d))
    got = bvh_nearest(tables, _t3(o), _t3(d), live)
    for a, b in zip(_fields(got), _fields(want), strict=True):
        assert torch.equal(a, b)
    p = _random_rays(rng, n)[0]
    dist = np.sqrt(((p - o) ** 2).sum(1)).astype(np.float32)
    ds, dists = [_t3(((p - o) / dist[:, None]).astype(np.float32))], [torch.tensor(dist)]
    want = occlude_shared_origin(brute.tri, brute.sph, _t3(o), ds, dists)
    got = bvh_fan(tables, _t3(o), ds, dists, live)
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("rays", ["random", "shared_edges"])
def test_near_first_nearest_equals_brute_sweep(x4, rays):
    """Every field of the hit record bitwise equal; at shared edges some
    rays meet two triangles at equal t, and the lower row wins in both."""
    pack, brute, bvh = x4
    rng = np.random.default_rng(11)
    n = 4096
    o, d = _random_rays(rng, n) if rays == "random" else _edge_rays(pack, rng, n)
    want = intersect_tile(brute.tri, brute.sph, _t3(o), _t3(d))
    got = bvh_nearest(bvh, _t3(o), _t3(d), torch.ones(n, dtype=torch.bool))
    assert 0.5 < got[1].float().mean().item() <= 1.0  # happened
    for a, b in zip(_fields(got), _fields(want), strict=True):
        assert torch.equal(a, b)
    if rays == "shared_edges":
        t, _, _ = _tri_candidates(brute.tri, _t3(o), _t3(d))
        t_min = t.min(dim=-1, keepdim=True).values
        ties = ((t == t_min) & (t_min < T_MAX)).sum(dim=-1) >= 2
        assert ties.sum().item() >= 10, ties.sum().item()


@pytest.mark.parametrize("n_rays", [1, 4, 7, 32])
def test_shared_fan_equals_brute_fan(x4, n_rays):
    """Fans of 1 to 32 rays sharing an origin, half towards random points
    and half towards shared edges (grazing blockers): the visibility bits of
    the one shared walk equal the brute fan's over every triangle."""
    pack, brute, bvh = x4
    rng = np.random.default_rng(n_rays)
    n = 1024
    o, _ = _random_rays(rng, n)
    ds, dists = [], []
    for si in range(n_rays):
        p = _random_rays(rng, n)[0] if si % 2 == 0 else _shared_edge_points(pack, rng, n)
        delta = p - o
        dist = np.sqrt((delta * delta).sum(1)).astype(np.float32)
        ds.append(_t3((delta / dist[:, None]).astype(np.float32)))
        dists.append(torch.tensor(dist))
    live = torch.tensor(rng.uniform(size=n) < 0.9)
    want = occlude_shared_origin(brute.tri, brute.sph, _t3(o), ds, dists)
    got = bvh_fan(bvh, _t3(o), ds, dists, live)
    assert len(got) == n_rays
    seen = torch.stack(got)[:, live]
    assert 0.05 < seen.float().mean().item() < 0.95
    for a, b in zip(got, want):
        assert torch.equal(a[live], b[live])
