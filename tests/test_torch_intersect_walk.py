"""The wavefront intersector's walk mode on the CPU: `kernels/tables.py`'s
`walk_tables` against the flat tree it is cut from, and the plain walk
`intersect_walk_ref` (what `csrc/intersect_prims.cu` computes in its walk
mode, item for item) against the all-pairs plain version
`intersect_prims_ref` and against JAX's K3.

- `walk_tables` gives `bvh_tables`' child-pair rows and every triangle row
  of the tree once, in leaf order, with its tri_sc row in column WALK_ID;
  a leaf of spheres only is the empty child; a tree deeper than the
  stack is refused, by `walk_tables` and so by `pack_to(..., walk=True)`,
  while the routes that do not walk (`pack_to` without `walk`, the `bvh`
  method, the CPU's) still take it.
- `intersect_walk_ref` equals `intersect_prims_ref` bit for bit (t, prim,
  u, v; t alone in occlusion mode) on the 1,200-triangle soup with spheres,
  on a small lathe mesh standing on the DEMO's floor, at rays aimed at edges
  two triangles share (where equal t occurs and the lower row must win), at
  axis-parallel rays, at rays from inside the boxes and along box faces, and
  at rays from a vertex on two triangles' planes (t = +0 against -0, where
  occlusion mode must return the lower row's zero).
- The routed `intersect_c` / `occlude_t_c` and the plain walk agree with
  JAX's K3 (`intersect_pallas_c` / `occlude_t_c(method="pallas")`:
  `intersect_tris_pallas_mm` in interpret mode, then the spheres, as
  `mcpt_tpu/intersect.py:305-316` combines them) within
  tests/test_torch_wavefront.py's bounds (`_agree`).
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcpt_tpu.intersect as JI
import mcpt_tpu.materials as JM
import mcpt_tpu.scene as JS
from chip_smoke import SOLDIER_AT, cornell_x4, write_lathe_obj
from test_torch_bvh_walk import chain_pack, fold_case
from test_torch_wavefront import AGREE, _agree, _cols, _rays, _soup

import mcpt_tpu_torch.builtin_scenes as TB
import mcpt_tpu_torch.materials as TM
import mcpt_tpu_torch.scene as TS
from mcpt_tpu_torch.constants import BVH_STACK, T_MAX
from mcpt_tpu_torch.intersect import intersect_c, occlude_t_c
from mcpt_tpu_torch.kernels.intersect_prims_ref import intersect_prims_ref, intersect_walk_ref
from mcpt_tpu_torch.kernels.megakernel_ref import _tri_candidates
from mcpt_tpu_torch.kernels.tables import WALK_ID, bvh_tables, walk_tables
from mcpt_tpu_torch.render import render_radiance


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lathe_demo(S, B, M, tmp_path):
    """The DEMO with a small stand-in soldier (12 segments, 10 steps: 216
    triangles) on its floor, where chip_smoke.py stands the full one."""
    sc = B.demo_scene()
    path = tmp_path / "soldier.obj"
    write_lathe_obj(path, 12, 10, 260.0, 80.0, (0.0, 0.0, 0.0), "soldier")
    sc.add(S.TriangleMesh.from_obj(path, M.standard_materials()["rough_plastic"],
                                   translation=SOLDIER_AT, name="soldier"))
    return sc


@pytest.fixture(scope="module")
def soup():
    return TS.pack_to(_soup(TS, TM, spheres=True).compile(), "cpu", walk=True)


@pytest.fixture(scope="module")
def lathe(tmp_path_factory):
    sc = _lathe_demo(TS, TB, TM, tmp_path_factory.mktemp("lathe"))
    return TS.pack_to(sc.compile(cluster_threshold=64), "cpu", walk=True)


def bits_equal(got, want):
    """Outputs (t, prim, u, v; Nones in occlusion mode) equal bit for bit:
    float32 compared as int32, so +0 and -0 differ."""
    for g, w in zip(got, want, strict=True):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            gi, wi = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(gi, wi), (gi != wi).sum().item()


def _same(pack, o, d, occlusion):
    """intersect_walk_ref against intersect_prims_ref on rays (o, d): every
    output bitwise equal; returns the sweep's answers and the walk's tally."""
    oc, dc = _cols(o), _cols(d)
    want = intersect_prims_ref(pack.tri_sc, pack.sph_geom, pack.n_tris, oc, dc,
                               occlusion=occlusion)
    ops = collections.Counter()
    got = intersect_walk_ref(pack.walk.bvh, pack.walk.leaf, pack.sph_geom, pack.n_tris, oc, dc,
                             occlusion=occlusion, ops=ops, depth=pack.walk.depth)
    bits_equal(got, want)
    assert 0 < ops["woop"] <= o.shape[0] * pack.walk.leaf.shape[0]
    assert ops["slab"] == 2 * ops["row"] and ops["sph"] == o.shape[0] * pack.sph_geom.shape[0]
    return want, ops


def test_walk_tables_encode_the_flat_tree(lathe):
    """The node rows are `bvh_tables`'; the leaf rows are the tree's
    triangle rows of tri_sc, each once, in leaf order, with the row index
    in column WALK_ID; the tree fits the stack."""
    walk = walk_tables(lathe)
    bvh, leaf_tri = bvh_tables(lathe, np.asarray(lathe.tri_sc))
    np.testing.assert_array_equal(walk.bvh, bvh)
    ids = walk.leaf.view(np.int32)[:, WALK_ID]
    np.testing.assert_array_equal(ids, leaf_tri.view(np.int32)[:, 25])
    np.testing.assert_array_equal(walk.leaf[:, :WALK_ID], lathe.tri_sc[ids, :WALK_ID])
    prims = np.asarray(lathe.bvh_prims)
    assert sorted(ids) == sorted(prims[(prims >= 0) & (prims < lathe.t_pad)])
    assert len(set(ids.tolist())) == ids.size and (ids >= 0).all()
    assert 1 <= walk.depth <= BVH_STACK
    # pack_to attaches the same tables, moved
    for a, b in ((lathe.walk.bvh, walk.bvh), (lathe.walk.leaf, walk.leaf)):
        assert isinstance(a, torch.Tensor) and torch.equal(a, torch.from_numpy(b))
    assert TS.pack_to(TB.demo_scene().compile(), "cpu", walk=True).walk is None  # no tree


def test_sphere_only_leaves_and_deep_trees():
    """A leaf of spheres only is the empty child (0, 0); trees of BVH_STACK
    and BVH_STACK + 1 levels (past the kernel's local stack) are taken by
    walk_tables and pack_to(..., walk=True) with their depth, and walked to
    the sweep's answers."""
    pack = chain_pack(12, sphere_leaves=True)
    walk = walk_tables(pack)
    links = walk.bvh.view(np.int32)[:, 12:16]
    assert ((links[:, 0::2] == 0) & (links[:, 1::2] == 0)).sum() >= 5
    assert walk_tables(chain_pack(BVH_STACK + 1)).depth == BVH_STACK + 1
    for p in (pack, chain_pack(BVH_STACK), chain_pack(BVH_STACK + 1)):
        moved = TS.pack_to(p, "cpu", walk=True)
        lo, hi = np.asarray(p.bvh_min).min(0), np.asarray(p.bvh_max).max(0)
        o, d = _rays(512, lo, hi, seed=8, aim=(lo, hi))
        for occlusion in (False, True):
            _same(moved, o, d, occlusion)
    assert TS.pack_to(chain_pack(BVH_STACK), "cpu", walk=True).walk.depth == BVH_STACK


@pytest.mark.parametrize("occlusion", [False, True])
def test_walk_equals_sweep_on_the_soup(soup, occlusion):
    """2,048 rays aimed into the soup, spheres included, and 512 axis-parallel
    rays (two direction components zero) from inside it."""
    o, d = _rays(2048, -3.0, 3.0, seed=4, aim=((-1, -1, -1), (1, 1, 1)))
    want, ops = _same(soup, o, d, occlusion)
    assert (want[0] < T_MAX).float().mean().item() > 0.5
    assert ops["woop"] < 0.05 * o.shape[0] * soup.walk.leaf.shape[0]  # the walk prunes
    if not occlusion:
        assert (want[1] >= soup.n_tris).any()  # spheres win some
    rng = np.random.default_rng(6)
    o = rng.uniform(-1.1, 1.1, (512, 3)).astype(np.float32)
    d = np.zeros((512, 3), np.float32)
    d[np.arange(512), rng.integers(0, 3, 512)] = rng.choice([-1.0, 1.0], 512)
    want, _ = _same(soup, o, d, occlusion)
    assert (want[0] < T_MAX).float().mean().item() > 0.3


def _shared_edge_rays(pack, rng, n):
    """Rays from points inside the DEMO's room aimed at points of edges that
    two triangles of the pack share."""
    mt = np.asarray(pack.tri_mt)[np.asarray(pack.tri_valid)]
    v = np.stack([mt[:, 0:3], mt[:, 0:3] + mt[:, 3:6], mt[:, 0:3] + mt[:, 6:9]], 1)
    owners = collections.Counter()
    for tri in v:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            owners[tuple(sorted((tuple(tri[a].round(3)), tuple(tri[b].round(3)))))] += 1
    edges = np.array([e for e, k in owners.items() if k >= 2], np.float64)
    pick = edges[rng.integers(0, len(edges), n)]
    s = rng.uniform(0.05, 0.95, (n, 1))
    target = pick[:, 0] + s * (pick[:, 1] - pick[:, 0])
    o = rng.uniform((10.0, 10.0, 10.0), (545.0, 540.0, 550.0), (n, 3))
    d = target - o
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("occlusion", [False, True])
def test_walk_equals_sweep_on_the_lathe(lathe, occlusion):
    """The DEMO with a small lathe mesh: rays from inside the room, rays at
    the lathe's shared edges (ties asserted: the lower row wins in both),
    rays from origins inside its leaf boxes, and rays along box faces (the
    origin on a face plane, the direction in it: 0 * inf in the slab test)."""
    rng = np.random.default_rng(12)
    o, d = _rays(1024, (1.0, 1.0, 1.0), (555.0, 547.0, 558.0), seed=7,
                 aim=((60.0, 0.0, 360.0), (220.0, 260.0, 520.0)))
    want, ops = _same(lathe, o, d, occlusion)
    assert (want[0] < T_MAX).float().mean().item() > 0.9
    assert ops["woop"] < 0.2 * o.shape[0] * lathe.walk.leaf.shape[0]

    o, d = _shared_edge_rays(lathe, rng, 1024)
    _same(lathe, o, d, occlusion)
    t, _, _ = _tri_candidates(lathe.tri_sc, _cols(o), _cols(d))
    t = torch.where(lathe.tri_sc[:, 13] > 0.5, t, float(T_MAX))
    t_min = t.min(dim=-1, keepdim=True).values
    assert (((t == t_min) & (t_min < T_MAX)).sum(dim=-1) >= 2).sum().item() >= 10

    box = lathe.walk.bvh[:, :6].numpy()
    pick = box[rng.integers(0, box.shape[0], 512)].astype(np.float64)
    o = rng.uniform(pick[:, :3], pick[:, 3:])  # inside a child box
    o[:256, 1] = pick[:256, 1]  # on the box's lower y face ...
    d = rng.normal(size=(512, 3))
    d[:256, 1] = 0.0  # ... and running along it
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _same(lathe, o.astype(np.float32), d.astype(np.float32), occlusion)


def test_routed_and_walk_match_jax_k3(soup):
    """`intersect_c` / `occlude_t_c` (method kernel, on the CPU the plain
    sweep) and the plain walk against JAX's K3 plus the spheres, 256 rays
    aimed into the soup, within `_agree`'s bounds."""
    jp = _soup(JS, JM, spheres=True).compile()
    assert jp.tri_sc.shape[0] > 1024 and soup.walk is not None
    o, d = _rays(256, (-3.0, -3.0, -3.0), (3.0, 3.0, 3.0), seed=9, aim=((-1, -1, -1), (1, 1, 1)))
    ojc, djc = (tuple(jnp.asarray(x[:, k]) for k in range(3)) for x in (o, d))
    want = [np.asarray(x) for x in JI.intersect_pallas_c(jp, ojc, djc)]
    occ_want = np.asarray(JI.occlude_t_c(jp, ojc, djc, method="pallas"))
    assert (want[1] >= 0).mean() > 0.5 and (want[1] >= jp.n_tris).any()
    oc, dc = _cols(o), _cols(d)
    walk = intersect_walk_ref(soup.walk.bvh, soup.walk.leaf, soup.sph_geom, soup.n_tris, oc, dc)
    for got in (intersect_c(soup, oc, dc, method="kernel"), walk):
        _agree(o, *[x.numpy() for x in got], *want)
    occ = occlude_t_c(soup, oc, dc, method="kernel").numpy()
    scale = np.maximum(np.maximum(occ_want, np.abs(o).max(axis=1)), 1.0)
    assert np.mean(np.abs(occ - occ_want) <= 1e-5 * scale) >= AGREE
    np.testing.assert_array_equal(occ, walk[0].numpy())


def test_pack_to_builds_the_walk_once_per_host_pack():
    """`pack_to(..., walk=True)` keeps the walk tables it builds on the
    host pack, so a second move reuses them; a move without `walk` carries
    none, kept or not."""
    host = _soup(TS, TM).compile()
    assert host.walk is None and TS.pack_to(host, "cpu").walk is None
    assert host.walk is None  # nothing built
    a = TS.pack_to(host, "cpu", walk=True)
    kept = host.walk
    b = TS.pack_to(host, "cpu", walk=True)
    assert host.walk is kept and torch.equal(a.walk.bvh, b.walk.bvh)
    assert torch.equal(a.walk.leaf, torch.from_numpy(kept.leaf))
    assert TS.pack_to(host, "cpu").walk is None


def test_deep_tree_renders_without_the_walk():
    """A tree deeper than the walk's stack (which only the walk refuses)
    still moves without `walk` and renders on the CPU through the `bvh`
    method and the default one, as the JAX package renders it."""
    pack = chain_pack(BVH_STACK + 1)
    assert TS.pack_to(pack, "cpu").walk is None
    cam = dataclasses.replace(cornell_x4(sky=False).camera, width=6, height=4)
    imgs = [render_radiance(pack, cam, 1, 2, max_bounces=2, method=m, device="cpu")[0]
            for m in ("bvh", "auto")]
    for img in imgs:
        assert img.shape == (4, 6, 3) and np.isfinite(img).all() and img.mean() > 0


@pytest.mark.parametrize("occlusion", [False, True])
def test_walk_breaks_signed_zero_ties_as_the_sweep(occlusion):
    """At the fold's vertex the walk meets row 1 first; in both modes it
    returns what the sweep does, the lower row's t (and its sign of zero),
    bit for bit."""
    pack, tables, oc, dc, tie = fold_case()
    assert tie.sum().item() >= 10
    want = intersect_prims_ref(pack.tri_sc, pack.sph_geom, pack.n_tris, oc, dc,
                               occlusion=occlusion)
    got = intersect_walk_ref(tables.bvh, tables.leaf, pack.sph_geom, pack.n_tris, oc, dc,
                             occlusion=occlusion)
    bits_equal(got, want)
    t0, _, _ = _tri_candidates(pack.tri_sc[:1], oc, dc)
    assert torch.equal(torch.signbit(want[0][tie]), torch.signbit(t0[tie, 0]))
