"""Trees deeper than the kernels' local walk stack (constants.BVH_STACK, 32
levels), on the CPU: the plain versions of the deep walks, which the card's
deep instances (`mega_regen_deep`, `mega_lockstep_deep`,
`intersect_walk_deep`) equal bit for bit, take the same near-first walk with
a stack of one entry a level.

- On `chip_smoke.chain_pack` trees of 33 to 128 levels (the x4-scaled
  Cornell box of tests/test_megakernel.py:207-279 with its flat BVH replaced
  by a chain), in three forms: the chain (each interior node's child 0 a
  leaf), whose walks never hold more than one stack entry; the chain with
  `sphere_leaves` at 48 levels, whose every other leaf holds a sphere only
  (an empty child, which the walks step over), so that the walks pass 32
  levels over empty children; and the interior-first chain at 48, 64 and
  128 levels (child 0 the next interior node), whose walks push a leaf a
  level. On each the megakernels' nearest
  walk and shadow fan (a shared walk of 4 rays, and single-ray walks as the
  generic light-count instances take them) and K3's walk (nearest and
  occlusion) equal the brute sweeps and the same scene's own shallow tree
  bitwise, ties at shared edges included.
- The walks' stack high-water mark (the plain walks' `stack` tally): on the
  interior-first chain of L levels every walk's stack reaches L - 1
  entries, past the local stack's 32; on the chain, with or without
  sphere-only leaves, 1.
- What K3's deep walk's two-tier stack (csrc/deep_stack.cuh) moves to and
  from device memory (the plain walk's `spill` and `fill` tallies): the
  entries past its shared-memory tier, in runs, reckoned by hand from the
  tree; the megakernels' walks, whose deep stack is all in device memory,
  tally none.
- The deep tree renders as JAX renders the scene: the port's `render_mega`
  plain version (regen and lockstep) on `chain_pack(33)`, `chain_pack(64)`
  and `chain_pack(64, interior_first=True)` against `mcpt_tpu`'s
  `render_mega(interpret=True)` of
  the same box on its own clustered tree (`compile(cluster_threshold=8)`),
  at 64x48: the repo's bound (tests/test_megakernel.py:202-204: under 2% of
  pixels off by more than 1e-3, means within 5e-3) and ray counts within
  0.5% (tests/test_torch_render.py's bound; the regen kernel's are equal,
  the lockstep kernel's 4 of 63,929 apart, as the port's own shallow tree's
  are: the ULP differences tests/test_torch_lockstep.py describes). Both
  walks are exact, so the answer depends on the tree only through ties: the
  deep tree's render equals the shallow tree's bit for bit, rays and all.
"""

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch

import mcpt_tpu.builtin_scenes as JB
import mcpt_tpu.camera as JC
import mcpt_tpu.materials as JM
import mcpt_tpu.scene as JS
from mcpt_tpu.kernels import megakernel as J

import mcpt_tpu_torch.scene as TS
from chip_smoke import chain_pack, cornell_x4
from mcpt_tpu_torch.constants import BVH_STACK, DEEP_RUN, DEEP_TIER
from mcpt_tpu_torch.kernels.intersect_prims_ref import intersect_prims_ref, intersect_walk_ref
from mcpt_tpu_torch.kernels.megakernel_ref import (
    bvh_fan,
    bvh_nearest,
    intersect_tile,
    occlude_shared_origin,
)
from mcpt_tpu_torch.kernels.tables import SceneTables
from mcpt_tpu_torch.render import render_mega
from test_torch_bvh import cornell_x4 as either_x4
from test_torch_bvh_walk import _edge_rays, _fields, _random_rays, _shared_edge_points, _t3

# (tree form, levels): the chain at 33, 48 and 64 levels, the chain with
# sphere-only leaves (empty children) at 48, the interior-first chain (whose
# walks' stacks go past 32 entries) at 48 and 64
TREES = (("chain", 33), ("chain", 48), ("chain", 64), ("sphere-leaves", 48),
         ("interior-first", 48), ("interior-first", 64), ("interior-first", 128))
W, H = 64, 48


def _chain(form, levels):
    return chain_pack(levels, sphere_leaves=form == "sphere-leaves",
                      interior_first=form == "interior-first")


@pytest.fixture(scope="module")
def x4():
    """(pack with its own shallow tree, brute-force tables, its BVH tables,
    {(form, levels): chain tables})."""
    pack = cornell_x4(sky=False).compile(cluster_threshold=8)
    shallow = SceneTables.from_pack(pack)
    assert shallow.use_bvh and shallow.bvh_depth <= BVH_STACK
    chains = {(f, n): SceneTables.from_pack(_chain(f, n)) for f, n in TREES}
    for (_, n), t in chains.items():
        assert t.bvh_depth == n > BVH_STACK
    return pack, SceneTables.from_pack(cornell_x4(sky=False).compile()), shallow, chains


@pytest.fixture(scope="module")
def walk_packs():
    """{(form, levels): the chain's pack with K3's walk tables}, and the
    box's own shallow tree's under None."""
    packs = {t: TS.pack_to(_chain(*t), "cpu", walk=True) for t in TREES}
    packs[None] = TS.pack_to(cornell_x4(sky=False).compile(cluster_threshold=8), "cpu",
                             walk=True)
    return packs


@pytest.mark.parametrize("form,levels", TREES)
def test_deep_nearest_walk_equals_brute_and_shallow(x4, form, levels):
    pack, brute, shallow, chains = x4
    rng = np.random.default_rng(levels)
    o, d = (np.concatenate(x) for x in zip(_random_rays(rng, 1024), _edge_rays(pack, rng, 1024)))
    live = torch.ones(o.shape[0], dtype=torch.bool)
    want = intersect_tile(brute.tri, brute.sph, _t3(o), _t3(d))
    for tables in (chains[form, levels], shallow):
        got = bvh_nearest(tables, _t3(o), _t3(d), live)
        for a, b in zip(_fields(got), _fields(want), strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("form,levels", TREES)
@pytest.mark.parametrize("n_rays", [4, 1])
def test_deep_fan_walk_equals_brute_and_shallow(x4, form, levels, n_rays):
    """A shared walk of 4 shadow rays (the S = 4 instances) and walks of one
    ray each (the generic instances, 7 rays), half of them aimed at shared
    edges: the visibility bits of brute force and of both trees."""
    pack, brute, shallow, chains = x4
    rng = np.random.default_rng(100 + levels)
    n = 1024
    o, _ = _random_rays(rng, n)
    ds, dists = [], []
    for si in range(n_rays if n_rays == 4 else 7):
        p = _random_rays(rng, n)[0] if si % 2 == 0 else _shared_edge_points(pack, rng, n)
        delta = p - o
        dist = np.sqrt((delta * delta).sum(1)).astype(np.float32)
        ds.append(_t3((delta / dist[:, None]).astype(np.float32)))
        dists.append(torch.tensor(dist))
    live = torch.tensor(rng.uniform(size=n) < 0.9)
    want = occlude_shared_origin(brute.tri, brute.sph, _t3(o), ds, dists)
    assert 0.05 < torch.stack(want)[:, live].float().mean().item() < 0.95
    for tables in (chains[form, levels], shallow):
        if n_rays == 4:
            got = bvh_fan(tables, _t3(o), ds, dists, live)
        else:
            got = [bvh_fan(tables, _t3(o), [e], [x], live)[0] for e, x in zip(ds, dists)]
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a[live], b[live])


@pytest.mark.parametrize("form,levels", TREES)
def test_deep_intersector_walk_equals_sweep_and_shallow(walk_packs, form, levels):
    """K3's walk mode (`intersect_walk_ref`, the deep walk's plain version
    with a stack of `depth` entries) on the chain and on the scene's own
    tree: the sweep's answers bitwise, nearest and occlusion."""
    rng = np.random.default_rng(200 + levels)
    deep, shallow = walk_packs[form, levels], walk_packs[None]
    assert deep.walk.depth == levels and shallow.walk.depth <= BVH_STACK
    o, d = (np.concatenate(x) for x in zip(_random_rays(rng, 1024),
                                           _edge_rays(deep, rng, 1024)))
    oc, dc = _t3(o), _t3(d)
    for occlusion in (False, True):
        want = intersect_prims_ref(deep.tri_sc, deep.sph_geom, deep.n_tris, oc, dc,
                                   occlusion=occlusion)
        for p in (deep, shallow):
            got = intersect_walk_ref(p.walk.bvh, p.walk.leaf, p.sph_geom, p.n_tris, oc, dc,
                                     occlusion=occlusion, depth=p.walk.depth)
            for a, b in zip(got, want, strict=True):
                if b is not None:
                    assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                                       b.view(torch.int32) if b.is_floating_point() else b)


@pytest.mark.parametrize("form,levels", [t for t in TREES if t[1] > BVH_STACK + 1])
def test_deep_walks_fill_their_stack(x4, walk_packs, form, levels):
    """The stack's high-water mark (`stack` in the walks' tally) on 64 rays:
    on the interior-first chain every walk (the megakernels' nearest walk,
    their shared 4-ray fan walk and a single-ray fan walk, K3's nearest and
    occlusion walks) pushes a leaf a level, levels - 1 entries, past the
    local stack's BVH_STACK; on the chain it pushes the interior child and
    pops it at the next leaf (and steps over a sphere-only leaf): one
    entry."""
    pack, _, _, chains = x4
    tables, walk = chains[form, levels], walk_packs[form, levels]
    rng = np.random.default_rng(300 + levels)
    o, d = _random_rays(rng, 64)
    p = _random_rays(rng, 64)[0]
    delta = p - o
    dist = np.sqrt((delta * delta).sum(1)).astype(np.float32)
    ds = [_t3((delta / dist[:, None]).astype(np.float32))] * 4
    dists = [torch.tensor(dist)] * 4
    live = torch.ones(64, dtype=torch.bool)
    marks = {}
    for name, run in (
            ("nearest", lambda ops: bvh_nearest(tables, _t3(o), _t3(d), live, ops=ops)),
            ("fan of 4", lambda ops: bvh_fan(tables, _t3(o), ds, dists, live, ops=ops)),
            ("fan of 1", lambda ops: bvh_fan(tables, _t3(o), ds[:1], dists[:1], live, ops=ops)),
            *((f"K3 {'occlusion' if occ else 'nearest'}", lambda ops, occ=occ: intersect_walk_ref(
                walk.walk.bvh, walk.walk.leaf, walk.sph_geom, walk.n_tris, _t3(o), _t3(d),
                occlusion=occ, ops=ops, depth=walk.walk.depth)) for occ in (False, True))):
        ops = collections.Counter()
        run(ops)
        marks[name] = ops["stack"]
    want = levels - 1 if form == "interior-first" else 1
    assert marks == dict.fromkeys(marks, want), marks
    assert form != "interior-first" or want > BVH_STACK


@pytest.mark.parametrize("form,levels", [t for t in TREES if t[1] > BVH_STACK + 1])
def test_deep_walks_spill_in_runs(x4, walk_packs, form, levels):
    """What K3's deep walk's two-tier stack moves to and from device memory
    (the plain walk's `spill` and `fill` tallies) on 16 rays aimed at
    shared edges, all of which enter the root's box: a walk whose stack
    reaches k entries sends max(0, k - DEEP_TIER) of them out in runs of
    DEEP_RUN, ceil((k - DEEP_TIER) / DEEP_RUN) runs, each entry once, and
    takes as many back, since it pops every entry (both modes). On the
    interior-first chain k is levels - 1 (at 128 levels the tier fills and
    empties many times over), on the chain 1. The megakernels' walks
    (nearest, fans of 4 and 1) reach k entries too, and tally no runs: their
    deep instances keep every entry in device memory."""
    pack, _, _, chains = x4
    tables, walk = chains[form, levels], walk_packs[form, levels]
    rng = np.random.default_rng(400 + levels)
    n = 16
    o, d = _edge_rays(pack, rng, n)
    delta = _shared_edge_points(pack, rng, n) - o
    dist = np.sqrt((delta * delta).sum(1)).astype(np.float32)
    ds = [_t3((delta / dist[:, None]).astype(np.float32))] * 4
    dists = [torch.tensor(dist)] * 4
    live = torch.ones(n, dtype=torch.bool)
    k = levels - 1 if form == "interior-first" else 1
    runs = -(-max(0, k - DEEP_TIER) // DEEP_RUN)
    for name, tiered, run in (
            ("nearest", False, lambda ops: bvh_nearest(tables, _t3(o), _t3(d), live, ops=ops)),
            ("fan of 4", False, lambda ops: bvh_fan(tables, _t3(o), ds, dists, live, ops=ops)),
            ("fan of 1", False,
             lambda ops: bvh_fan(tables, _t3(o), ds[:1], dists[:1], live, ops=ops)),
            *((f"K3 {'occlusion' if occ else 'nearest'}", True, lambda ops, occ=occ:
               intersect_walk_ref(walk.walk.bvh, walk.walk.leaf, walk.sph_geom, walk.n_tris,
                                  _t3(o), _t3(d), occlusion=occ, ops=ops,
                                  depth=walk.walk.depth)) for occ in (False, True))):
        ops = collections.Counter()
        run(ops)
        assert ops["stack"] == k, (name, ops["stack"])
        if tiered:
            assert ops["spill"] == n * runs * DEEP_RUN, (name, ops["spill"])
            assert ops["fill"] == ops["spill"], (name, ops["fill"])
        else:
            assert ops["spill"] == ops["fill"] == 0, (name, ops)


@pytest.fixture(scope="module")
def jax_x4():
    """JAX's regen and lockstep renders of the x4 box on its clustered tree,
    64x48, spp 1, 3 bounces: {regen: (image, stats)}. The regen kernel with
    the single-slot, unroll-1 knobs, which trace in seconds (only the
    per-lane sum order of the default kernel differs)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MCPT_MEGA_UNROLL", "1")
    mp.setenv("MCPT_MEGA_SPLIT", "1")
    jax.clear_caches()
    sc = either_x4(JB, JM, JS, JC, width=W, height=H)
    pack = sc.compile(cluster_threshold=8)
    assert pack.n_cl_nodes > 0
    out = {}
    for regen in (True, False):
        img, stats = J.render_mega(pack, sc.camera, 1, seed=2, max_bounces=3, interpret=True,
                                   regen=regen)
        out[regen] = np.asarray(img), stats
    jax.clear_caches()
    mp.undo()
    return out


def _render(tables, regen):
    cam = dataclasses.replace(cornell_x4(sky=False).camera, width=W, height=H)
    return render_mega(tables, cam, 1, seed=2, max_bounces=3, device="cpu", regen=regen)


@pytest.fixture(scope="module")
def shallow_x4(x4):
    """The port's renders of the box on its own shallow tree, as jax_x4."""
    return {regen: _render(x4[2], regen) for regen in (True, False)}


@pytest.mark.parametrize("form,levels", [("chain", 33), ("chain", 64), ("interior-first", 64)])
@pytest.mark.parametrize("regen", [True, False])
def test_deep_tree_renders_as_jax(x4, jax_x4, shallow_x4, form, levels, regen):
    want, wstats = jax_x4[regen]
    got, stats = _render(x4[3][form, levels], regen)
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    same, same_stats = shallow_x4[regen]
    np.testing.assert_array_equal(got, same)
    assert stats["rays"] == same_stats["rays"]
    assert abs(stats["rays"] - wstats["rays"]) <= 0.005 * wstats["rays"]
    diff = np.abs(got - want)
    assert (diff > 1e-3).mean() < 0.02, float((diff > 1e-3).mean())
    assert abs(got.mean() - want.mean()) < 5e-3
    assert got.mean() > 0.01  # the box is lit
