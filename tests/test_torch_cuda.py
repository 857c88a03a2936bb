"""The CUDA kernels on the card (marker `gpu`; each test skips without a
CUDA device). This file imports neither jax nor mcpt_tpu, so it also runs on
a GPU machine without them; tests/conftest.py imports jax, so there run

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m gpu

The megakernels' flat per-vertex loop is held bitwise to the plain versions
at its edges (one and many samples a lane, one and 32 bounces, the generic
light-sample instances, a lane stride), and at light-sample counts above 32,
which the generic instances take 32 at a time. Megakernel bounds elsewhere as in
chip_smoke.py: per-lane ray counts equal on at least
98% of lanes (on every lane for the env, BVH and lockstep instances), radiance off by
more than 1e-3 on under 2% of lanes (ULP-level nearest-hit flips), means
within 5e-3. The wavefront intersector (`csrc/intersect_prims.cu`) is held
bitwise to its plain version in every mode (the sweep at ray counts around
its blocks, the occlusion fan form at 1, 4 and 33 directions an origin, ties
to the lower row), its walk modes also to the tiled sweep, and wavefront
renders through it (with and without a BVH) bitwise to the same renders
through the plain version. Renders strided
over one card listed three times equal the single render bitwise. The
training path's gradients through the intersector equal those through its
plain version bitwise, and the hybrid train step launches both kernels.
Trees deeper than the walks' local stack take the deep instances, bitwise
their plain versions, on chains whose walks hold one stack entry and on
interior-first chains whose walks fill their stack; the wavefront's backward kernels
(`csrc/wavefront_bwd.cu`) equal their plain versions bitwise, the train
step runs them (no `plain (autograd)` call), and its gradients repeat bit
for bit. shade_post and the fold equal their plain versions bitwise at their
edges (odd lane counts, views off the vector's grid, 0 to 40 light samples,
adversarial records), shade_post through the instance the lane count and
the alignment call for; the camera rays likewise (lane counts around its
vector instance's floats a store and its blocks, ids at a tile's offset,
past 2^31 and below 0, a view off the 16-byte grid; 1 and 3 lanes a pixel;
pinhole and thin lens).
"""

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.constants import BVH_STACK
from mcpt_tpu_torch.kernels import intersect_prims as IP
from mcpt_tpu_torch.kernels import megakernel as K
from mcpt_tpu_torch.kernels.intersect_prims_ref import intersect_prims_ref
from mcpt_tpu_torch.kernels.megakernel_ref import (
    MAX_BOUNCES_LIMIT,
    cam_static,
    trace_block_lockstep_ref,
    trace_block_ref,
)
from mcpt_tpu_torch.kernels.tables import SceneTables, walk_tables
from mcpt_tpu_torch.materials import Material, make_light_material
from mcpt_tpu_torch.render import render_mega, render_mega_sharded, render_radiance
from mcpt_tpu_torch.scene import Scene, Sphere, TriangleMesh, pack_to

W, H = 32, 24
SKY = Path(__file__).resolve().parent.parent / "assets" / "sky.png"


@pytest.fixture
def cuda_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return SceneTables.from_pack(demo_scene().compile(), device="cuda")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _agree(r, ry, r2, ry2):
    assert bool(torch.isfinite(r).all())
    assert (ry == ry2).float().mean().item() >= 0.98
    assert (ry.double().sum() - ry2.double().sum()).abs().item() <= 0.005 * ry2.double().sum().item()
    diff = (r - r2).abs()
    assert (diff > 1e-3).float().mean().item() < 0.02
    assert abs(r.double().mean().item() - r2.double().mean().item()) < 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("spp,mb", [(4, 6), (2, 1)])
def test_cuda_kernel_matches_plain_version(cuda_tables, spp, mb):
    """One launch of the kernel against its plain version on the same CUDA
    tables, at a lane offset inside the image."""
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    n, off = W * H * 3 - 100, 100
    before = K.trace_block.launches
    r, ry = K.trace_block(cuda_tables, cs, 11, off, spp, n, mb)
    torch.cuda.synchronize()
    assert K.trace_block.launches == before + 1
    assert r.device.type == "cuda" and r.shape == ry.shape == (n,)
    _agree(r, ry, *trace_block_ref(cuda_tables, cs, 11, off, spp, n, mb))


@pytest.mark.gpu
def test_render_mega_goes_through_the_kernel(cuda_tables):
    cam = dataclasses.replace(demo_scene().camera, width=W, height=H)
    before = K.trace_block.launches
    img, stats = render_mega(cuda_tables, cam, 4, seed=3, max_bounces=4, device="cuda")
    assert K.trace_block.launches == before + 1
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    r2, ry2 = trace_block_ref(cuda_tables, cam_static(cam), 3, 0, 4, W * H * 3, 4)
    assert abs(stats["rays"] - ry2.double().sum().item()) <= 0.005 * stats["rays"]
    assert np.abs(img - r2.cpu().numpy().reshape(H, W, 3)).mean() < 5e-3


@pytest.mark.gpu
def test_trace_block_rejects_what_the_kernel_does_not_take(cuda_tables):
    """Lanes past the image are the sharded render's pad lanes and are
    taken; lane ids outside int32 and negative offsets are not."""
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    with pytest.raises(ValueError, match="int32"):
        K.trace_block(cuda_tables, cs, 0, 2**31 - 100, 1, W * H * 3, 2)
    with pytest.raises(ValueError, match="int32"):
        K.trace_block(cuda_tables, cs, 0, -1, 1, 96, 2)
    cuda_tables.tri = cuda_tables.tri.double()
    with pytest.raises(ValueError, match="table tri"):
        K.trace_block(cuda_tables, cs, 0, 0, 1, 96, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("env,bvh", [(True, False), (False, True), (True, True)])
def test_cuda_env_and_bvh_instances_match_plain_version(env, bvh):
    """The env-map and BVH-walk instances of the kernel against the plain
    version, on the DEMO under assets/sky.png and forced onto the BVH walk
    with cluster_threshold=8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    sc = demo_scene()
    if env:
        sc.load_env_map(SKY)
    pack = sc.compile(cluster_threshold=8 if bvh else 1024)
    tables = SceneTables.from_pack(pack, device="cuda")
    assert (tables.use_env, tables.use_bvh) == (env, bvh)
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    n = W * H * 3
    name = f"mega_regen<4, {str(env).lower()}, {str(bvh).lower()}>"
    before = K.trace_block.by_instance[name]
    r, ry = K.trace_block(tables, cs, 7, 0, 4, n, 6)
    torch.cuda.synchronize()
    assert K.trace_block.last_instance == name
    assert K.trace_block.by_instance[name] == before + 1
    r2, ry2 = trace_block_ref(tables, cs, 7, 0, 4, n, 6)
    assert torch.equal(ry, ry2)
    _agree(r, ry, r2, ry2)


@pytest.mark.gpu
@pytest.mark.parametrize("n_dir,cap", [(32, 32), (8, 16), (33, 32), (40, 32), (64, 32)])
def test_cuda_generic_light_count_matches_plain_version(n_dir, cap):
    """The generic-S instances on the BVH walk under the sky map: at 32
    light samples, the count conf.json asks for in fixed mode, at 8, which
    the instance of 16 takes, and at 33, 40 and 64, which the instance of 32
    takes 32 at a time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    sc = demo_scene()
    sc.load_env_map(SKY)
    sc.n_dir_sample = n_dir
    tables = SceneTables.from_pack(sc.compile(cluster_threshold=8), device="cuda")
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    n = W * H * 3
    r, ry = K.trace_block(tables, cs, 9, 0, 2, n, 4)
    torch.cuda.synchronize()
    assert K.trace_block.last_instance == f"mega_regen<-{cap}, true, true>"
    r2, ry2 = trace_block_ref(tables, cs, 9, 0, 2, n, 4)
    assert torch.equal(ry, ry2)
    _agree(r, ry, r2, ry2)


def _soup_scene(n=1200):
    """The DEMO's camera over n random triangles in [-1, 1]^3 and two
    spheres: a table of more than 1024 rows, which the kernel walks tile by
    tile."""
    rng = np.random.default_rng(11)
    v0 = rng.uniform(-1.0, 1.0, (n, 3))
    pos = np.stack([v0, v0 + rng.uniform(-0.2, 0.2, (n, 3)),
                    v0 + rng.uniform(-0.2, 0.2, (n, 3))], 1).astype(np.float32)
    sc = Scene(demo_scene().camera)
    sc.add(TriangleMesh(pos, np.zeros((n, 3, 2), np.float32), Material(), "soup"))
    sc.add(Sphere((0.3, 0.2, -0.4), 0.35, Material(), "a"))
    sc.add(Sphere((-0.5, -0.3, 0.5), 0.25, Material(), "b"))
    return sc


def _cuda_rays(n, lo, hi, aim, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3))
    d = rng.uniform(*aim, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cols = lambda x: tuple(torch.from_numpy(x[:, k].astype(np.float32)).cuda() for k in range(3))
    return cols(o), cols(d)


@pytest.mark.gpu
@pytest.mark.parametrize("scene,mode", [
    ("demo", "nearest"), ("demo", "occlusion"), ("demo", "tris"),
    ("soup", "nearest tiled"), ("soup", "occlusion tiled"), ("soup", "tris tiled"),
])
def test_intersect_kernel_modes_bitwise(scene, mode):
    """Every mode of csrc/intersect_prims.cu against its plain version on
    the same CUDA tensors: t, prim, u and v bitwise equal on every ray."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if scene == "demo":
        pack = demo_scene().compile()
        oc, dc = _cuda_rays(5000, (1.0, 1.0, 1.0), (555.0, 547.0, 558.0),
                            ((0.0, 0.0, 0.0), (555.0, 548.0, 559.0)), 3)
    else:
        pack = _soup_scene().compile()
        oc, dc = _cuda_rays(5000, -3.0, 3.0, ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)), 4)
    tri = torch.from_numpy(pack.tri_sc).cuda()
    sph = torch.from_numpy(pack.sph_geom).cuda()
    if mode.startswith("tris"):
        sph = sph[:0]
    occlusion = mode.startswith("occlusion")
    before = IP.intersect_prims_c.by_mode[mode]
    got = IP.intersect_prims_c(tri, sph, pack.t_pad, oc, dc, occlusion=occlusion)
    torch.cuda.synchronize()
    assert IP.intersect_prims_c.by_mode[mode] == before + 1
    want = intersect_prims_ref(tri, sph, pack.t_pad, oc, dc, occlusion=occlusion)
    assert (want[0] < 1e30).float().mean().item() > 0.3
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.device.type == "cuda" and torch.equal(g, w)


@pytest.mark.gpu
def test_intersect_tris_rows_bitwise():
    """The triangles-only entry (K4's counterpart) on (B, 3) rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rows = torch.from_numpy(demo_scene().compile().tri_sc).cuda()
    oc, dc = _cuda_rays(3000, (1.0, 1.0, 1.0), (555.0, 547.0, 558.0),
                        ((0.0, 0.0, 0.0), (555.0, 548.0, 559.0)), 5)
    o, d = torch.stack(oc, 1), torch.stack(dc, 1)
    got = IP.intersect_tris(rows, o, d)
    assert IP.intersect_prims_c.last_mode == "tris"
    no_sph = torch.zeros((0, 4), dtype=torch.float32, device="cuda")
    want = intersect_prims_ref(rows, no_sph, 0, oc, dc)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# the sweep's scenes: the DEMO (one shared-memory tile) and the soup (more
# than 1024 rows, tiled), each with its origin box and the box rays aim into
SWEEP_SCENES = {
    "demo": (demo_scene, (1.0, 1.0, 1.0), (555.0, 547.0, 558.0),
             ((0.0, 0.0, 0.0), (555.0, 548.0, 559.0))),
    "soup": (_soup_scene, -3.0, 3.0, ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))),
}


def _sweep_case(scene, n, seed, fan=None):
    """(tri, sph, sph_base, oc, dc) on the card: the scene's table and n
    rays, or with `fan` n origins and fan·n directions, direction k·n + i
    from origin i aimed into the scene."""
    make, lo, hi, aim = SWEEP_SCENES[scene]
    pack = make().compile()
    oc, dc = _cuda_rays(n, lo, hi, aim, seed)
    if fan:
        o = torch.stack(oc, 1).cpu().numpy().astype(np.float64)
        d = np.random.default_rng(seed).uniform(*aim, (fan * n, 3)) - np.tile(o, (fan, 1))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        dc = tuple(torch.from_numpy(np.ascontiguousarray(d[:, k])).cuda() for k in range(3))
    return (torch.from_numpy(pack.tri_sc).cuda(), torch.from_numpy(pack.sph_geom).cuda(),
            pack.t_pad, oc, dc)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["demo", "soup"])
@pytest.mark.parametrize("mode", ["nearest", "occlusion", "tris"])
def test_sweep_ray_counts_bitwise(cuda_card, scene, mode):
    """The register-blocked sweep (several rays a thread, the rays past n
    masked) in every mode and form at ray counts around its blocks: every
    output bitwise equal (float32 as int32) to the plain version."""
    form = " tiled" if scene == "soup" else ""
    for n in (1, 3, 255, 257, 5001):
        tri, sph, base, oc, dc = _sweep_case(scene, n, n)
        if mode == "tris":
            sph = sph[:0]
        occ = mode == "occlusion"
        got = IP.intersect_prims_c(tri, sph, base, oc, dc, occlusion=occ)
        assert IP.intersect_prims_c.last_mode == mode + form
        _bits_equal(got, intersect_prims_ref(tri, sph, base, oc, dc, occlusion=occ))


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["demo", "soup"])
@pytest.mark.parametrize("s", [1, 4, 33])
def test_sweep_fan_bitwise(cuda_card, scene, s):
    """The occlusion sweep's fan form (one origin a thread, its s directions
    a few at a time): bitwise equal to the plain version and to the generic
    occlusion mode on the origins expanded, at origin counts around its
    blocks."""
    form = " tiled" if scene == "soup" else ""
    for b in (1, 255, 1000):
        tri, sph, base, oc, dc = _sweep_case(scene, b, b, fan=s)
        got = IP.intersect_prims_c(tri, sph, base, oc, dc, occlusion=True, fan=s)
        assert IP.intersect_prims_c.last_mode == "occlusion fan" + form
        ox = tuple(x.repeat(s) for x in oc)
        generic = IP.intersect_prims_c(tri, sph, base, ox, dc, occlusion=True)
        assert IP.intersect_prims_c.last_mode == "occlusion" + form
        want = intersect_prims_ref(tri, sph, base, oc, dc, occlusion=True, fan=s)
        assert b == 1 or (want[0] < 1e30).float().mean().item() > 0.3
        _bits_equal(got, generic, want)


@pytest.mark.gpu
def test_sweep_ties_go_to_the_lower_row(cuda_card):
    """Equal t from two rows go to the lower row in every sweep mode, bit
    for bit as the plain version: rays from the vertex where two triangles
    meet in different planes (t = +0 from one, -0 from the other), through
    the sweep and the fan form (one origin, 64 directions), and rays aimed
    at edges the DEMO's triangles share."""
    from test_torch_bvh_walk import _edge_rays, fold_case

    pack, _, oc, dc, tie = fold_case()
    assert tie.sum().item() >= 10
    tri, sph = pack.tri_sc.cuda(), pack.sph_geom.cuda()
    oc, dc = tuple(x.cuda() for x in oc), tuple(x.cuda() for x in dc)
    for occ in (False, True):
        want = intersect_prims_ref(tri, sph, pack.n_tris, oc, dc, occlusion=occ)
        _bits_equal(IP.intersect_prims_c(tri, sph, pack.n_tris, oc, dc, occlusion=occ), want)
    fan = IP.intersect_prims_c(tri, sph, pack.n_tris, tuple(x[:1] for x in oc), dc,
                               occlusion=True, fan=64)
    assert IP.intersect_prims_c.last_mode == "occlusion fan"
    _bits_equal(fan, want)

    demo = demo_scene().compile()
    o, d = _edge_rays(demo, np.random.default_rng(8), 4000)
    cols = lambda x: tuple(torch.from_numpy(np.ascontiguousarray(x[:, k])).cuda()
                           for k in range(3))
    tri, sph = torch.from_numpy(demo.tri_sc).cuda(), torch.from_numpy(demo.sph_geom).cuda()
    for occ in (False, True):
        got = IP.intersect_prims_c(tri, sph, demo.t_pad, cols(o), cols(d), occlusion=occ)
        _bits_equal(got, intersect_prims_ref(tri, sph, demo.t_pad, cols(o), cols(d),
                                             occlusion=occ))


def _soldier_scene(tmp_path, segs_steps=None):
    """chip_smoke.py's DEMO plus one stand-in soldier (2,560 triangles), or
    a smaller one of (segments, steps)."""
    from chip_smoke import SOLDIER_AT, STAND_INS, write_lathe_obj

    segs, steps, height, radius, center, shape = STAND_INS["low_soldier.obj"]
    segs, steps = segs_steps or (segs, steps)
    path = tmp_path / "soldier.obj"
    write_lathe_obj(path, segs, steps, height, radius, center, shape)
    sc = demo_scene()
    sc.add(TriangleMesh.from_obj(path, Material(), translation=SOLDIER_AT, name="soldier"))
    return sc


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["soup", "soldier"])
@pytest.mark.parametrize("occlusion", [False, True])
def test_intersect_walk_bitwise(cuda_card, tmp_path, scene, occlusion):
    """The walk modes (the pack's BVH tables) against the all-pairs plain
    version and against the tiled sweep (the bare table) on the same CUDA
    rays: every output bitwise equal."""
    if scene == "soup":
        pack = pack_to(_soup_scene().compile(), "cuda", walk=True)
        oc, dc = _cuda_rays(20000, -3.0, 3.0, ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)), 4)
    else:
        pack = pack_to(_soldier_scene(tmp_path).compile(), "cuda", walk=True)
        oc, dc = _cuda_rays(50000, (1.0, 1.0, 1.0), (555.0, 547.0, 558.0),
                            ((40.0, 0.0, 340.0), (240.0, 260.0, 540.0)), 6)
    assert pack.walk is not None and pack.tri_sc.shape[0] > 1024
    base = "occlusion" if occlusion else "nearest"
    before = IP.intersect_prims_c.by_mode[base + " walk"]
    got = IP.intersect_prims_c(pack.tri_sc, pack.sph_geom, pack.n_tris, oc, dc,
                               occlusion=occlusion, walk=pack.walk)
    torch.cuda.synchronize()
    assert IP.intersect_prims_c.by_mode[base + " walk"] == before + 1
    tiled = IP.intersect_prims_c(pack.tri_sc, pack.sph_geom, pack.n_tris, oc, dc,
                                 occlusion=occlusion)
    assert IP.intersect_prims_c.last_mode == base + " tiled"
    want = intersect_prims_ref(pack.tri_sc, pack.sph_geom, pack.n_tris, oc, dc,
                               occlusion=occlusion)
    assert (want[0] < 1e30).float().mean().item() > 0.5
    _bits_equal(got, tiled, want)


def _bits_equal(got, *wants):
    """Outputs (t, prim, u, v; Nones in occlusion mode) on the card equal
    each of `wants` bit for bit: float32 as int32, so +0 and -0 differ."""
    for g, *ws in zip(got, *wants, strict=True):
        for w in ws:
            assert (g is None) == (w is None)
            if w is not None:
                assert g.device.type == "cuda" and g.dtype == w.dtype
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("occlusion", [False, True])
def test_intersect_walk_signed_zero_ties(cuda_card, occlusion):
    """Rays from the vertex where two triangles meet in different planes
    (t = +0 from one, -0 from the other; the walk tests row 1 first):
    both walk modes return the lower row's t, as the sweep and the plain
    version do, bit for bit."""
    from test_torch_bvh_walk import fold_case

    pack, tables, oc, dc, tie = fold_case()
    assert tie.sum().item() >= 10
    cuda = lambda x: tuple(c.cuda() for c in x)
    tri, sph = pack.tri_sc.cuda(), pack.sph_geom.cuda()
    walk = tables._replace(bvh=tables.bvh.cuda(), leaf=tables.leaf.cuda())
    got = IP.intersect_prims_c(tri, sph, pack.n_tris, cuda(oc), cuda(dc), occlusion=occlusion,
                               walk=walk)
    assert IP.intersect_prims_c.last_mode.endswith(" walk")
    swept = IP.intersect_prims_c(tri, sph, pack.n_tris, cuda(oc), cuda(dc), occlusion=occlusion)
    want = intersect_prims_ref(tri, sph, pack.n_tris, cuda(oc), cuda(dc), occlusion=occlusion)
    _bits_equal(got, swept, want)


@pytest.mark.gpu
def test_intersect_walk_refuses_a_deep_tree(cuda_card):
    """Nothing is refused any more: a tree of BVH_STACK levels fills the
    shallow walk's local stack and takes that walk, a deeper one takes the
    deep walk (its stack past a shared-memory tier in device memory; the
    interior-first chains of 48, 64 and 128 levels push 47, 63 and 127
    entries); each is bitwise its plain
    version and the sweep in both modes, and a wavefront render through the
    kernel equals the `bvh` method's within the repo's bound (both exact;
    the intersectors' ULPs differ); the C entry still refuses deep tables
    without the stack, before any launch."""
    from chip_smoke import chain_pack, cornell_x4
    from mcpt_tpu_torch.kernels.intersect_prims_ref import intersect_walk_ref

    deep = chain_pack(BVH_STACK + 1)
    assert walk_tables(deep).depth == BVH_STACK + 1
    cam = dataclasses.replace(cornell_x4(sky=False).camera, width=8, height=6)
    img, _ = render_radiance(deep, cam, 1, 2, max_bounces=2, method="kernel", device="cuda")
    assert IP.intersect_prims_c.last_mode.endswith("deep walk")
    ref_img, _ = render_radiance(deep, cam, 1, 2, max_bounces=2, method="bvh", device="cuda")
    assert np.isfinite(img).all() and img.mean() > 0
    assert (np.abs(img - ref_img) > 1e-3).mean() < 0.02
    for levels, inner in ((BVH_STACK, False), (BVH_STACK + 1, False), (64, False), (48, True),
                          (64, True), (128, True)):
        pack = pack_to(chain_pack(levels, interior_first=inner), "cuda", walk=True)
        assert pack.walk.depth == levels
        oc, dc = _cuda_rays(256, 0.0, 500.0, ((0.0, 0.0, 0.0), (500.0, 500.0, 500.0)), 7)
        for occlusion in (False, True):
            got = IP.intersect_prims_c(pack.tri_sc, pack.sph_geom, pack.n_tris, oc, dc,
                                       occlusion=occlusion, walk=pack.walk)
            walk = ("occlusion" if occlusion else "nearest") + (
                " deep walk" if levels > BVH_STACK else " walk")
            assert IP.intersect_prims_c.last_mode == walk
            plain = intersect_walk_ref(pack.walk.bvh, pack.walk.leaf, pack.sph_geom,
                                       pack.n_tris, oc, dc, occlusion=occlusion,
                                       depth=levels)
            swept = intersect_prims_ref(pack.tri_sc, pack.sph_geom, pack.n_tris, oc, dc,
                                        occlusion=occlusion)
            _bits_equal(got, plain, swept)
    launched = (ctypes.c_int * 2)(0, 0)
    status = IP.load_library().mcpt_intersect_prims(
        None, pack.tri_sc.data_ptr(), 1, pack.walk.bvh.data_ptr(), 1, BVH_STACK + 1, None, None,
        0, 0, 1, 0, 0, None, None, ctypes.cast(launched, ctypes.c_void_p))
    assert status != 0


@pytest.mark.gpu
def test_wavefront_render_walks_a_tree(cuda_card, tmp_path, monkeypatch):
    """render_radiance of a scene with a BVH (the DEMO plus a small
    soldier, cluster_threshold 64) on the card launches only the walk modes,
    and its image equals, bitwise, the same render with the plain sweep in
    the kernel's place."""
    sc = _soldier_scene(tmp_path, (12, 10))
    host = sc.compile(cluster_threshold=64)
    cam = dataclasses.replace(sc.camera, width=W, height=H)
    kw = dict(max_bounces=4, tile_pixels=256, spp_chunk=2, device="cuda")
    IP.intersect_prims_c.by_mode.clear()
    img, stats = render_radiance(host, cam, 4, 3, **kw)
    modes = dict(IP.intersect_prims_c.by_mode)
    assert set(modes) == {"nearest walk", "occlusion walk"}, modes
    assert img.shape == (H, W, 3) and np.isfinite(img).all() and img.mean() > 0
    monkeypatch.setattr(IP, "_launch", lambda tri, sph, base, oc, dc, occ, walk=None, fan=0:
                        intersect_prims_ref(tri, sph, base, oc, dc, occlusion=occ, fan=fan))
    img2, stats2 = render_radiance(host, cam, 4, 3, **kw)
    assert stats["rays"] == stats2["rays"]
    np.testing.assert_array_equal(img, img2)


@pytest.mark.gpu
def test_wavefront_render_goes_through_the_kernel(monkeypatch):
    """render_radiance on the card launches the kernel in its nearest mode
    and the occlusion fan form, and its image equals, bitwise, the same
    render with the plain version in the kernel's place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    sc = demo_scene()
    cam = dataclasses.replace(sc.camera, width=W, height=H)
    kw = dict(max_bounces=4, tile_pixels=256, spp_chunk=2, device="cuda")
    IP.intersect_prims_c.by_mode.clear()
    img, stats = render_radiance(sc, cam, 4, 3, **kw)
    assert IP.intersect_prims_c.by_mode["nearest"] > 0
    assert IP.intersect_prims_c.by_mode["occlusion fan"] > 0
    assert img.shape == (H, W, 3) and np.isfinite(img).all() and img.mean() > 0
    monkeypatch.setattr(IP, "_launch", lambda tri, sph, base, oc, dc, occ, walk=None, fan=0:
                        intersect_prims_ref(tri, sph, base, oc, dc, occlusion=occ, fan=fan))
    img2, stats2 = render_radiance(sc, cam, 4, 3, **kw)
    assert stats["rays"] == stats2["rays"]
    np.testing.assert_array_equal(img, img2)


@pytest.mark.gpu
def test_wavefront_checkpoint_resumes_on_the_card(tmp_path, monkeypatch):
    """An interrupted wavefront render on the card, resumed from the
    checkpoint it wrote at chunk 16, equals the uninterrupted render."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import mcpt_tpu_torch.render as R

    sc = demo_scene()
    cam = dataclasses.replace(sc.camera, width=8, height=8)
    kw = dict(spp=20, max_bounces=2, spp_chunk=1, tile_pixels=64, device="cuda")
    fb_ref, st_ref = render_radiance(sc, cam, **kw)
    ckpt = str(tmp_path / "state.npz")
    calls = {"n": 0}
    orig = R._render_tile

    def bomb(*a, **k):
        calls["n"] += 1
        if calls["n"] > 17:
            raise KeyboardInterrupt
        return orig(*a, **k)

    monkeypatch.setattr(R, "_render_tile", bomb)
    with pytest.raises(KeyboardInterrupt):
        render_radiance(sc, cam, checkpoint_path=ckpt, **kw)
    monkeypatch.setattr(R, "_render_tile", orig)
    assert int(np.load(ckpt)["start_chunk"][0]) == 16
    fb, st = render_radiance(sc, cam, checkpoint_path=ckpt, **kw)
    np.testing.assert_allclose(fb, fb_ref, atol=1e-6)
    assert st["rays"] == st_ref["rays"]
    assert not (tmp_path / "state.npz").exists()


@pytest.mark.gpu
@pytest.mark.parametrize("n_dir,bvh,cap", [
    (4, False, 4), (4, True, 4), (8, False, -16), (8, True, -16), (32, False, -32),
    (32, True, -32),
])
def test_cuda_lockstep_instances_match_plain_version(n_dir, bvh, cap):
    """Every instance of the lockstep kernel (csrc/mega_lockstep.cu) against
    its plain version on the same CUDA tables, at a lane stride of 2 from an
    odd offset (the last lanes are pad lanes past the image)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    sc = demo_scene()
    sc.n_dir_sample = n_dir
    tables = SceneTables.from_pack(sc.compile(cluster_threshold=8 if bvh else 1024),
                                   device="cuda")
    assert tables.use_bvh == bvh
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    n = W * H * 3 // 2
    name = f"mega_lockstep<{cap}, {str(bvh).lower()}>"
    before = K.trace_block.by_instance[name]
    r, ry = K.trace_block(tables, cs, 7, 3, 4, n, 6, regen=False, lane_stride=2)
    torch.cuda.synchronize()
    assert K.trace_block.last_instance == name
    assert K.trace_block.by_instance[name] == before + 1
    r2, ry2 = trace_block_lockstep_ref(tables, cs, 7, 3, 4, n, 6, lane_stride=2)
    assert torch.equal(ry, ry2)
    _agree(r, ry, r2, ry2)


@pytest.mark.gpu
def test_render_mega_lockstep_goes_through_the_kernel(cuda_tables):
    cam = dataclasses.replace(demo_scene().camera, width=W, height=H)
    before = K.trace_block.by_instance["mega_lockstep<4, false>"]
    img, stats = render_mega(cuda_tables, cam, 4, seed=3, max_bounces=4, device="cuda",
                             regen=False)
    assert K.trace_block.by_instance["mega_lockstep<4, false>"] == before + 1
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    r2, ry2 = trace_block_lockstep_ref(cuda_tables, cam_static(cam), 3, 0, 4, W * H * 3, 4)
    assert stats["rays"] == int(ry2.double().sum().item())
    assert np.abs(img - r2.cpu().numpy().reshape(H, W, 3)).mean() < 5e-3


@pytest.mark.gpu
@pytest.mark.parametrize("regen", [True, False])
def test_cuda_stride_equivalence_on_one_card(cuda_tables, regen):
    """render_mega_sharded over ["cuda:0"] * 3: three strided launch sets
    on one card, bitwise equal to the single render."""
    cam = dataclasses.replace(demo_scene().camera, width=W, height=H)
    single, s1 = render_mega(cuda_tables, cam, 4, seed=5, max_bounces=4, device="cuda",
                             regen=regen)
    before = K.trace_block.launches
    sharded, s3 = render_mega_sharded(cuda_tables, cam, 4, seed=5, devices=["cuda:0"] * 3,
                                      max_bounces=4, regen=regen)
    assert K.trace_block.launches == before + 3
    np.testing.assert_array_equal(single, sharded)
    assert s1["rays"] == s3["rays"] and s3["devices"] == 3
    assert s3["pad_lanes"] == 3 * 1024 - W * H * 3


# (spp, max_bounces, n_dir_sample, BVH walk, lane_offset, lane_stride)
FLAT_LOOP_EDGES = [
    (1, 8, 4, False, 0, 1),
    (33, 8, 4, False, 0, 1),
    (4, 1, 4, False, 0, 1),
    (4, 32, 4, False, 0, 1),
    (3, 6, 0, False, 0, 1),
    (3, 6, 7, False, 0, 1),
    (3, 6, 32, False, 0, 1),
    (6, 8, 4, False, 5, 3),
    (6, 8, 4, True, 5, 3),
]


@pytest.mark.gpu
@pytest.mark.parametrize("regen", [True, False])
@pytest.mark.parametrize("spp,mb,n_dir,bvh,lane_offset,lane_stride", FLAT_LOOP_EDGES)
def test_flat_loop_edges_bitwise(cuda_card, regen, spp, mb, n_dir, bvh, lane_offset,
                                 lane_stride):
    """Both megakernels' per-lane loop over path vertices at its edges: a
    lane's budget of one sample and of 33, one bounce and the 32-bounce cap,
    the generic instances (no light samples, 7 and 32), and lanes strided by
    3 from an offset of 5 (the last ones pad lanes past the image). Radiance
    and ray counts equal the plain version's bitwise on every lane. At the
    32-bounce cap the roulette rate is 0.99, so that some lanes' first path
    reaches depth 31 and the lane goes on to its next sample."""
    sc = demo_scene()
    sc.n_dir_sample = n_dir
    if mb == MAX_BOUNCES_LIMIT:
        sc.set_rr_rate(0.99)
    tables = SceneTables.from_pack(sc.compile(cluster_threshold=8 if bvh else 1024),
                                   device="cuda")
    assert tables.use_bvh == bvh
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    n = W * H * 3 // lane_stride
    r, ry = K.trace_block(tables, cs, 17, lane_offset, spp, n, mb, regen=regen,
                          lane_stride=lane_stride)
    torch.cuda.synchronize()
    cap = {0: -16, 4: 4, 7: -16, 32: -32}[n_dir]
    b = str(bvh).lower()
    assert K.trace_block.last_instance == (
        f"mega_regen<{cap}, false, {b}>" if regen else f"mega_lockstep<{cap}, {b}>")
    plain = trace_block_ref if regen else trace_block_lockstep_ref
    r2, ry2 = plain(tables, cs, 17, lane_offset, spp, n, mb, lane_stride=lane_stride)
    assert torch.equal(ry, ry2)
    assert torch.equal(r, r2), f"{(r != r2).sum().item()} of {n} lanes differ"
    if mb == MAX_BOUNCES_LIMIT:
        # sample 0 alone: a path of 31 vertices takes at most 1 + 31 * (n_dir + 1)
        # rays, so a lane above that put a vertex at depth 31
        _, ry0 = plain(tables, cs, 17, lane_offset, 1, n, mb, lane_stride=lane_stride)
        assert bool((ry0 > 1 + (mb - 1) * (n_dir + 1)).any())


@pytest.mark.gpu
@pytest.mark.parametrize("regen", [True, False])
def test_instance_info_names_the_launched_instance(cuda_tables, regen):
    """The occupancy query reports the instance that trace_block launches,
    with at least one resident block of its threads."""
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    info = K.instance_info(cuda_tables, cs, 8, regen=regen)
    K.trace_block(cuda_tables, cs, 0, 0, 1, 96, 8, regen=regen)
    assert info["instance"] == K.trace_block.last_instance
    assert info["blocks_per_sm"] >= 1 and info["threads"] >= 32 and info["registers"] > 0
    assert info["smem_bytes"] > 0


def test_instance_info_needs_cuda_tables():
    tables = SceneTables.from_pack(demo_scene().compile(), device="cpu")
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    with pytest.raises(ValueError, match="CUDA tables"):
        K.instance_info(tables, cs, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("regen", [True, False])
@pytest.mark.parametrize("bvh", [False, True])
@pytest.mark.parametrize("n_dir", [33, 40, 64])
def test_any_light_count_bitwise(cuda_card, n_dir, bvh, regen):
    """More light samples than the largest generic instance's group (32):
    both kernels take them 32 at a time, brute force and BVH, and equal the
    plain version bitwise on every lane, ray counts included."""
    sc = demo_scene()
    sc.n_dir_sample = n_dir
    tables = SceneTables.from_pack(sc.compile(cluster_threshold=8 if bvh else 1024),
                                   device="cuda")
    cs = cam_static(dataclasses.replace(demo_scene().camera, width=W, height=H))
    n = W * H * 3
    r, ry = K.trace_block(tables, cs, 13, 0, 2, n, 4, regen=regen)
    torch.cuda.synchronize()
    b = str(bvh).lower()
    assert K.trace_block.last_instance == (
        f"mega_regen<-32, false, {b}>" if regen else f"mega_lockstep<-32, {b}>")
    plain = trace_block_ref if regen else trace_block_lockstep_ref
    r2, ry2 = plain(tables, cs, 13, 0, 2, n, 4)
    assert torch.equal(ry, ry2)
    assert torch.equal(r, r2), f"{(r != r2).sum().item()} of {n} lanes differ"


@pytest.mark.gpu
@pytest.mark.parametrize("regen", [True, False])
def test_deep_bvh_refused_for_the_card(cuda_card, regen):
    """Nothing is refused any more: trees of BVH_STACK + 1 and 64 levels,
    and interior-first chains of 48, 64 and 128 levels (whose walks' stacks
    hold 47, 63 and 127 entries), take the deep instances (their walk stacks
    in device memory), which equal the plain version bitwise on every lane
    and the same box on its own shallow tree (both walks exact), at 4 light samples
    and at 7 and (the chains) 40 (the generic instances); the regenerating
    kernel's under the sky too (its env instances; the lockstep kernel takes
    no env map)."""
    from chip_smoke import chain_pack, cornell_x4

    plain = trace_block_ref if regen else trace_block_lockstep_ref
    for sky in (False, True) if regen else (False,):
        sc = cornell_x4(sky=sky)
        shallow = SceneTables.from_pack(sc.compile(cluster_threshold=8), device="cuda")
        cs = cam_static(dataclasses.replace(sc.camera, width=W, height=H))
        n = W * H * 3
        for levels, inner in ((BVH_STACK + 1, False), (64, False), (48, True), (64, True),
                              (128, True)):
            deep = SceneTables.from_pack(chain_pack(levels, sky=sky, interior_first=inner),
                                         device="cuda")
            assert deep.use_env == sky
            for n_dir in (4, 7) if inner else (4, 7, 40):
                deep.n_dir_sample = shallow.n_dir_sample = n_dir
                r, ry = K.trace_block(deep, cs, 5, 0, 2, n, 5, regen=regen)
                s_inst = {4: 4, 7: -16, 40: -32}[n_dir]
                assert K.trace_block.last_instance == (
                    f"mega_regen_deep<{s_inst}, {str(sky).lower()}>" if regen
                    else f"mega_lockstep_deep<{s_inst}>")
                r2, ry2 = plain(deep, cs, 5, 0, 2, n, 5)
                assert torch.equal(ry, ry2) and torch.equal(r, r2)
                r3, ry3 = K.trace_block(shallow, cs, 5, 0, 2, n, 5, regen=regen)
                assert torch.equal(ry, ry3) and torch.equal(r, r3)


@pytest.mark.gpu
@pytest.mark.parametrize("regen", [True, False])
def test_sphere_only_leaves_on_the_card(cuda_card, regen):
    """A tree whose every other leaf holds a sphere only (empty children in
    the node table): both kernels' BVH instances equal the plain version
    bitwise on every lane, ray counts included; on a chain of 12 levels and
    of BVH_STACK + 8, whose walks take the deep instances."""
    from chip_smoke import chain_pack, cornell_x4

    cs = cam_static(dataclasses.replace(cornell_x4(sky=False).camera, width=W, height=H))
    n = W * H * 3
    plain = trace_block_ref if regen else trace_block_lockstep_ref
    for levels in (12, BVH_STACK + 8):
        tables = SceneTables.from_pack(chain_pack(levels, sphere_leaves=True), device="cuda")
        r, ry = K.trace_block(tables, cs, 21, 0, 2, n, 6, regen=regen)
        torch.cuda.synchronize()
        inst = K.trace_block.last_instance
        assert inst.endswith("true>") if levels <= BVH_STACK else "_deep<" in inst
        r2, ry2 = plain(tables, cs, 21, 0, 2, n, 6)
        assert torch.equal(ry, ry2)
        assert torch.equal(r, r2), f"{(r != r2).sum().item()} of {n} lanes differ"


@pytest.mark.gpu
def test_conf_cli_takes_more_than_32_light_samples(cuda_card, tmp_path):
    """`python -m mcpt_tpu_torch --conf ... --no-strict-parity` with
    directLightSample 40 renders on the card through the megakernel (the
    instance of 32, two groups a vertex), on small stand-in meshes."""
    import json

    from chip_smoke import write_stand_in_models
    from mcpt_tpu_torch.__main__ import main

    write_stand_in_models(tmp_path, segs_steps=(8, 8))
    conf = json.loads((Path(__file__).resolve().parent.parent / "conf.json").read_text())
    conf["scene"]["directLightSample"] = 40
    conf["scene"]["envMap"] = str(SKY)
    (tmp_path / "conf.json").write_text(json.dumps(conf))
    name = "mega_regen<-32, true, true>"
    before = K.trace_block.by_instance[name]
    out = tmp_path / "out.png"
    main(["--conf", str(tmp_path / "conf.json"), "--models-dir", str(tmp_path),
          "--no-strict-parity", "--width", "48", "--height", "27", "--spp", "1",
          "--out", str(out)])
    assert K.trace_block.by_instance[name] > before
    assert out.exists()


@pytest.mark.gpu
def test_train_step_gradients_through_the_kernel_bitwise(cuda_card, monkeypatch):
    """The training path's loss and gradients on the card through K2 equal,
    bitwise, the same through the plain version in the kernel's place on the
    same card (the kernel's hits carry no gradient either way)."""
    from mcpt_tpu_torch import prng
    from mcpt_tpu_torch.diff import SceneParams, apply_params, params_from_pack, render_lanes
    from mcpt_tpu_torch.parallel import replicate_pack

    sc = demo_scene()
    host = sc.compile()
    cam = dataclasses.replace(sc.camera, width=W, height=H)
    (pack, method), = replicate_pack(host, ["cuda"]).values()
    assert method == "kernel"
    ids = torch.arange(W * H, device="cuda")

    def grads():
        p = [x.requires_grad_() for x in params_from_pack(host, "cuda")]
        fb = render_lanes(apply_params(pack, SceneParams(*p)), cam, ids,
                          prng.key(3, "cuda"), spp=2, max_bounces=4, method=method)
        loss = (fb ** 2).mean()
        return [loss.detach(), *torch.autograd.grad(loss, p)]

    IP.intersect_prims_c.by_mode.clear()
    got = grads()
    assert IP.intersect_prims_c.by_mode["occlusion fan"] > 0
    assert all(bool(torch.isfinite(g).all()) for g in got)
    monkeypatch.setattr(IP, "_launch", lambda tri, sph, base, oc, dc, occ, walk=None, fan=0:
                        intersect_prims_ref(tri, sph, base, oc, dc, occlusion=occ, fan=fan))
    for a, b in zip(got, grads()):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_hybrid_step_launches_both_kernels(cuda_card):
    """make_train_step_hybrid on the card renders its residual through K1
    and pulls it back through K2; its gradients are finite and move the
    parameters."""
    from mcpt_tpu_torch import prng
    from mcpt_tpu_torch.diff import make_train_step_hybrid

    sc = demo_scene()
    host = sc.compile()
    cam = dataclasses.replace(sc.camera, width=W, height=H)
    target, _ = render_mega(host, cam, 8, seed=1, max_bounces=4, device="cuda")
    init_fn, step = make_train_step_hybrid(host, cam, 0.5 * target, spp_res=8, spp_grad=1,
                                           max_bounces=4, device="cuda")
    params, opt = init_fn()
    start = [p.detach().clone() for p in params]
    k1 = K.trace_block.by_instance["mega_regen<4, false, false>"]
    IP.intersect_prims_c.by_mode.clear()
    params, opt, loss = step(params, opt, prng.key(0, "cuda"), 0)
    assert K.trace_block.by_instance["mega_regen<4, false, false>"] > k1
    assert IP.intersect_prims_c.by_mode["occlusion fan"] > 0
    assert np.isfinite(loss)
    assert any(bool((a.detach() != b).any()) for a, b in zip(params, start))


def _bwd_case(scene):
    """(pack on the card, camera rays of a 48x32 image at three lanes a
    pixel, their hits, the depth-0 shade_pre and random output gradients)
    of the DEMO, the sky-lit DEMO, the DEMO at 40 light samples or the DEMO
    seen through a thin lens with an emissive sphere."""
    from chip_smoke import lens_lamp_demo
    from mcpt_tpu_torch import prng
    from mcpt_tpu_torch.intersect import intersect_c
    from mcpt_tpu_torch.kernels import wavefront as WF
    from mcpt_tpu_torch.kernels import wavefront_ref as ref

    sc = lens_lamp_demo() if scene == "lens" else demo_scene()
    if scene == "sky":
        sc.load_env_map(SKY)
    if scene == "forty":
        sc.n_dir_sample = 40
    pack = pack_to(sc.compile(), "cuda")
    cam = dataclasses.replace(sc.camera, width=48, height=32)
    key = prng.key(9, "cuda")
    o, d = WF.camera_rays(cam, torch.arange(48 * 32, device="cuda"), key, 3)
    b = o[0].numel()
    chan = torch.arange(b, device="cuda") % 3
    lam = torch.tensor([0.7, 0.5461, 0.4358], device="cuda")[chan]
    alive = torch.ones(b, dtype=torch.bool, device="cuda")
    hit = intersect_c(pack, o, d)
    pre = WF.shade_pre(pack, o, d, hit, alive, 0, key, lam, chan)
    gen = torch.Generator(device="cuda").manual_seed(3)
    s = ref.n_samples(pack)
    grads = {k: torch.randn(b, generator=gen, device="cuda") for k in (*ref.RAY_OUT,
                                                                        *ref.LEAF_OUT)}
    grads["contrib"] = torch.randn(s * b, generator=gen, device="cuda")
    return pack, (o, d, hit, alive, key, lam, chan), pre, grads, gen


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["demo", "sky", "forty", "lens"])
def test_backward_kernels_equal_their_plain_versions(cuda_card, scene):
    """shade_pre_bwd (with and without the next ray's seeds), shade_post_bwd
    and fold_bwd on the card equal their plain versions (the hand-written
    reverse modes of kernels/wavefront_ref.py) bitwise, and each launches."""
    from mcpt_tpu_torch.intersect import occlude_t_c
    from mcpt_tpu_torch.kernels import wavefront as WF
    from mcpt_tpu_torch.kernels import wavefront_ref as ref

    pack, (o, d, hit, alive, key, lam, chan), pre, grads, gen = _bwd_case(scene)
    WF.reset_counts()
    for g in (grads, {k: v for k, v in grads.items() if k not in ref.RAY_OUT}):
        args = (pack, o, d, hit, alive, 0, key, lam, chan, g)
        got = WF.shade_pre_bwd(*args, route="cuda")
        want = WF.shade_pre_bwd(*args, route="plain")
        for a, w in zip([*got[0], *got[1], got[2], got[3]], [*want[0], *want[1], *want[2:]]):
            assert torch.equal(a.view(torch.int32), w.view(torch.int32))
    s = ref.n_samples(pack)
    sh_t = occlude_t_c(pack, pre.p_dl, pre.ws, fan=s)
    gs = [torch.randn(o[0].numel(), generator=gen, device="cuda") for _ in range(3)]
    for a, w in zip(WF.shade_post_bwd(pre, sh_t, s, *gs, route="cuda"),
                    WF.shade_post_bwd(pre, sh_t, s, *gs, route="plain")):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
    b = o[0].numel()
    rec = ref.Records(torch.randn((5, b), generator=gen, device="cuda") * 4,
                      torch.rand((5, b), generator=gen, device="cuda") * 3,
                      torch.rand((5, b), generator=gen, device="cuda") * 6,
                      torch.rand((5, b), generator=gen, device="cuda") < 0.3)
    for a, w in zip(WF.fold_bwd(rec, gs[0], route="cuda"), WF.fold_bwd(rec, gs[0], route="plain")):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
    assert all(WF.launches[k] > 0 for k in WF.BWD_KERNELS)


@pytest.mark.gpu
def test_train_step_runs_the_backward_kernels(cuda_card):
    """The train step's pass on the card runs the wavefront's kernels forward
    and its backward kernels back, no `plain (autograd)` call, and two runs
    give the same gradients bit for bit (fold_rows' fixed order)."""
    from mcpt_tpu_torch import prng
    from mcpt_tpu_torch.diff import SceneParams, apply_params, params_from_pack, render_lanes
    from mcpt_tpu_torch.kernels import wavefront as WF
    from mcpt_tpu_torch.parallel import replicate_pack

    sc = demo_scene()
    host = sc.compile()
    cam = dataclasses.replace(sc.camera, width=W, height=H)
    (pack, method), = replicate_pack(host, ["cuda"]).values()
    runs = []
    for _ in range(2):
        WF.reset_counts()
        p = [x.requires_grad_() for x in params_from_pack(host, "cuda")]
        fb = render_lanes(apply_params(pack, SceneParams(*p)), cam,
                          torch.arange(W * H, device="cuda"), prng.key(3, "cuda"), spp=2,
                          max_bounces=4, method=method)
        runs.append(torch.autograd.grad(((fb - 0.2) ** 2).mean(), p))
        assert {r for (_, r) in WF.calls} == {"cuda"}
        assert all(WF.launches[k] > 0 for k in (*WF.KERNELS, *WF.BWD_KERNELS))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n,rows,cols", [(2304, 9, 13), (442368, 9, 13), (1769472, 2, 17)])
def test_take_rows_is_the_gather_with_a_deterministic_backward(cuda_card, n, rows, cols):
    """megakernel_ref.take_rows at the train step's sizes (a material table
    read by 442,368 lanes, the emitter rows by 1,769,472 shadow rays): the
    forward is advanced indexing's gather bit for bit, and the backward
    gives the same bits on every run, within float32 rounding of a float64
    sum."""
    from mcpt_tpu_torch.kernels.megakernel_ref import take_rows

    gen = torch.Generator(device="cuda").manual_seed(n)
    idx = torch.randint(0, rows, (n,), device="cuda", generator=gen)
    g = torch.randn(n, cols, device="cuda", generator=gen)
    t0 = torch.randn(rows, cols, device="cuda", generator=gen)
    got = []
    for _ in range(8):
        t = t0.clone().requires_grad_()
        out = take_rows(t, idx)
        assert torch.equal(out, t0[idx])
        got.append(torch.autograd.grad(out, t, grad_outputs=g)[0])
    assert all(torch.equal(got[0].view(torch.int32), x.view(torch.int32)) for x in got)
    want = torch.zeros(rows, cols, dtype=torch.float64, device="cuda")
    want.index_add_(0, idx, g.double())
    scale = torch.zeros_like(want).index_add_(0, idx, g.double().abs())
    assert bool(((got[0].double() - want).abs() <= 1e-5 * scale + 1e-6).all())


def _wavefront_scene(name, tmp_path):
    sc = demo_scene()
    if name == "sky":
        sc.load_env_map(SKY)
    elif name == "forty":
        sc.n_dir_sample = 40
    elif name == "walk":
        sc = _soldier_scene(tmp_path, (12, 10))
    elif name == "lens lamp":
        sc.add(Sphere((200.0, 120.0, 300.0), 40.0, make_light_material(1.0), "lamp"))
        sc.camera = dataclasses.replace(sc.camera, use_dof=True, focal_distance=800.0,
                                        aperture_radius=8.0)
    return sc


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["demo", "sky", "forty", "walk", "lens lamp"])
def test_wavefront_kernels_bitwise(cuda_card, tmp_path, name):
    """csrc/wavefront.cu on the card against its plain versions on the same
    CUDA inputs, bounce by bounce: the camera rays (a thin lens in `lens
    lamp`), every field of shade_pre (an emissive sphere's light samples in
    `lens lamp`), shade_post's records row, next alive and ray count, the
    fold; then trace_paths_c through both routes."""
    from mcpt_tpu_torch import prng
    from mcpt_tpu_torch.constants import WAVELEN_UM
    from mcpt_tpu_torch.integrator import trace_paths_c
    from mcpt_tpu_torch.intersect import intersect_c, occlude_t_c
    from mcpt_tpu_torch.kernels import wavefront as WF
    from mcpt_tpu_torch.kernels import wavefront_ref as ref
    from mcpt_tpu_torch.parallel import replicate_pack

    sc = _wavefront_scene(name, tmp_path)
    host = sc.compile(cluster_threshold=64) if name == "walk" else sc.compile()
    (pack, method), = replicate_pack(host, ["cuda"]).values()
    assert (pack.walk is not None) == (name == "walk")
    assert (pack.n_sph_emitters == 1) == (name == "lens lamp") == sc.camera.use_dof
    cam = dataclasses.replace(sc.camera, width=W, height=H)
    ids = torch.arange(W * H, device="cuda")
    key = prng.key(6, "cuda")
    b, s = 3 * W * H, ref.n_samples(pack)
    chan = torch.arange(3, device="cuda").repeat(W * H)
    lam = torch.tensor(WAVELEN_UM, device="cuda")[chan]
    before = dict(WF.launches)
    o, d = WF.camera_rays(cam, ids, key, 3)
    for g, w in zip((*o, *d), sum(ref.camera_rays(cam, ids, key, 3), ())):
        assert torch.equal(_bits(g), _bits(w))
    o0, d0 = o, d
    hit = intersect_c(pack, o, d, method=method)
    alive = torch.ones(b, dtype=torch.bool, device="cuda")
    rec, rec_p = ref.new_records(6, b, "cuda"), ref.new_records(6, b, "cuda")
    rays, rays_p = (torch.zeros((), dtype=torch.int64, device="cuda") for _ in range(2))
    for depth in range(6):
        args = (pack, o, d, hit, alive, depth, key, lam, chan)
        pre = WF.shade_pre(*args)
        for f, g, w in zip(ref.PreOut._fields, pre, ref.shade_pre(*args)):
            pairs = zip(g, w) if isinstance(g, tuple) else ((g, w),)
            for gg, ww in pairs:
                assert torch.equal(_bits(gg), _bits(ww)), f"depth {depth} {f}"
        sh_t = occlude_t_c(pack, pre.p_dl, pre.ws, method=method, fan=s)
        nxt = intersect_c(pack, pre.p_new, pre.wi, method=method)
        nxt_alive = WF.shade_post(pack, pre, sh_t, nxt.prim, rec, depth, rays)
        assert torch.equal(nxt_alive, ref.shade_post(pack, pre, sh_t, nxt.prim, rec_p, depth,
                                                     rays_p))
        for f in ref.Records._fields:
            assert torch.equal(_bits(getattr(rec, f)[depth]), _bits(getattr(rec_p, f)[depth]))
        assert int(rays) == int(rays_p)
        o, d, hit, alive = pre.p_new, pre.wi, nxt, nxt_alive
    rad = WF.fold(rec)
    assert torch.equal(_bits(rad), _bits(ref.fold(rec)))
    assert all(WF.launches[k] > before.get(k, 0) for k in WF.KERNELS)
    r_k, st_k = trace_paths_c(pack, o0, d0, lam, chan, key, max_bounces=6, method=method,
                              early_exit=False)
    with WF.plain_route():
        r_p, st_p = trace_paths_c(pack, o0, d0, lam, chan, key, max_bounces=6, method=method,
                                  early_exit=False)
    assert torch.equal(_bits(r_k), _bits(rad)) and torch.equal(_bits(r_k), _bits(r_p))
    assert int(st_k.rays) == int(st_p.rays) == int(rays) + b


def _camera_edges():
    from chip_smoke import CAMERA_EDGES

    return CAMERA_EDGES


@pytest.mark.gpu
@pytest.mark.parametrize("dof", [False, True])
@pytest.mark.parametrize("per", [1, 3])
@pytest.mark.parametrize("pixels,first,offset", _camera_edges())
def test_camera_rays_edges_bitwise(cuda_card, pixels, first, offset, per, dof):
    """camera_rays on the card against its plain version, all six planes
    bitwise (`chip_smoke.camera_edge`), through the instance its C entry
    picks: the vector one where its floats a store divide the lane count,
    the scalar one elsewhere (`chip_smoke.camera_instance`)."""
    import collections

    import chip_smoke as cs
    from mcpt_tpu_torch.kernels import wavefront as WF

    was = collections.Counter(WF.by_instance)
    for name, got, want in cs.camera_edge(pixels, first, offset, per, dof, "cuda"):
        assert got.shape == (pixels * per,) and torch.equal(_bits(got), _bits(want)), name
    assert WF.by_instance - was == collections.Counter({cs.camera_instance(pixels, per): 1})


@pytest.mark.gpu
@pytest.mark.parametrize("s,shadows", [(0, True), (1, True), (4, True), (40, True), (4, False)])
@pytest.mark.parametrize("b,offset", [(1, 0), (3, 0), (4, 0), (5, 0), (6, 0), (4096, 0),
                                      (4097, 0), (4096, 1)])
def test_shade_post_edges_bitwise(cuda_card, b, offset, s, shadows):
    """shade_post on the card against its plain version on adversarial
    inputs (`chip_smoke.post_case`: NaN, ±inf, ±0 and the clamp's edges,
    shadow t equal to its threshold) at ragged lane counts, 0 to 40 light
    samples and with shadows off, writing row 2 of three records: every
    record row, the next alive and the ray count bitwise; the vector
    instance where its lanes divide b and the planes start on its grid, the
    scalar one elsewhere (`chip_smoke.edge_instance`)."""
    import collections

    import chip_smoke as cs
    from mcpt_tpu_torch.kernels import wavefront as WF

    was = collections.Counter(WF.by_instance)
    for name, got, want in cs.post_edge(b, s, 10 * b + s, "cuda", shadows, offset):
        assert torch.equal(_bits(got), _bits(want)), name
    assert WF.by_instance - was == collections.Counter({cs.edge_instance(b, offset): 1})


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 8, 20])
@pytest.mark.parametrize("b,offset", [(1, 0), (3, 0), (4, 0), (5, 0), (6, 0), (4096, 0),
                                      (4097, 0), (4096, 1)])
def test_fold_adversarial_records_bitwise(cuda_card, b, offset, depth):
    """The fold on the card against its plain version on adversarial
    records (`chip_smoke.fold_records`: the first terminal depth at every
    depth and none, NaN, ±inf and ±1e30 after it, the clamps' edges
    before it), bitwise, in one launch."""
    import chip_smoke as cs
    from mcpt_tpu_torch.kernels import wavefront as WF

    was = WF.launches["fold"]
    for name, got, want in cs.fold_edge(depth, b, 10 * b + depth, "cuda", offset):
        assert torch.equal(_bits(got), _bits(want)), name
        assert bool(torch.isfinite(got).all())
    assert WF.launches["fold"] == was + 1


@pytest.mark.gpu
def test_render_radiance_launches_the_wavefront_kernels(cuda_card):
    """render_radiance on the card launches camera_rays, shade_pre,
    shade_post and fold and runs no plain route; its image and rays equal
    the plain route's bitwise."""
    from mcpt_tpu_torch.kernels import wavefront as WF
    from mcpt_tpu_torch.render import ran_since, wavefront_counts

    sc = demo_scene()
    cam = dataclasses.replace(sc.camera, width=W, height=H)
    kw = dict(max_bounces=4, tile_pixels=256, spp_chunk=2, device="cuda")
    WF.reset_counts()
    before = wavefront_counts()
    img, stats = render_radiance(sc, cam, 4, 3, **kw)
    assert all(WF.launches[k] > 0 for k in WF.KERNELS)
    assert {r for _, r in WF.calls} == {"cuda"}
    assert WF.launches["shade_pre"] == WF.launches["shade_post"]
    assert ran_since(before).startswith("route cuda, intersector kernel launches {'nearest': ")
    WF.reset_counts()
    with WF.plain_route():
        img2, stats2 = render_radiance(sc, cam, 4, 3, **kw)
    assert not WF.launches and {r for _, r in WF.calls} == {"plain"}
    assert stats["rays"] == stats2["rays"]
    np.testing.assert_array_equal(img.view(np.int32), img2.view(np.int32))


@pytest.mark.gpu
def test_train_route_keeps_the_plain_halves(cuda_card):
    """Under autograd with grad-requiring parameters the bounce's halves now
    launch the kernels too (the Functions of `kernels/wavefront.py`, route
    `cuda`), their gradient through the backward kernels; the plain halves
    under autograd (route `plain (autograd)`) run only inside
    `autograd_oracle()`, to the same radiance and within 1e-5 relative or
    1e-6 of the largest of the same gradient; under torch.no_grad the same
    render launches the kernels, with the same radiance."""
    from mcpt_tpu_torch import prng
    from mcpt_tpu_torch.diff import SceneParams, apply_params, params_from_pack, render_lanes
    from mcpt_tpu_torch.kernels import wavefront as WF
    from mcpt_tpu_torch.parallel import replicate_pack

    host = demo_scene().compile()
    cam = dataclasses.replace(demo_scene().camera, width=W, height=H)
    (pack, method), = replicate_pack(host, ["cuda"]).values()
    ids = torch.arange(W * H, device="cuda")
    p = SceneParams(*(x.requires_grad_() for x in params_from_pack(host, "cuda")))
    WF.reset_counts()
    fb = render_lanes(apply_params(pack, p), cam, ids, prng.key(3, "cuda"), spp=1,
                      max_bounces=3, method=method)
    assert WF.calls[("shade_pre", "cuda")] > 0 and WF.launches["shade_pre"] > 0
    assert not any(r == "plain (autograd)" for (_, r) in WF.calls)
    g = torch.autograd.grad(fb.sum(), [p.light_scale])[0]
    assert bool(torch.isfinite(g)) and float(g) != 0.0
    assert all(WF.launches[k] > 0 for k in WF.BWD_KERNELS)
    with WF.autograd_oracle():
        fb3 = render_lanes(apply_params(pack, p), cam, ids, prng.key(3, "cuda"), spp=1,
                           max_bounces=3, method=method)
        assert WF.calls[("shade_pre", "plain (autograd)")] > 0
        g3 = torch.autograd.grad(fb3.sum(), [p.light_scale])[0]
    assert torch.equal(_bits(fb.detach()), _bits(fb3.detach()))
    assert abs(float(g) - float(g3)) <= 1e-5 * abs(float(g3))
    with torch.no_grad():
        fb2 = render_lanes(apply_params(pack, p), cam, ids, prng.key(3, "cuda"), spp=1,
                           max_bounces=3, method=method)
    assert WF.launches["shade_pre"] > 0
    assert torch.equal(_bits(fb.detach()), _bits(fb2))
