"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Drives `mcpt_tpu_torch` (never jax, never mcpt_tpu) through its main paths
and checks them. Each phase prints its lines and its seconds; every failure
raises, so the script exits nonzero and prints no result line.

1. environment: card, torch, CUDA, nvcc, Triton; a CUDA device is required
2. build: csrc/megakernel.cu, csrc/mega_lockstep.cu, csrc/intersect_prims.cu,
   csrc/wavefront.cu and csrc/wavefront_bwd.cu with nvcc for sm_90a (one
   nvcc each, started together), from this checkout; the registers and
   spills of every kernel instance, the deep instances' among them, and
   each source's build seconds (the wavefront kernels' ptxas lines tagged
   `[ptxas] wavefront.cu` and `[ptxas] wavefront_bwd.cu`)
3. the DEMO kernel (`mega_regen<4, false, false>`) against its plain PyTorch
   version, both on the card: at 64x48, spp 8, mb 6, seed 11, and at the main
   path's lane count (384x384x3 lanes, mb 8) with spp 2. Every megakernel
   comparison of this script (`kernel_vs_plain`) asks both output planes,
   radiance and ray counts, bitwise equal to the plain version's on every
   lane; it also prints phase 3's earlier bounds (`agree`: total rays within
   0.5%, per-lane ray counts equal on >= 98% of lanes, radiance off by more
   than 1e-3 on < 2% of lanes, means within 5e-3) and the instance's
   registers and resident blocks per SM (`megakernel.instance_info`)
4. DEMO main path: `render_mega` of the native 384x384 DEMO at spp 256, mb 8,
   which must launch the kernel. Tonemapped and block-averaged 4x4 to
   96x96, it is held to tests/data/reference_fresh_demo_spp512.png (the
   reference C++ renderer's output, reduced the same way) with
   tests/test_golden.py's bounds: correlation > 0.9, quadrant means within
   6.5/255, 12x12 tile means within 24/255. test_golden's fourth bound,
   per-channel means within 2.5/255, is one that the JAX megakernel itself
   does not meet: in test_golden's own configuration (96x96, spp 48, mb 8,
   seed 0) `mcpt_tpu`'s `render_mega(interpret=True)` measures +2.844/255 in
   red against this reference (its documented brightness surplus,
   tests/test_golden.py docstring). So that configuration runs here too,
   through the same main path, and its per-channel mean gaps must equal the
   JAX megakernel's recorded gaps within 0.25/255; the 384x384 render's
   channel means are printed and held to the quadrant bound. One more
   384x384 render between CUDA events gives the kernel's time per launch
5. throughput: 1920x1080 DEMO at spp 64, mb 8, rays counted as bench.py does;
   one more render under torch.profiler: device time by kernel, idle share
6. (a) the env and BVH kernels against their plain versions on the card:
   the env instance (`mega_regen<4, true, false>`) on the DEMO under
   assets/sky.png, and the BVH+env instance (`mega_regen<4, true, true>`)
   on the x4-scaled Cornell box (tests/test_megakernel.py:207-279) under
   assets/sky.png with cluster_threshold=8, at 64x48 spp 8 mb 6 and at
   384x384x3 lanes spp 2 mb 8. Per-lane ray counts equal on every lane,
   radiance within phase 3's bounds. Then the env instance's main path:
   `render_mega` of the 384x384 DEMO under assets/sky.png at spp 64, mb 8,
   which must launch `mega_regen<4, true, false>`, and once more between
   CUDA events for the time per launch
7. (b) the BVH walk against the shared-memory sweep on the DEMO, both
   through the kernel (`mega_regen<4, false, true>` vs `<4, false, false>`)
   at 384x384, spp 4, mb 8: ray counts equal on every lane, radiance within
   phase 3's bounds
8. (c) the `--conf conf.json` main path at full width: stand-in OBJ meshes
   (`write_stand_in_models`, 38,528 triangles in all) in a temp models dir,
   `config.build_scene` -> `Scene.compile()` -> `render_mega` at 1920x1080,
   DoF on, assets/sky.png, mb 8, spp CONF_SPP (conf.json asks 32); first the
   kernel against its plain version on one block of that render, on the
   same tables: lanes CONF_BLOCK_OFFSET.. (the render's costliest block,
   rows through the pieces), 384x384x3 of them, spp 1, mb 8, phase 3's
   bounds with every lane's ray count equal; one more render under
   torch.profiler as in phase 5, and one between CUDA events for the time
   per launch
9. (d) the wavefront intersector `csrc/intersect_prims.cu` in its K2 form
   (at most 1024 triangle rows, one shared-memory tile) on the DEMO's
   tables, at one wavefront tile's NEE batch: the 1920x1080 camera rays of
   the first 65,536-pixel tile (three channel lanes each) and three shadow
   rays per lane toward light samples, 786,432 rays. Nearest and occlusion
   modes against the plain version on the same CUDA tensors: t, prim, u, v
   bitwise equal on every ray; kernel ms, plain ms, bound, and the dense
   method's ms on the same rays. Then the render's own shadow batch in the
   occlusion sweep's fan form (`fan_vs_plain`): the same tile's first hits
   as B = 196,608 origins with FAN = 4 directions each, ray k·B + i from
   origin i, as `direct_lighting_c` sends it; the fan form and the generic
   occlusion mode on the origins expanded, each bitwise against the plain
   version and against each other, with their times and bounds (the fan's
   bound counts each origin's terms once)
10. (e) K3's range: the DEMO plus one stand-in soldier (2,560 triangles) on
   the floor, 2,592 triangles (more than 1024 rows, padded table <= 4096),
   with a BVH (above cluster_threshold): the bare table, which the kernel
   sweeps tile by tile, with the same checks as (d); then the walk modes
   over the pack's tables (`pack.walk`, from `pack_to(..., walk=True)` as
   the wavefront render moves such a scene) on the same rays, bitwise equal
   on every ray to the all-pairs plain version and to the tiled modes
   (here and in (d) and (f) float32 is compared as int32 bits), and the fan
   form tiled on that scene's fan batch as in (d). Their
   bound is the plain walk's tally (`intersect_walk_ref` on every 12th ray,
   scaled to all; bitwise equal to the kernel there too) x `OPS_PER`, or the
   rays' bytes and every table read once; the sweep's own bound is printed
   beside it
11. (f) K4: the triangles-only mode on the DEMO's triangles at (d)'s
   786,432 rays, bitwise against its plain version; timed as the launch
   alone on the component planes, and `intersect_tris` on (B, 3) rows
   (its two transposing copies included) checked and timed beside it
11b. (d-deep) trees deeper than the walks' local stack: the x4 box with its
   tree replaced by the chain of BVH_STACK + 1 levels, whose walks hold one
   stack entry, and by interior-first chains of 48, 64 and 128 levels,
   whose walks push a leaf a level (47, 63 and 127 entries: `chain_pack`;
   in the megakernels every entry in device memory, in K3 past the
   two-tier stack's shared DEEP_TIER entries runs of DEEP_RUN go out to
   device memory and back, csrc/deep_stack.cuh), through the
   deep instances `mega_regen_deep<4, false>`, `mega_lockstep_deep<4>` and
   the generic ones at 7 light samples, and each tree under the sky
   through `mega_regen_deep<4, true>` and `mega_regen_deep<-16, true>`
   (DEEP_CHECK: 32x24, spp 2, mb 3), each bitwise against its plain version, against
   the box on its own shallow tree and (the interior-first chains) against
   the chain of as many levels (ray counts and radiance equal on every
   lane), and K3's deep walk on each tree (196,608 rays), bitwise against
   its plain version and those trees' walks; the stack's cost:
   `mega_regen_deep<4, false>` and `mega_lockstep_deep<4>` timed at a
   launch that fills the card (DEEP_LANES lanes of the 1080p box, spp 1,
   mb 8) on the 64-level chain
   and interior-first chain, which hold the same leaves, bitwise
   against the plain version on every DEEP_STRIDE-th lane, whose tally,
   scaled, gives the bound, printed beside the kernel's time with the
   stack's device bytes; K3's deep walk, nearest and occlusion, on 196,608
   rays on both, bitwise against its plain version, printed with the
   entries its two-tier stack moves out and back (`spill`, `fill`) and its
   device bytes; `render_mega`
   of the 64-level interior-first chain (both kernels, at 4 and 7 light
   samples, and the regenerating kernel under the sky: each deep instance
   must launch) and `render_radiance` with method auto, which must take the
   deep walk
12. (g) the wavefront main path: `render_radiance` of the DEMO at 1920x1080,
   spp WF_SPP, mb 8, method auto, tiles of 65,536 pixels, spp chunks of 8,
   which must launch the four kernels of csrc/wavefront.cu (`camera_rays`,
   `shade_pre`, `shade_post`, `fold`; no plain route) and the intersector in
   its nearest mode and the occlusion fan form; then the same render through
   the plain route (`wavefront.plain_route()`, the kernels' plain versions
   on the card): the image bitwise equal, the ray count equal, both walls. One tile's
   render (256x256, spp 1) through each route: one run counted (bounces,
   launches), one under torch.profiler (wall, device busy, idle share,
   launches and device events a bounce). The 384x384 DEMO through the
   wavefront at spp 64 (in one tile) against phase 4's megakernel render
   (spp 256), two independent estimates of one image: whole-image means
   within 3%, correlation of 12x12 block means > 0.95; (e)'s scene through
   the wavefront at 384x384, spp 8, whose triangles must go through the walk
   modes alone, then its spp 1 render under torch.profiler; the stand-in
   `--conf` scene (38,528 triangles) through the CLI's `--engine wavefront`
   at 384x216, spp 1, which must launch the walk modes alone, once for each
   primary batch and bounce (no query takes the eager `bvh` method); then
   the same scene and size (the thin lens, the sky map and the textured
   floor) through `render_radiance` by both routes, the images bitwise equal
   and the ray counts equal
12b. (l) the wavefront kernels against their plain versions on the card, on
   one 65,536-pixel tile (256x256, three channel lanes each), spp 1, mb 8,
   of the DEMO, the sky-lit DEMO, the DEMO + soldier (the walk), the DEMO
   at 40 light samples and the DEMO seen through a thin lens with an
   emissive sphere: bounce by bounce on the same inputs, the camera
   rays, every field of `shade_pre` (next rays, the shadow fan, the per-lane
   terms), `shade_post`'s records row, next alive and ray count, and the
   fold's radiance, bitwise (float32 as int32); then `trace_paths_c` through
   both routes, radiance and rays equal. On the DEMO each kernel's device ms
   at the depth-0 shapes (the fold's on the tile's records), each launch
   timed alone after a read that evicts the L2, the median of 20 (and the
   median of 5 means of 10 back to back, its inputs L2-resident, beside
   it), its plain version's ms and its bound: bytes (every input read once,
   every output written once; the fold's, the records up to each lane's
   first terminal depth, counted on the tile's records), float operations
   (`shade_pre`'s: the plain version's tally, `plain_ops`) and 32-bit
   integer operations (the threefry draws of `camera_rays` and `shade_pre`,
   `DRAW_OPS` each), each term printed and the one that bounds named.
   Then shade_post and fold at their edges (`post_fold_edges`): lane
   counts 1, 3, 4, 5, 6, 4,096 and 4,097 (their rows at depth > 0 off the
   vector's grid where its lanes do not divide b) and views that start off
   it, 0, 1, 4 and 40 light samples and shadows off, records 1, 8 and 20
   deep, on adversarial inputs (`post_case`, `fold_records`: NaN, ±inf, ±1e30 and
   the clamps' edges; the fold's first terminal depth at every depth and
   none), bitwise against the plain versions with the ray count; both
   instances of shade_post (`wavefront.VECTOR_LANES` lanes a thread, and
   1) must launch, each where the lane count and the alignment say, and
   the fold once a case. Before them the camera rays at theirs
   (`camera_edges`): pixel counts 1, 3, 4, 5, 43, 256, 257, 4,096, 4,099, a
   tile's ids at an offset, ids to both sides of 2^31 and below 0, a view
   of the ids off the 16-byte grid, at 1 and 3 lanes a pixel, pinhole and
   thin lens, bitwise, each through the instance the lane count calls for
   (`wavefront.CAMERA_VECTOR` floats a store, or 1), both of which must
   launch. The camera's bound counts its work a pixel (`OPS_PER['camera']`
   and 2 draws, 4 through a thin lens), whose ray its lanes repeat
13. (h) the lockstep kernel K1b (`csrc/mega_lockstep.cu`, `render_mega(...,
   regen=False)`) and the lane-strided sharded render:
   (h1) `mega_lockstep<4, false>` against its plain version on the card on
   the DEMO at 64x48 spp 8 mb 6 seed 11 and at 384x384x3 lanes spp 2 mb 8,
   then `mega_lockstep<4, true>` on the x4 Cornell box (cluster_threshold=8,
   no env map) at the same two sizes: phase 3's bounds with every lane's
   ray count equal.
   (h2) the lockstep main path: `render_mega(regen=False)` of the 384x384
   DEMO at spp 256, mb 8, which must launch `mega_lockstep<4, false>`, held
   to phase 4's test_golden bounds and against phase 4's regen image (an
   independent estimate of the same image), both as displayed (pixels
   clipped to [0, 1], as the golden check's tonemap clips them; the raw
   estimator keeps the reference's unclamped roulette early return, whose
   rare samples reach -2e5): whole-image means within 1%, 12x12 block-mean
   correlation > 0.99; one more render under torch.profiler and one between
   CUDA events; then the x4 Cornell box's lockstep render at 384x384, spp 16,
   mb 8, which must launch `mega_lockstep<4, true>` (and once more between
   CUDA events).
   (h3) throughput: the 1920x1080 DEMO at spp 64, mb 8, regen=False, median
   of 3 in rays/s, one more render under torch.profiler.
   (h4) stride equivalence on one card: `render_mega_sharded(devices=
   ["cuda:0"] * 4)` of the 384x384 DEMO at spp 4, mb 8, for regen True and
   False, each image `np.array_equal` to `render_mega`'s with equal rays;
   then `devices=None` (every card) once: per-device rays and pad lanes
14. (i) many samples a lane: both megakernels' per-lane loop over path
   vertices against the plain versions, bitwise on every lane, where each
   lane ends and restarts many paths: `mega_regen<4, false, false>` and
   `mega_lockstep<4, false>` on the DEMO at 96x96x3 lanes, spp 8, mb 8;
   `mega_regen<4, true, true>` (sky) and `mega_lockstep<4, true>` (no sky) on
   the x4 Cornell box at its 48x48x3 lanes, spp 8, mb 8 (a quarter of PR
   10's spp on the DEMO and half on the box, which paid for (d-deep), (k5)
   and its 442,368-lane timings in the script's time)
15. (j) any light-sample count: both megakernels at 40 light samples a
   vertex (the generic instance of 32, two groups a vertex) against their
   plain versions, bitwise on every lane, on the DEMO (brute force) at
   64x48 and the x4 Cornell box (BVH) at 32x24, spp 2, mb 6; then the CLI, `python -m
   mcpt_tpu_torch --conf conf.json --no-strict-parity` with
   directLightSample 40 on the stand-in meshes at 384x216, spp 1, which must
   launch `mega_regen<-32, true, true>`
16. (k) the training path (`diff.py`): `make_train_step` (method auto, so
   K2's sweep and its occlusion fan form; Adam, whose every gradient is
   checked for NaN) on the native 384x384 DEMO (442,368 lanes), spp 2, mb
   4, three steps toward half the megakernel's image, which must launch K2
   in the modes `nearest` and `occlusion fan`, the wavefront's kernels and
   its three backward kernels (no `plain (autograd)` call), and move the
   parameters: fwd ms/spp (`render_lanes` under torch.no_grad, and
   recording the graph), fwd+bwd ms/spp, bwd/fwd, peak memory
   (`torch.cuda.max_memory_allocated`), the wavefront's calls by route, one
   step under torch.profiler (idle share, the backward kernels' device
   ms); (k2) the
   step's loss and gradients at 64x48 on the card and on the CPU (the plain
   versions), with tests/test_torch_diff.py's bounds against JAX; (k3) the
   step over the first 349,526 pixels of the 1920x1080 DEMO (1,048,578
   lanes): ms/spp, peak memory and one profiled step; (k4)
   `make_train_step_hybrid` at 384x384, spp_res 64, spp_grad 2, mb 4, which
   must launch K1 and K2: its wall split between K1's render and the
   pull-back, its pull-back through the backward kernels, its peak memory
   and one profiled step; (k5) the backward kernels
   (`csrc/wavefront_bwd.cu`) bitwise against their plain versions at a
   tile's depth-0 shapes (196,608 lanes; `shade_pre_bwd` also at the
   vertices of depths 1-3, the tile's paths traced on by the kernels)
   on (l)'s DEMO, sky-lit DEMO, DEMO at 40 light samples and thin-lens DEMO
   with an emissive sphere, timed with a cold L2 on the DEMO beside their
   bounds (`shade_pre_bwd`'s float operations its plain version's tally,
   its integer operations its draws'), `shade_pre` and `shade_pre_bwd`
   timed again at the (k1) step's 442,368 lanes, and two train steps' gradients bitwise equal; (k7)
   `entry.dryrun_multichip(4)` (["cuda:0"] x 4 on a host with fewer cards),
   through the backward kernels; (k6) a 384x384
   `render_radiance(trace_dir=...)` writes a torch.profiler Chrome trace
   holding the intersector's kernels
17. the registers, local bytes and resident blocks per SM of each megakernel
   instance in the kernel table, the card, the kernel table as JSON (each
   row's launches are those of its kernel in its own main-path run: the DEMO 384x384 render, the
   sky-lit DEMO render of (a), the --conf render, the wavefront renders of
   (g) (the 1080p render for K2 and the four wavefront kernels, the
   DEMO + soldier render for the walk modes), the lockstep renders of (h2);
   no render launches the triangles-only entry or, since the walk, the
   tiled modes), and the result line
"""

import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from mcpt_tpu_torch import diff, prng
from mcpt_tpu_torch.bench import BASELINE_RAYS_PER_S, card
from mcpt_tpu_torch.builtin_scenes import CORNELL_FLOOR, CORNELL_LEFT, CORNELL_LIGHT
from mcpt_tpu_torch.builtin_scenes import CORNELL_RIGHT, CORNELL_SHORTBOX, CORNELL_TALLBOX
from mcpt_tpu_torch.builtin_scenes import _mesh, demo_scene
from mcpt_tpu_torch.camera import Camera
from mcpt_tpu_torch.config import build_scene, load_config
from mcpt_tpu_torch.entry import dryrun_multichip
from mcpt_tpu_torch.constants import (BVH_STACK, EPSILON, REL_EPS, T_MAX, WAVELEN_UM,
                                      spill_entries)
from mcpt_tpu_torch.film import tonemap
from mcpt_tpu_torch.integrator import trace_paths_c
from mcpt_tpu_torch.intersect import intersect_c, intersect_dense, occlude_t_c
from mcpt_tpu_torch.intersect import surface_at_c
from mcpt_tpu_torch.io.png import read_png
from mcpt_tpu_torch.kernels import build as kbuild
from mcpt_tpu_torch.kernels import intersect_prims as ip
from mcpt_tpu_torch.kernels import megakernel as mk
from mcpt_tpu_torch.kernels import wavefront as wf
from mcpt_tpu_torch.kernels import wavefront_ref as wfr
from mcpt_tpu_torch.kernels.intersect_prims_ref import (
    fan_origins,
    intersect_prims_ref,
    intersect_walk_ref,
)
from mcpt_tpu_torch.kernels.megakernel_ref import (
    cam_static,
    trace_block_lockstep_ref,
    trace_block_ref,
)
from mcpt_tpu_torch.kernels.tables import SceneTables, bvh_depth
from mcpt_tpu_torch.lights import sample_light_c
from mcpt_tpu_torch.materials import make_light_material, standard_materials
from mcpt_tpu_torch.parallel import replicate_pack
from mcpt_tpu_torch.render import _render_tile, render_mega, render_mega_sharded, render_radiance
from mcpt_tpu_torch.scene import Scene, Sphere, TriangleMesh, pack_to
from mcpt_tpu_torch.utils.profiling import TRACE_FILE

ROOT = Path(__file__).resolve().parent
REFERENCE = ROOT / "tests" / "data" / "reference_fresh_demo_spp512.png"
SKY = ROOT / "assets" / "sky.png"
# Per-channel tonemapped mean of mcpt_tpu's render_mega(interpret=True), DEMO
# 96x96, spp 48, mb 8, seed 0 (MCPT_MEGA_SPLIT=1, MCPT_MEGA_UNROLL=1), minus
# the reference's, in 1/255 units: the JAX megakernel's own gap.
JAX_MEGA_GAP_96 = (2.844, 1.153, 1.230)
# phase 5's median with the depth loop nested in the sample loop, before
# the megakernels' flat per-vertex loop (PERF.md, Findings)
EARLIER_DEMO_RATE = 1.7931e9
CONF_SPP = 32
# the 4th of the --conf render's six 2^20-lane blocks, its slowest
CONF_BLOCK_OFFSET = 3 * 2**20
# (g): the wavefront render's samples per pixel at 1920x1080: its plain
# route, which (g) renders too, took 17.9-27.6 s at spp 2 on an H100 (PERF.md)
WF_SPP = 2
# pixels of one wavefront tile (render_radiance's default tile_pixels), a
# square of TILE_SIDE pixels a side in (g)'s and (l)'s tile renders
TILE_SIDE = 256
TILE_PX = TILE_SIDE * TILE_SIDE
# (g): the wavefront main path's resolution
WF_RES = (1920, 1080)
# the device of phases (d)-(g)
DEV = "cuda"
# where (e) stands the stand-in soldier on the DEMO's floor (free of the boxes)
SOLDIER_AT = (140.0, 0.0, 440.0)
# (e): the plain walk tallies the work of every WALK_SUBSET-th ray (65,536
# of the 786,432), scaled to all of them
WALK_SUBSET = 12
# (d), (e): the shadow rays a vertex of the fan batch (the DEMO's
# n_dir_sample)
FAN = 4
# (k): the train step's samples per pixel and bounces, and the pixels of
# its >= 1M-lane cell (3 lanes each: 1,048,578 lanes)
TRAIN_SPP, TRAIN_MB = 2, 4
MILLION_PIXELS = 349_526

# Stand-ins for the reference's chess meshes, which are not in the repo:
# closed surfaces of revolution of 2*S*(R-1) triangles (S segments around,
# R profile steps between the two poles), in their OBJ's local frame (the
# config translates king and soldiers; the diamond keeps its file's
# coordinates). Split: king 2,312 + 14 soldiers x 2,560 + diamond 372 +
# floor 2 + light 2 = 38,528 triangles, the reference scene's count.
STAND_INS = {
    "low_king.obj": (34, 35, 420.0, 110.0, (0.0, 0.0, 0.0), "king"),
    "low_soldier.obj": (32, 41, 260.0, 80.0, (0.0, 0.0, 0.0), "soldier"),
    "diamond.obj": (31, 7, 140.0, 90.0, (278.0, 0.0, -700.0), "diamond"),
}

# float32 operations per unit of tallied work (trace_block_ref's `ops`), counted
# from csrc/megakernel.cu: a Woop test, a fan triangle predicate and its
# per-origin terms, a sphere test, a box test with its accept test, an env
# lookup (normalize, atan2, acos, bilinear), a camera ray, and a shaded
# vertex (BSDF sample, Fresnel, four light samples each with one BSDF
# evaluation, the bounce's evaluation and pdf, the clamp fold).
OPS_PER = {
    "woop": 47, "fan_tri": 31, "fan_origin": 19, "sph": 25, "slab": 26,
    # of a Woop test and a sphere test, the terms of the origin alone, which
    # the intersector's fan form computes once for the fan's rays
    "woop_origin": 18, "sph_origin": 10,
    "env": 60, "camera": 40, "vertex": 800,
    "row": 0,  # a BVH row load: bytes, which `bound` counts once per table
    "stack": 0,  # the walks' stack high-water mark, no operation
    # entries K3's deep walk's two-tier stack moves out to device memory and
    # back (csrc/deep_stack.cuh): bytes, no operation
    "spill": 0, "fill": 0,
}
PEAK_F32 = 67e12  # float32 outside the tensor cores, H100 SXM
# 32-bit integer operations, H100 SXM: 64 INT32 lanes an SM (add, logical,
# shift: CUDA's throughput table for compute capability 9.0) x 132 SMs x
# 1,980 MHz
PEAK_I32 = 64 * 132 * 1.98e9
# integer operations of one threefry2x32 hash (csrc/wf_random.cuh): the key
# schedule's two xors and the counter's add, 20 rounds of add, rotate and
# xor, 5 key injections of 3 adds; a draw (uniform_at) adds xor, shift, or
THREEFRY_OPS = 3 + 20 * 3 + 5 * 3
DRAW_OPS = THREEFRY_OPS + 3
# `cuda_ms`: device clocks of spin a timed run (0.5 ms at 1,980 MHz, several
# times the host's issue of one intersector launch)
SPIN_CYCLES = 1_000_000
PEAK_BYTES = 3.35e12
# `cuda_ms_cold`: a read this large evicts the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def lathe_shape(name, u):
    """Radius profile (fraction of the base radius) at height fraction u."""
    if name == "king":
        return 0.35 + 0.65 * (1 - u) ** 2 + 0.35 * np.exp(-(((u - 0.85) / 0.08) ** 2))
    if name == "soldier":
        return 0.3 + 0.7 * (1 - u) ** 3 + 0.5 * np.exp(-(((u - 0.8) / 0.1) ** 2))
    return 0.2 + 0.8 * np.sin(np.pi * u)


def write_lathe_obj(path, segs, steps, height, radius, center, shape):
    """A closed surface of revolution about the y axis with outward faces:
    a bottom pole, steps-1 rings from y=0 to y=height, a top pole."""
    u = np.linspace(0.0, 1.0, steps - 1)
    ring_y = 0.98 * height * u
    ring_r = radius * lathe_shape(shape, u)
    th = 2.0 * np.pi * np.arange(segs) / segs
    cx, cy, cz = center
    verts = [(cx, cy, cz)]
    for y, r in zip(ring_y, ring_r):
        verts += [(cx + r * np.cos(t), cy + y, cz + r * np.sin(t)) for t in th]
    verts.append((cx, cy + height, cz))
    top = len(verts)  # 1-based index of the top pole

    def vid(ring, j):  # 1-based; ring 0 is the first ring
        return 2 + ring * segs + (j % segs)

    faces = []
    for j in range(segs):
        faces.append((1, vid(0, j), vid(0, j + 1)))
        for k in range(steps - 2):
            faces.append((vid(k, j), vid(k + 1, j), vid(k + 1, j + 1)))
            faces.append((vid(k, j), vid(k + 1, j + 1), vid(k, j + 1)))
        faces.append((vid(steps - 2, j), top, vid(steps - 2, j + 1)))
    faces = [f for f in faces if len(set(f)) == 3]
    with open(path, "w") as f:
        f.writelines(f"v {x:.4f} {y:.4f} {z:.4f}\n" for x, y, z in verts)
        f.writelines(f"f {a} {b} {c}\n" for a, b, c in faces)
    return len(faces)


def write_stand_in_models(directory, segs_steps=None):
    """Write the stand-in chess meshes into `directory`; `segs_steps`
    overrides (S, R) for every piece (smaller meshes for tests). Returns
    {file name: triangles}."""
    out = {}
    for name, (segs, steps, height, radius, center, shape) in STAND_INS.items():
        if segs_steps is not None:
            segs, steps = segs_steps
        out[name] = write_lathe_obj(
            Path(directory) / name, segs, steps, height, radius, center, shape
        )
    return out


def environment():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    check(not any(m.split(".")[0] in ("jax", "jaxlib", "mcpt_tpu") for m in sys.modules),
          "a jax or mcpt_tpu module is loaded")
    nvcc = subprocess.run([kbuild.nvcc(), "--version"], capture_output=True, text=True, check=True)
    try:
        import triton
        tri = triton.__version__
    except ImportError:
        tri = "absent"
    phase("env", f"card={card()!r} torch={torch.__version__} cuda={torch.version.cuda} "
                 f"nvcc={nvcc.stdout.strip().splitlines()[-1]!r} triton={tri} "
                 f"gpus={torch.cuda.device_count()}")


def build():
    """The five CUDA sources, one nvcc each, started together; each
    wavefront source's ptxas lines (registers, stack, spill bytes) and
    build seconds."""
    t0 = time.monotonic()

    def timed(fn):
        t = time.monotonic()
        out = fn()
        return out, time.monotonic() - t

    def ptxas(source):
        return lambda: kbuild.build(source, True, summary=lambda log: [
            f"[ptxas] {source.name} {line}" for line in kbuild.ptxas_lines(log)])

    builds = (lambda: mk.build(True, regen=True), lambda: mk.build(True, regen=False),
              lambda: ip.build(True), ptxas(wf.SOURCE), ptxas(wf.BWD_SOURCE))
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        done = list(pool.map(lambda b: timed(b), builds))
    paths = [p for p, _ in done]
    for load in (lambda: mk.load_library(True), lambda: mk.load_library(False),
                 ip.load_library, wf.load_library, lambda: wf.load_library(wf.BWD_SOURCE)):
        load()
    dt = time.monotonic() - t0
    phase("build", f"{dt:.1f} s -> {[str(p.relative_to(ROOT)) for p in paths]}; "
                   + ", ".join(f"{p.stem[3:]} {t:.1f} s" for p, t in done))
    return dt


def cuda_ms(fn, reps, windows=1):
    """Device milliseconds of fn(): the mean over reps runs between two CUDA
    events, the median of `windows` such windows. Each window is queued
    behind a spin of the device (SPIN_CYCLES a run) that outlasts the
    host's issue of its runs, so a kernel shorter than its launch's host
    work still runs back to back with the next: the window times the
    device, not the host."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(windows):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES * reps)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def bound(tables, ops, n_lanes):
    """(bound_ms, bound_by): the larger of the tallied float32 operations
    over the card's float32 peak and of the bytes (every table read once,
    8 bytes per lane written) over its memory rate."""
    flops = sum(OPS_PER[k] * v for k, v in ops.items())
    nbytes = sum(b.numel() * b.element_size() for b in tables.buffers()) + 8 * n_lanes
    return roofline(flops, nbytes)


def roofline(flops, nbytes, iops=0):
    """(bound_ms, bound_by): the largest of float32 operations over the
    card's float32 peak, of 32-bit integer operations over its integer peak
    and of bytes over its memory rate ("operations" for either op term)."""
    t_ops = max(flops / PEAK_F32, iops / PEAK_I32) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def agree(label, r, ry, r2, ry2, every_lane=False):
    """phase 3's bounds; `every_lane` asks per-lane ray counts equal on all
    lanes."""
    check(bool(torch.isfinite(r).all()), f"{label}: non-finite radiance")
    tot, tot2 = ry.double().sum().item(), ry2.double().sum().item()
    lane_eq = (ry == ry2).float().mean().item()
    diff = (r - r2).abs()
    off = (diff > 1e-3).float().mean().item()
    dmean = abs(r.double().mean().item() - r2.double().mean().item())
    msg = (f"rays {tot:.0f} vs {tot2:.0f}, lanes equal {lane_eq:.6f}, radiance "
           f"off>1e-3 {off:.6f}, mean diff {dmean:.3e}, bitwise-equal lanes "
           f"{(r == r2).float().mean().item():.4f}, max abs err {diff.max().item():.4g}")
    check(abs(tot - tot2) <= 0.005 * tot2, f"{label}: total rays: {msg}")
    check(lane_eq == 1.0 if every_lane else lane_eq >= 0.98, f"{label}: per-lane rays: {msg}")
    check(off < 0.02 and dmean < 5e-3, f"{label}: radiance: {msg}")
    return msg, diff.max().item()


def kernel_vs_plain(tables, camera, spp, mb, seed, label, every_lane=False, lane_offset=0,
                    n_lanes=None, regen=True):
    """The kernel (the regen kernel, or with regen=False the lockstep
    kernel) and its plain version on the same CUDA tables, over lanes
    [lane_offset, lane_offset + n_lanes) (default: the whole image):
    agreement, kernel ms (mean of 10), plain ms (one run, which also
    tallies the work for the bound)."""
    cs = cam_static(camera)
    n = camera.width * camera.height * 3 if n_lanes is None else n_lanes

    def kern():
        return mk.trace_block(tables, cs, seed, lane_offset, spp, n, mb, regen=regen)

    kern()  # warm
    torch.cuda.synchronize()
    ops = collections.Counter()
    plain = trace_block_ref if regen else trace_block_lockstep_ref
    t0 = time.monotonic()
    r2, ry2 = plain(tables, cs, seed, lane_offset, spp, n, mb, ops=ops)
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t0) * 1e3
    ms = cuda_ms(kern, 10)
    r, ry = kern()
    torch.cuda.synchronize()
    msg, err = agree(label, r, ry, r2, ry2, every_lane)
    check(torch.equal(ry, ry2) and torch.equal(r, r2),
          f"{label}: not bitwise equal to the plain version on every lane: {msg}")
    bound_ms, bound_by = bound(tables, ops, n)
    info = mk.instance_info(tables, cs, mb, regen=regen)
    phase("kernel", f"{label} {mk.trace_block.last_instance}: {camera.width}x{camera.height} "
                    f"lanes {lane_offset}+{n} spp {spp} mb {mb}: kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.1f} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by}; {dict(ops)}); bitwise equal on every lane; "
                    f"{msg}; {info['registers']} registers, {info['blocks_per_sm']} blocks of "
                    f"{info['threads']} per SM")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": bound_ms,
            "bound_by": bound_by, "info": info}


def launch_count():
    return mk.trace_block.launches + ip.intersect_prims_c.launches


def device_profile(label, fn, kernel="mega_regen", attempts=3, count=launch_count):
    """Run fn() twice under torch.profiler, recording the second run (the
    first lets the tracer start), and print its wall time, the device time
    of each kernel and copy, and the device's idle share. The tracer can
    still miss the launches of a recorded run's first few hundred
    milliseconds: when it shows fewer `kernel` launches (names holding
    `kernel`, or any of a tuple of names) than the run made (`count()`
    before and after), the profile is taken again, up to `attempts` times,
    and an incomplete one prints no idle share. Returns the wall and busy
    ms, the idle share (None when incomplete) and the device events."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, attempts + 1):
        events = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: events.extend(p.events())) as prof:
            for _ in range(2):
                torch.cuda.synchronize()
                made = count()
                t0 = time.monotonic()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.monotonic() - t0) * 1e3
                made = count() - made
                prof.step()
        busy = collections.Counter()  # device events run one at a time on one stream
        launches, by_instance, n_events = [], collections.defaultdict(list), 0
        for e in events:  # the step's own device-side range is no device work
            if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"):
                ms = (e.time_range.end - e.time_range.start) / 1e3
                name = e.name.replace("(anonymous namespace)::", "")
                busy[name] += ms
                n_events += 1
                if any(k in e.name for k in names):
                    launches.append(round(ms, 3))
                    by_instance[name.split("(")[0].removeprefix("void ")].append(ms)
        if len(launches) >= made:
            break
    total = sum(busy.values())
    shown = launches if len(launches) <= 8 else (
        f"{len(launches)} launches, {sum(launches):.2f} ms in all, longest {max(launches)}")
    complete = len(launches) >= made
    idle = (f"idle share {1 - total / wall_ms:.4f}" if complete else
            f"idle share not measured (the profiler saw {len(launches)} of {made} launches)")
    phase("profile", f"{label} (attempt {attempt}): wall {wall_ms:.1f} ms, device busy "
                     f"{total:.1f} ms, {idle}; {'/'.join(names)} launches {shown} ms; "
                     f"{n_events} device events; "
                     + "; ".join(f"{k[:45]} {v:.2f} ms" for k, v in busy.most_common(4)))
    phase("profile", f"{label}: device ms a launch by instance: " + "; ".join(
        f"{k} {len(v)} launches, mean {statistics.mean(v):.4f}"
        for k, v in sorted(by_instance.items())))
    return {"wall_ms": wall_ms, "busy_ms": total, "events": n_events,
            "idle": 1 - total / wall_ms if complete else None}


def ms_per_launch(fn):
    """Device milliseconds per kernel launch of fn(): CUDA events around one
    run, over the launches it made (the render's copies and small kernels
    add well under 1%)."""
    made = launch_count()
    ms = cuda_ms(fn, 1)
    return ms / (launch_count() - made)


def golden(img):
    ours = tonemap(img)[:, :, :3].astype(np.float32).reshape(96, 4, 96, 4, 3).mean(axis=(1, 3))
    ref_img = read_png(REFERENCE)[:, :, :3].astype(np.float32)
    ref_img = ref_img.reshape(96, 4, 96, 4, 3).mean(axis=(1, 3))
    d_mean = ours.reshape(-1, 3).mean(0) - ref_img.reshape(-1, 3).mean(0)
    corr = float(np.corrcoef(ref_img.ravel(), ours.ravel())[0, 1])
    quad = np.abs(ours.reshape(2, 48, 2, 48, 3).mean(axis=(1, 3))
                  - ref_img.reshape(2, 48, 2, 48, 3).mean(axis=(1, 3))).max()
    tile = np.abs(ours.reshape(12, 8, 12, 8, 3).mean(axis=(1, 3))
                  - ref_img.reshape(12, 8, 12, 8, 3).mean(axis=(1, 3))).max()
    return d_mean, corr, float(quad), float(tile)


def reset_counts():
    mk.trace_block.launches = 0
    mk.trace_block.by_instance = collections.Counter()
    ip.intersect_prims_c.launches = 0
    ip.intersect_prims_c.by_mode = collections.Counter()
    ip.intersect_prims_c.rays_by_mode = collections.Counter()
    wf.reset_counts()


def main_path(pack):
    sc = demo_scene()
    reset_counts()
    img, stats = render_mega(pack, sc.camera, 256, seed=0, max_bounces=8, device="cuda")
    launches = dict(mk.trace_block.by_instance)
    check(launches.get("mega_regen<4, false, false>", 0) > 0, "the main path launched no kernel")
    check(img.shape == (384, 384, 3) and bool(np.isfinite(img).all()), "image shape/finite")
    d_mean, corr, quad, tile = golden(img)
    phase("main", f"384x384 spp 256 mb 8: {stats['elapsed_s']:.3f} s, {stats['rays']} rays, "
                  f"{stats['rays_per_s']:.4e} rays/s, launches {launches}; vs reference: "
                  f"channel mean diff {np.round(d_mean, 3).tolist()} (|.|<6.5), corr {corr:.4f} "
                  f"(>0.9), quadrant {quad:.3f} (<6.5), tile {tile:.3f} (<24)")
    check(np.abs(d_mean).max() < 6.5 and corr > 0.9 and quad < 6.5 and tile < 24.0,
          "384x384 image outside tests/test_golden.py bounds")
    # tests/test_golden.py's own configuration: a 96x96, spp 48, mb 8 render
    cam = dataclasses.replace(sc.camera, width=96, height=96)
    small, _ = render_mega(pack, cam, 48, seed=0, max_bounces=8, device="cuda")
    check(small.shape == (96, 96, 3) and bool(np.isfinite(small).all()), "96x96 image")
    # each 96x96 pixel stands for its 4x4 block: tonemapped once, like test_golden
    d_mean, corr, quad, tile = golden(np.repeat(np.repeat(small, 4, 0), 4, 1))
    gap_err = np.abs(d_mean - np.asarray(JAX_MEGA_GAP_96)).max()
    phase("main", f"96x96 spp 48 mb 8 (test_golden's configuration): channel mean diff "
                  f"{np.round(d_mean, 3).tolist()} (JAX megakernel {list(JAX_MEGA_GAP_96)}, "
                  f"off by {gap_err:.3f} < 0.25), corr {corr:.4f} (>0.9), quadrant "
                  f"{quad:.3f} (<6.5), tile {tile:.3f} (<24)")
    check(gap_err < 0.25 and corr > 0.9 and quad < 6.5 and tile < 24.0,
          "96x96 image outside the reference bounds")
    per_launch = ms_per_launch(lambda: render_mega(
        pack, sc.camera, 256, seed=1, max_bounces=8, device="cuda"))
    return launches["mega_regen<4, false, false>"], img, per_launch


def throughput(tables, regen=True, earlier=("nested loops", EARLIER_DEMO_RATE)):
    """The 1080p DEMO at spp 64, mb 8 through the regen kernel (or the
    lockstep kernel): three renders, their median rays/s, one more render
    under torch.profiler. Returns the median."""
    cam = dataclasses.replace(demo_scene().camera, width=1920, height=1080)
    label = "phase 5" if regen else "(h3) lockstep"
    rates = []
    for rep in range(3):
        _, stats = render_mega(tables, cam, 64, seed=1 + rep, max_bounces=8, device="cuda",
                               regen=regen)
        rates.append(stats["rays_per_s"])
        phase("perf", f"{label} 1080p spp 64 mb 8 render {rep + 1}/3: "
                      f"{stats['elapsed_s']:.4f} s, {stats['rays']} rays, "
                      f"{stats['rays_per_s']:.4e} rays/s")
    device_profile(f"{label} 1080p DEMO spp 64 mb 8", lambda: render_mega(
        tables, cam, 64, seed=4, max_bounces=8, device="cuda", regen=regen),
        kernel="mega_regen" if regen else "mega_lockstep")
    med = sorted(rates)[1]
    phase("perf", f"{label} median {med:.4e} rays/s ({earlier[0]}: {earlier[1]:.4e}), "
                  f"vs_baseline {med / BASELINE_RAYS_PER_S:.2f} (baseline "
                  f"{BASELINE_RAYS_PER_S:.3g}) on {card()}")
    return med


def cornell_x4(sky=True):
    """tests/test_megakernel.py:207-279's x4-scaled Cornell box (no small
    sphere), 48x48, under assets/sky.png unless `sky` is False."""
    k = 4.0
    mats = standard_materials()
    camera = Camera(width=48, height=48, fov=40.0, position=(278.0 * k, 273.0 * k, -800.0 * k),
                    target=(278.0 * k, 273.0 * k, 0.0), up=(0.0, 1.0, 0.0))
    sc = Scene(camera)
    for quads, m, name in [
        (CORNELL_FLOOR, mats["rough_white_conductor"], "back"),
        (CORNELL_SHORTBOX, mats["green_mirror"], "shortbox"),
        (CORNELL_TALLBOX, mats["rough_plastic"], "tallbox"),
        (CORNELL_LEFT, mats["rough_red_conductor"], "left"),
        (CORNELL_RIGHT, mats["gold_conductor"], "right"),
        (CORNELL_LIGHT, make_light_material(3.9), "light"),
    ]:
        sc.add(_mesh(np.asarray(quads) * k, m, name))
    sc.add(Sphere((400.0 * k, 90.0 * k, 3.0 * k), 80.0 * k, mats["smooth_glass"], "big"))
    sc.add(Sphere((250.0 * k, 260.0 * k, 230.0 * k), 60.0 * k, mats["clear_rough_plastic"], "mid"))
    if sky:
        sc.load_env_map(SKY)
    return sc


def chain_pack(levels, sphere_leaves=False, sky=False, interior_first=False):
    """The x4 box's pack (under the sky if `sky`) with its flat BVH replaced
    by a chain of `levels` levels, k = levels - 1 interior nodes in DFS
    preorder with their miss links. By default interior node j has a leaf
    as child 0 and interior node j + 1 as child 1 (interior nodes at even,
    leaves at odd indices, the last leaf last): the near-first walks, which
    take child 0 on equal entry t, push the interior child, test the leaf
    and pop, so their stack never holds more than one entry. With
    `interior_first` child 0 is interior node j + 1 and child 1 the leaf
    (interior nodes 0 .. k - 1, then the last one's two leaves, then the
    leaves of k - 2 down to 0): the walks push one leaf a level and their
    stack reaches k entries. The triangles are spread over the leaves in
    DFS order, or with `sphere_leaves` over every other leaf, whose others
    hold a sphere only (an empty child, which no walk enters or pushes); a
    leaf left without a triangle where there are more leaves than
    triangles takes one again (a repeat has its row, so the tie rule keeps
    the first hit), so that both forms hold the same leaves. The last leaf
    also holds every sphere, as the box's own tree holds them in its
    leaves: the kernels' walks test spheres apart, but the `bvh` method
    finds them through the leaves. Every box is the scene's, so every walk
    is exact and a nearest walk visits every row and leaf."""
    pack = cornell_x4(sky=sky).compile(cluster_threshold=8)
    prims = np.asarray(pack.bvh_prims)
    tris = np.sort(prims[(prims >= 0) & (prims < pack.t_pad)])
    k = levels - 1  # interior nodes; k + 1 leaves
    slots = range(0, k + 1, 2 if sphere_leaves else 1)
    groups = [np.array([pack.t_pad])] * (k + 1)
    for j, g in zip(slots, np.array_split(tris, len(slots))):
        groups[j] = g if g.size else tris[[j % tris.size]]
    groups[k] = np.union1d(groups[k], prims[prims >= pack.t_pad])  # the spheres
    n = 2 * k + 1
    ix = np.arange(n)
    if interior_first:
        leaf_ix = list(range(k, n))
        # interior j > 0 ends where the leaf of j - 1 (at 2k - j + 1) starts;
        # leaf i is followed by leaf i + 1; the root and the last leaf end the walk
        miss = np.where(ix < k, 2 * k - ix + 1, ix + 1)
        miss[0] = miss[n - 1] = -1
    else:
        leaf_ix = [2 * j + 1 for j in range(k)] + [2 * k]
        miss = np.where(ix % 2 == 1, ix + 1, -1)
    start = np.full(n, -1, np.int32)
    count = np.zeros(n, np.int32)
    start[leaf_ix] = np.cumsum([0] + [g.size for g in groups[:-1]])
    count[leaf_ix] = [g.size for g in groups]
    lo = np.minimum(np.asarray(pack.bvh_min).min(0), np.asarray(pack.bvh_max).min(0))
    hi = np.maximum(np.asarray(pack.bvh_min).max(0), np.asarray(pack.bvh_max).max(0))
    return dataclasses.replace(
        pack, bvh_min=np.tile(lo, (n, 1)).astype(np.float32),
        bvh_max=np.tile(hi, (n, 1)).astype(np.float32), bvh_miss=miss.astype(np.int32),
        bvh_leaf_start=start, bvh_leaf_count=count,
        bvh_prims=np.concatenate(groups).astype(np.int32),
    )


# (d-deep): the deep megakernels' timed launch, the first block of a 1080p
# render of the x4 box, and the plain version's stride in it
DEEP_LANES = 2**20
DEEP_STRIDE = 256
# (d-deep): the every-lane checks of each deep instance on each tree (width,
# height, spp, mb): two samples a lane, so that a lane's walks reuse its
# stack. On the 33- to 128-level trees at 64x48 and 6 bounces the phase
# took 745 s, 660 s of it plain versions, and the script passed its 1,200;
# at this size the phase took 372 s and the script 850 (PERF.md)
DEEP_CHECK = (32, 24, 2, 3)


def deep_rays(device):
    """K3's rays of (d-deep) and of `mega_ab.py --shapes deep`: 196,608 (3
    tiles of pixels) from seed 13, origins in the x4 box's bounds and
    directions uniform on the sphere, as (x, y, z) planes of origins and of
    directions."""
    gen = torch.Generator(device=device).manual_seed(13)
    lo = torch.tensor([0.0, 0.0, -800.0], device=device)
    hi = torch.tensor([2224.0, 2195.2, 2236.8], device=device)
    o = lo + (hi - lo) * torch.rand((3 * TILE_PX, 3), generator=gen, device=device)
    d = torch.nn.functional.normalize(
        torch.randn((3 * TILE_PX, 3), generator=gen, device=device), dim=1)
    return tuple(tuple(x[:, k].contiguous() for k in range(3)) for x in (o, d))


def deep_trees():
    """(d-deep): trees deeper than the walks' local stack, whose walks keep
    their stack in device memory (the megakernels' deep instances) or its
    top DEEP_TIER entries in shared memory and the rest in device memory
    (K3's, csrc/deep_stack.cuh). The chain of BVH_STACK + 1 levels
    and the interior-first chain of 48, 64 and 128 levels (`chain_pack`; its
    walks' stack reaches levels - 1 entries), each without and with the
    sky: the deep megakernel instances (regen and lockstep, S = 4 and the
    generic light-count instance at 7 samples; the env instances under the
    sky) against their plain versions bitwise at DEEP_CHECK (32x24, spp 2,
    mb 3), and
    against the same box on its own shallow tree and, the interior-first
    chains, on the chain of as many levels (ray counts and radiance equal
    on every lane: every walk is exact); K3's deep walk on each tree,
    nearest and occlusion, on 196,608 rays through the box, bitwise against
    its plain version, the box's own tree's walk and the chain's. Then
    what the stack costs: on the 64-level
    chain and interior-first chain, which hold the same leaves,
    `mega_regen_deep<4, false>` and `mega_lockstep_deep<4>` timed at a
    launch that fills the card (DEEP_LANES lanes of the 1080p box, spp 1,
    mb 8), bitwise against the plain version on every DEEP_STRIDE-th lane,
    whose tally (scaled) gives the bound, printed with the stack's device
    bytes; K3's deep walk, nearest and occlusion, on those rays, timed,
    with the entries its stack moves to device memory and back (`spill`,
    `fill`) and its device bytes. Then
    each deep instance's main path (`render_mega` of the 64-level
    interior-first chain, and the wavefront's `render_radiance` with method
    auto, which must take the deep walk). Returns {row name: (launches,
    measurements)} for the kernels line: the megakernels' S = 4 rows from
    the full launch on the interior-first chain."""
    t0 = time.monotonic()
    sc = cornell_x4(sky=False)
    cam = dataclasses.replace(sc.camera, width=DEEP_CHECK[0], height=DEEP_CHECK[1])
    cs = cam_static(cam)
    n = cam.width * cam.height * 3
    spp, mb = DEEP_CHECK[2:]
    shallow = {sky: SceneTables.from_pack(cornell_x4(sky=sky).compile(cluster_threshold=8),
                                          device=DEV) for sky in (False, True)}
    at = {}
    # K3's rays: 196,608 through the box, for the trees' checks and the timed walks
    oc, dc = deep_rays(DEV)

    def k3(pack, occ):
        return ip.intersect_prims_c(pack.tri_sc, pack.sph_geom, pack.n_tris, oc, dc,
                                    occlusion=occ, walk=pack.walk)

    own_walk = pack_to(cornell_x4(sky=False).compile(cluster_threshold=8), DEV, walk=True)
    k3_own = {occ: k3(own_walk, occ) for occ in (False, True)}
    for form, levels in (("chain", BVH_STACK + 1), ("interior-first", 48),
                         ("interior-first", 64), ("interior-first", 128)):
        inner = form == "interior-first"
        # the env instances under the sky: the regenerating kernel only (the
        # lockstep kernel takes no env map)
        for sky in (False, True):
            deep = SceneTables.from_pack(chain_pack(levels, sky=sky, interior_first=inner),
                                         device=DEV)
            chain = (SceneTables.from_pack(chain_pack(levels, sky=sky), device=DEV) if inner
                     else None)
            own = shallow[sky]
            check(deep.bvh_depth == levels and deep.use_env == sky and mk.deep(deep)
                  and not mk.deep(own),
                  f"(d-deep) {form} of {levels} levels: depth {deep.bvh_depth}")
            label = f"(d-deep) {form} {levels}{' sky' if sky else ''}"
            for regen in (True, False) if not sky else (True,):
                for n_dir in (FAN, 7):
                    for t in (deep, own, chain):
                        if t is not None:
                            t.n_dir_sample = n_dir
                    m = kernel_vs_plain(deep, cam, spp, mb, 11, label, every_lane=True,
                                        regen=regen)
                    inst = mk.trace_block.last_instance
                    check("_deep<" in inst, f"(d-deep) launched {inst}")
                    r, ry = mk.trace_block(deep, cs, 11, 0, spp, n, mb, regen=regen)
                    for name, t in (("the box's own tree", own),
                                    (f"the chain of {levels} levels", chain)):
                        if t is None:
                            continue
                        r2, ry2 = mk.trace_block(t, cs, 11, 0, spp, n, mb, regen=regen)
                        check(torch.equal(ry, ry2) and torch.equal(r, r2),
                              f"{label}: {inst} differs from {mk.trace_block.last_instance} "
                              f"on {name}")
                    phase("d-deep", f"{inst}, {form} of {levels} levels: ray counts and "
                                    f"radiance equal on every lane to the box's own "
                                    f"{own.bvh_depth}-level tree"
                                    f"{' and to the chain' if inner else ''}")
                    at[inst] = m
        # K3's deep walk on the same tree: its plain version, the chain's and
        # the box's own tree's answers on every ray
        pack = pack_to(chain_pack(levels, interior_first=inner), DEV, walk=True)
        chain = pack_to(chain_pack(levels), DEV, walk=True) if inner else None
        for occ in (False, True):
            mode = ("occlusion" if occ else "nearest") + " deep walk"
            got = k3(pack, occ)
            check(ip.intersect_prims_c.last_mode == mode,
                  f"(d-deep) the intersector reported {ip.intersect_prims_c.last_mode!r}")
            want = intersect_walk_ref(pack.walk.bvh, pack.walk.leaf, pack.sph_geom, pack.n_tris,
                                      oc, dc, occlusion=occ, depth=pack.walk.depth)
            label = f"(d-deep) K3 {mode}, {form} of {levels} levels"
            bitwise(label, got, want, "the plain deep walk")
            bitwise(label, got, k3_own[occ], "the box's own tree's walk")
            if chain is not None:
                bitwise(label, got, k3(chain, occ), "the chain's deep walk")
            phase("d-deep", f"intersect_walk_deep<{str(occ).lower()}>, {form} of {levels} "
                            f"levels, {oc[0].numel()} rays: bitwise equal on every ray to its "
                            f"plain version, the box's own {own_walk.walk.depth}-level tree"
                            f"{' and the chain' if inner else ''}")
    # what the stack costs: the same leaves with the stack at 1 entry
    # (the chain) and at 63 (the interior-first chain), at a full launch
    big = cam_static(dataclasses.replace(sc.camera, width=1920, height=1080))
    sub = DEEP_LANES // DEEP_STRIDE
    cost = {}
    for regen in (True, False):
        for form in ("chain", "interior-first"):
            tables = SceneTables.from_pack(chain_pack(64, interior_first=form != "chain"),
                                           device=DEV)

            def kern(tables=tables, regen=regen):
                return mk.trace_block(tables, big, 7, 0, 1, DEEP_LANES, 8, regen=regen)

            r, ry = kern()
            inst = mk.trace_block.last_instance
            ops = collections.Counter()
            plain = trace_block_ref if regen else trace_block_lockstep_ref
            t1 = time.monotonic()
            r2, ry2 = plain(tables, big, 7, 0, 1, sub, 8, ops=ops, lane_stride=DEEP_STRIDE)
            torch.cuda.synchronize()
            plain_ms = (time.monotonic() - t1) * 1e3
            check(torch.equal(ry[::DEEP_STRIDE], ry2) and torch.equal(r[::DEEP_STRIDE], r2),
                  f"(d-deep) {inst} on the {form} at {DEEP_LANES} lanes: not bitwise equal to "
                  f"the plain version on every {DEEP_STRIDE}th lane")
            stack = ops.pop("stack", 0)
            scaled = collections.Counter({k: v * DEEP_STRIDE for k, v in ops.items()})
            bound_ms, bound_by = bound(tables, scaled, DEEP_LANES)
            ms = cuda_ms(kern, 3, windows=3)
            cost[regen, form] = ms
            info = mk.instance_info(tables, big, 8, regen=regen)
            area = mk.walk_stack(tables, DEEP_LANES)
            phase("kernel", f"(d-deep) {inst}, {form} of 64 levels, {DEEP_LANES} lanes of the "
                            f"1920x1080 box, spp 1, mb 8: kernel {ms:.3f} ms, bound "
                            f"{bound_ms:.4f} ms ({bound_by}; the plain tally of every "
                            f"{DEEP_STRIDE}th lane x {DEEP_STRIDE}: {dict(scaled)}), share "
                            f"{bound_ms / ms:.4f}; plain {plain_ms:.1f} ms on those {sub} lanes, "
                            f"bitwise equal there, its stack high-water mark {stack}; "
                            f"{info['registers']} registers, {info['blocks_per_sm']} blocks of "
                            f"{info['threads']} per SM")
            phase("d-deep", f"{inst}, {form} of 64 levels: its stack, every entry in device "
                            f"memory, {area.numel() * 4} bytes for {DEEP_LANES} lanes "
                            f"({area.numel() * 4 / DEEP_LANES:.0f} a lane), high-water mark "
                            f"{stack}, in {ms:.3f} ms")
            if form != "chain":
                at[inst] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": 0.0,
                            "bound_ms": bound_ms, "bound_by": bound_by}
        phase("d-deep", f"{'mega_regen_deep' if regen else 'mega_lockstep_deep'}<4>: the "
                        f"interior-first chain against the chain, 64 levels, {DEEP_LANES} "
                        f"lanes: {cost[regen, 'interior-first']:.3f} ms against "
                        f"{cost[regen, 'chain']:.3f} ms, the stack's pushes and pops "
                        f"{cost[regen, 'interior-first'] - cost[regen, 'chain']:+.3f} ms")
    # K3's deep walk on the 196,608 rays
    answers = {}
    for form in ("chain", "interior-first"):
        pack = pack_to(chain_pack(64, interior_first=form != "chain"), DEV, walk=True)
        for occ in (False, True):
            mode = ("occlusion" if occ else "nearest") + " deep walk"

            def kernel(pack=pack, occ=occ):
                return ip.intersect_prims_c(pack.tri_sc, pack.sph_geom, pack.n_tris, oc, dc,
                                            occlusion=occ, walk=pack.walk)

            kernel()
            check(ip.intersect_prims_c.last_mode == mode,
                  f"(d-deep) the intersector reported {ip.intersect_prims_c.last_mode!r}")
            ms = cuda_ms(kernel, 10, windows=5)
            got = kernel()
            ops = collections.Counter()
            t1 = time.monotonic()
            want = intersect_walk_ref(pack.walk.bvh, pack.walk.leaf, pack.sph_geom, pack.n_tris,
                                      oc, dc, occlusion=occ, ops=ops, depth=pack.walk.depth)
            torch.cuda.synchronize()
            plain_ms = (time.monotonic() - t1) * 1e3
            err = bitwise(f"(d-deep) K3 {mode}, {form}", got, want, "the plain deep walk")
            answers.setdefault(occ, got)
            bitwise(f"(d-deep) K3 {mode}, {form}", got, answers[occ], "the chain's answers")
            stack = ops.pop("stack", 0)
            tables = table_bytes(pack.walk.bvh, pack.walk.leaf, pack.sph_geom)
            bound_ms, bound_by = roofline(sum(OPS_PER[k] * v for k, v in ops.items()),
                                          oc[0].numel() * (24 + (4 if occ else 16)) + tables)
            area = 12 * spill_entries(pack.walk.depth) * oc[0].numel()
            phase("kernel", f"(d-deep) K3 [{mode}], {form} of {pack.walk.depth} levels, "
                            f"{oc[0].numel()} rays: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
                            f"bound {bound_ms:.5f} ms ({bound_by}; {dict(ops)}), share "
                            f"{bound_ms / ms:.4f}, stack high-water mark {stack}; bitwise equal "
                            f"on every ray to the plain version and the chain's answers; the "
                            f"two-tier stack moved {ops['spill']} entries out and {ops['fill']} "
                            f"back, its device tier {area} bytes (every level: "
                            f"{12 * pack.walk.depth * oc[0].numel()})")
            cost[occ, form] = ms
            if form != "chain":
                at[f"intersect_prims<{mode}>"] = {"ms": ms, "plain_ms": plain_ms,
                                                  "max_abs_err": err, "bound_ms": bound_ms,
                                                  "bound_by": bound_by}
        if form != "chain":
            phase("d-deep", "K3's deep walk, the interior-first chain against the chain, 64 "
                            "levels: " + ", ".join(
                                f"{'occlusion' if occ else 'nearest'} "
                                f"{cost[occ, form]:.4f} against {cost[occ, 'chain']:.4f} ms"
                                for occ in (False, True)))
    # the main paths
    host = {sky: chain_pack(64, sky=sky, interior_first=True) for sky in (False, True)}
    launches = collections.Counter()
    for regen, n_dir, sky in ((True, FAN, False), (True, 7, False), (False, FAN, False),
                              (False, 7, False), (True, FAN, True), (True, 7, True)):
        reset_counts()
        tables = SceneTables.from_pack(host[sky], device=DEV)
        tables.n_dir_sample = n_dir
        img, st = render_mega(tables, sc.camera, 4, seed=2, max_bounces=8, device=DEV,
                              regen=regen)
        launches.update(mk.trace_block.by_instance)
        check(np.isfinite(img).all() and img.mean() > 0, "(d-deep) render_mega image")
        phase("d-deep", f"render_mega of the 64-level interior-first chain, 48x48 spp 4 mb 8, "
                        f"n_dir {n_dir}, regen {regen}, sky {sky}: launches "
                        f"{dict(mk.trace_block.by_instance)}, {st['rays']} rays, image mean "
                        f"{img.mean():.4f}")
    reset_counts()
    img, _ = render_radiance(host[False], dataclasses.replace(sc.camera, width=128, height=128),
                             1, 2,
                             max_bounces=8, method="auto", device=DEV)
    by_mode = dict(ip.intersect_prims_c.by_mode)
    check(set(by_mode) == {"nearest deep walk", "occlusion deep walk"},
          f"(d-deep) the wavefront's auto took {by_mode}")
    launches.update(by_mode)
    phase("d-deep", f"render_radiance (method auto) of the 64-level interior-first chain, "
                    f"128x128 spp 1 mb 8: intersector launches {by_mode}, image mean "
                    f"{img.mean():.4f}; {time.monotonic() - t0:.1f} s")
    rows = {k: (launches.get(k.removeprefix("intersect_prims<").removesuffix(">"),
                             launches.get(k, 0)), m) for k, m in at.items()}
    check(all(n > 0 for n, _ in rows.values()),
          f"(d-deep) a deep instance took no launch in its main path: {rows}")
    return rows


def env_and_bvh_vs_plain():
    """(a): the env instance on the sky-lit DEMO, the BVH+env instance on
    the sky-lit x4 Cornell box; then the env instance's main path. Returns
    the env instance's measurements and its launches in that render."""
    t0 = time.monotonic()
    demo = demo_scene()
    demo.load_env_map(SKY)
    env_tables = SceneTables.from_pack(demo.compile(), device="cuda")
    at_env = kernel_vs_plain(env_tables, dataclasses.replace(demo.camera, width=384, height=384),
                             2, 8, 3, "(a) DEMO+sky lanes", every_lane=True)
    sc = cornell_x4()
    tables = SceneTables.from_pack(sc.compile(cluster_threshold=8), device="cuda")
    check(tables.use_bvh and tables.use_env, "the x4 Cornell tables lack the BVH or the env map")
    kernel_vs_plain(tables, dataclasses.replace(sc.camera, width=64, height=48), 8, 6, 11,
                    "(a) x4 Cornell small", every_lane=True)
    kernel_vs_plain(tables, dataclasses.replace(sc.camera, width=384, height=384),
                    2, 8, 3, "(a) x4 Cornell lanes", every_lane=True)
    reset_counts()
    img, stats = render_mega(env_tables, demo.camera, 64, seed=0, max_bounces=8, device="cuda")
    launches = dict(mk.trace_block.by_instance)
    check(launches.get("mega_regen<4, true, false>", 0) > 0, "the sky-lit DEMO launched no kernel")
    check(img.shape == (384, 384, 3) and bool(np.isfinite(img).all()), "sky-lit DEMO image")
    check(0.0 < float(img.mean()) < 10.0, f"sky-lit DEMO image mean {img.mean()}")
    phase("a", f"sky-lit DEMO 384x384 spp 64 mb 8: {stats['elapsed_s']:.3f} s, {stats['rays']} "
               f"rays, {stats['rays_per_s']:.4e} rays/s, launches {launches}, image mean "
               f"{float(img.mean()):.4f}; {time.monotonic() - t0:.1f} s")
    per_launch = ms_per_launch(lambda: render_mega(
        env_tables, demo.camera, 64, seed=1, max_bounces=8, device="cuda"))
    return at_env, launches["mega_regen<4, true, false>"], per_launch


def bvh_vs_smem():
    """(b): the same DEMO through the BVH walk and through the shared-memory
    sweep."""
    t0 = time.monotonic()
    sc = demo_scene()
    cs = cam_static(sc.camera)
    n = 384 * 384 * 3
    smem = SceneTables.from_pack(sc.compile(), device="cuda")
    bvh = SceneTables.from_pack(sc.compile(cluster_threshold=8), device="cuda")
    check(bvh.use_bvh and not smem.use_bvh, "BVH flags")
    mk.trace_block(bvh, cs, 5, 0, 4, n, 8)  # warm
    ms_bvh = cuda_ms(lambda: mk.trace_block(bvh, cs, 5, 0, 4, n, 8), 5)
    ms_smem = cuda_ms(lambda: mk.trace_block(smem, cs, 5, 0, 4, n, 8), 5)
    r, ry = mk.trace_block(bvh, cs, 5, 0, 4, n, 8)
    r2, ry2 = mk.trace_block(smem, cs, 5, 0, 4, n, 8)
    torch.cuda.synchronize()
    msg, _ = agree("(b)", r, ry, r2, ry2, every_lane=True)
    phase("b", f"DEMO 384x384 spp 4 mb 8: BVH {ms_bvh:.3f} ms, shared-memory sweep "
               f"{ms_smem:.3f} ms; {msg}; {time.monotonic() - t0:.1f} s")


def conf_path(build_s):
    """(c): the --conf conf.json path at full width on stand-in meshes."""
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as models:
        counts = write_stand_in_models(models)
        t_write = time.monotonic() - t0
        t1 = time.monotonic()
        scene, opts = build_scene(load_config(ROOT / "conf.json"), models_dir=models)
        t_scene = time.monotonic() - t1
    check(scene.env_pixels is not None, "conf.json's assets/sky.png did not load")
    t1 = time.monotonic()
    pack = scene.compile()
    t_compile = time.monotonic() - t1
    n_tris = sum(m.positions.shape[0] for m in scene.meshes)
    check(n_tris == 38528, f"stand-in scene has {n_tris} triangles")
    t1 = time.monotonic()
    tables = SceneTables.from_pack(pack, device="cuda")
    torch.cuda.synchronize()
    t_upload = time.monotonic() - t1
    cam = scene.camera
    check(cam.use_dof and (cam.width, cam.height) == (1920, 1080), "conf.json camera")
    levels = bvh_depth(pack.bvh_miss, pack.bvh_leaf_start >= 0)
    phase("conf", f"stand-ins {counts} + floor 2 + light 2 = {n_tris} triangles; write "
                  f"{t_write:.2f} s, build_scene {t_scene:.2f} s, compile (BVH "
                  f"{pack.bvh_min.shape[0]} nodes, {levels} levels, {tables.bvh.shape[0]} "
                  f"child-pair rows) {t_compile:.2f} s, upload {t_upload:.2f} s, "
                  f"kernel build {build_s:.1f} s (phase 2); "
                  f"conf.json asks spp {opts['spp']}, rendered at {CONF_SPP}")
    at_conf = kernel_vs_plain(tables, cam, 1, 8, 2, "(c) conf block", every_lane=True,
                              lane_offset=CONF_BLOCK_OFFSET, n_lanes=384 * 384 * 3)
    reset_counts()
    t1 = time.monotonic()
    img, stats = render_mega(tables, cam, CONF_SPP, seed=0, max_bounces=8, device="cuda")
    wall = time.monotonic() - t1
    launches = dict(mk.trace_block.by_instance)
    check(launches.get("mega_regen<4, true, true>", 0) > 0, "the --conf path launched no kernel")
    check(img.shape == (1080, 1920, 3) and bool(np.isfinite(img).all()), "conf image")
    check(0.0 < float(img.mean()) < 10.0, f"conf image mean {img.mean()}")
    phase("conf", f"1920x1080 spp {CONF_SPP} mb 8 DoF sky: wall {wall:.3f} s, render "
                  f"{stats['elapsed_s']:.3f} s, {stats['rays']} rays, {stats['rays_per_s']:.4e} "
                  f"rays/s, launches {launches}, image mean {float(img.mean()):.4f}")
    device_profile(f"conf 1080p spp {CONF_SPP} mb 8", lambda: render_mega(
        tables, cam, CONF_SPP, seed=1, max_bounces=8, device="cuda"))
    per_launch = ms_per_launch(lambda: render_mega(
        tables, cam, CONF_SPP, seed=2, max_bounces=8, device="cuda"))
    phase("conf", f"{time.monotonic() - t0:.1f} s")
    return launches["mega_regen<4, true, true>"], at_conf, per_launch


def nee_batch(pack, camera, seed=0, shadow=3):
    """One wavefront tile's NEE-sized ray batch on the card: the camera rays
    of `camera`'s first TILE_PX pixels, three channel lanes each (B lanes),
    then `shadow` rays per lane from its first hit (offset as the integrator
    offsets it; the camera position where it missed) toward light samples:
    (1 + shadow)·B rays as component tuples (o, d)."""
    ids = torch.arange(TILE_PX, device=DEV)
    k1, k2 = prng.split(prng.key(seed, DEV))
    o, d = wf.camera_rays(camera, ids, k1)
    o3 = tuple(x.repeat_interleave(3) for x in o)
    d3 = tuple(x.repeat_interleave(3) for x in d)
    b = 3 * TILE_PX
    chan = torch.arange(3, device=DEV).repeat(TILE_PX)
    surf = surface_at_c(pack, o3, d3, intersect_dense(pack, torch.stack(o3, 1),
                                                       torch.stack(d3, 1)))
    p = surf.p
    off = torch.clamp_min(REL_EPS * torch.stack(p, 1).abs().amax(1), EPSILON)
    p = tuple((p[k] + surf.n[k] * off).repeat(shadow) for k in range(3))
    ls = sample_light_c(pack, prng.uniform(k2, (shadow * b, 4)), chan.repeat(shadow))
    delta = tuple(ls.p[k] - p[k] for k in range(3))
    dist = torch.sqrt(delta[0] * delta[0] + delta[1] * delta[1] + delta[2] * delta[2])
    ws = tuple(x / dist for x in delta)
    return (tuple(torch.cat([o3[k], p[k]]) for k in range(3)),
            tuple(torch.cat([d3[k], ws[k]]) for k in range(3)))


def intersect_vs_plain(label, kernel, plain, mode, n_rays, n_tris, n_sph, table_bytes, out_bytes,
                       fan=None):
    """`kernel()` (one launch of csrc/intersect_prims.cu) against `plain()`
    (its plain version on the same CUDA tensors): every output bitwise
    equal, the launch reported as `mode`; kernel ms (the median of 5 means
    of 10), plain ms (one run) and the bound: n_rays x (n_tris Woop tests + n_sph sphere
    tests) float32 operations, or 24 bytes in per ray, `out_bytes` out and
    the tables read once. With `fan`, n_rays / fan origins: the origin's
    terms of each test count once per origin, and its 12 bytes once."""
    kernel()
    torch.cuda.synchronize()
    check(ip.intersect_prims_c.last_mode == mode,
          f"{label}: the kernel reported {ip.intersect_prims_c.last_mode!r}, not {mode!r}")
    t0 = time.monotonic()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t0) * 1e3
    ms = cuda_ms(kernel, 10, windows=5)
    t0 = time.monotonic()
    for _ in range(10):
        kernel()
    torch.cuda.synchronize()
    issued_ms = (time.monotonic() - t0) * 1e2
    got = kernel()
    torch.cuda.synchronize()
    err = bitwise(label, got, want, "the plain version")
    flops = n_rays * (n_tris * OPS_PER["woop"] + n_sph * OPS_PER["sph"])
    nbytes = n_rays * (24 + out_bytes) + table_bytes
    if fan:
        shared = n_tris * OPS_PER["woop_origin"] + n_sph * OPS_PER["sph_origin"]
        flops -= (n_rays - n_rays // fan) * shared
        nbytes -= (n_rays - n_rays // fan) * 12
    bound_ms, bound_by = roofline(flops, nbytes)
    hits = (got[0] < T_MAX).float().mean().item()
    phase("kernel", f"{label} [{mode}]: {n_rays} rays x ({n_tris} triangles + {n_sph} spheres), "
                    f"hit share {hits:.4f}: kernel {ms:.4f} ms (issued back to back from the "
                    f"host: {issued_ms:.4f} ms a call), plain {plain_ms:.1f} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by}); bitwise equal on every ray, max abs err "
                    f"{err}")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": bound_ms,
            "bound_by": bound_by, "got": got, "want": want}


def bitwise(label, got, want, what):
    """Check every output of `got` bitwise equal to `want`'s (None where
    occlusion returns none; float32 compared as int32, so +0 and -0
    differ); the largest absolute difference (0.0)."""
    err = 0.0
    for name, g, w in zip(("t", "prim", "u", "v"), got, want):
        if w is None:
            check(g is None, f"{label}: {name} returned in occlusion mode")
            continue
        check(g.dtype == w.dtype and g.shape == w.shape, f"{label}: {name} dtype/shape")
        err = max(err, (g.double() - w.double()).abs().max().item())
        gi, wi = g.view(torch.int32), w.view(torch.int32)
        check(torch.equal(gi, wi), f"{label}: {name} differs from {what} on "
                                   f"{(gi != wi).sum().item()} of {g.numel()} rays")
    return err


def walk_vs_plain(label, pack, oc, dc, occ, swept):
    """The walk mode over `pack.walk` on the rays of `swept` (the tiled
    mode's result from `intersect_vs_plain`): bitwise equal on every ray to
    the all-pairs plain version and to the tiled kernel; kernel ms (the
    median of 9 means of 40: a launch is tens of microseconds); the bound from the plain walk's tally on every WALK_SUBSET-th ray,
    scaled to all (its answers there equal the kernel's bitwise too)."""
    mode = ("occlusion" if occ else "nearest") + " walk"
    walk = pack.walk
    sph = pack.sph_geom

    def kernel():
        return ip.intersect_prims_c(pack.tri_sc, sph, pack.n_tris, oc, dc, occlusion=occ,
                                    walk=walk)

    kernel()
    torch.cuda.synchronize()
    check(ip.intersect_prims_c.last_mode == mode,
          f"{label}: the kernel reported {ip.intersect_prims_c.last_mode!r}, not {mode!r}")
    ms = cuda_ms(kernel, 40, windows=9)
    got = kernel()
    torch.cuda.synchronize()
    err = bitwise(label, got, swept["want"], "the all-pairs plain version")
    bitwise(label, got, swept["got"], "the tiled mode")
    n = oc[0].numel()
    sub = torch.arange(0, n, WALK_SUBSET, device=DEV)
    ops = collections.Counter()
    t0 = time.monotonic()
    plain = intersect_walk_ref(walk.bvh, walk.leaf, sph, pack.n_tris, tuple(x[sub] for x in oc),
                               tuple(x[sub] for x in dc), occlusion=occ, ops=ops)
    torch.cuda.synchronize()
    walk_ms = (time.monotonic() - t0) * 1e3
    bitwise(label, [None if x is None else x[sub] for x in got], plain, "the plain walk")
    stack = ops.pop("stack", 0)  # a high-water mark, not a count
    per_ray = {k: v / sub.numel() for k, v in ops.items()}
    flops = n * sum(OPS_PER[k] * v for k, v in per_ray.items())
    tables = sum(x.numel() * x.element_size() for x in (walk.bvh, walk.leaf, sph))
    bound_ms, bound_by = roofline(flops, n * (24 + (4 if occ else 16)) + tables)
    phase("kernel", f"{label} [{mode}]: {n} rays, {walk.bvh.shape[0]} rows, "
                    f"{walk.leaf.shape[0]} leaf rows, {walk.depth} levels: kernel {ms:.4f} ms "
                    f"(tiled {swept['ms']:.4f} ms, {swept['ms'] / ms:.2f}x), bound "
                    f"{bound_ms:.5f} ms ({bound_by}; the sweep's own {swept['bound_ms']:.4f}), "
                    f"share {bound_ms / ms:.4f}; plain walk on {sub.numel()} rays {walk_ms:.1f} "
                    f"ms, per ray {({k: round(v, 4) for k, v in per_ray.items()})}, "
                    f"stack high-water mark {stack}; bitwise "
                    f"equal on every ray to the plain version and the tiled mode")
    return {"ms": ms, "plain_ms": swept["plain_ms"], "max_abs_err": err, "bound_ms": bound_ms,
            "bound_by": bound_by}


def prims_vs_plain(label, pack, oc, dc, tiled):
    """Nearest and occlusion modes of `intersect_prims_c` on `pack`'s bare
    tables (with `tiled`, then its walk modes on the same rays), and the
    dense method's ms on the same rays for reference."""
    tri, sph = pack.tri_sc, pack.sph_geom
    n = oc[0].numel()
    n_tris = int(pack.tri_valid.sum().item())
    n_sph = int((sph[:, 3] > 0).sum().item())
    table_bytes = (tri.numel() + sph.numel()) * 4
    out = {}
    for occ in (False, True):
        mode = ("occlusion" if occ else "nearest") + (" tiled" if tiled else "")
        out[mode] = intersect_vs_plain(
            label, lambda: ip.intersect_prims_c(tri, sph, pack.n_tris, oc, dc, occlusion=occ),
            lambda: intersect_prims_ref(tri, sph, pack.n_tris, oc, dc, occlusion=occ),
            mode, n, n_tris, n_sph, table_bytes, 4 if occ else 16)
        if tiled:
            out[mode.replace("tiled", "walk")] = walk_vs_plain(label, pack, oc, dc, occ, out[mode])
    o, d = torch.stack(oc, 1), torch.stack(dc, 1)
    dense_ms = cuda_ms(lambda: intersect_dense(pack, o, d), 3)
    phase("kernel", f"{label}: the dense method (torch.matmul) on the same rays {dense_ms:.3f} ms")
    return out


def fan_vs_plain(label, pack, camera, seed, tiled):
    """The occlusion sweep's fan form on the render's own shadow batch:
    `nee_batch`'s first hits (B = 3·TILE_PX origins) with FAN directions
    each, ray k·B + i from origin i, as `direct_lighting_c` sends them. The
    fan form and the generic occlusion mode on the origins expanded (the
    same rays), each against the plain version, and the two against each
    other, bitwise; both forms' times and bounds."""
    oc, dc = nee_batch(pack, camera, seed=seed, shadow=FAN)
    b = 3 * TILE_PX
    p, ws = tuple(x[b:2 * b] for x in oc), tuple(x[b:] for x in dc)
    px = fan_origins(p, FAN)
    tri, sph, base = pack.tri_sc, pack.sph_geom, pack.n_tris
    n_tris = int(pack.tri_valid.sum().item())
    n_sph = int((sph[:, 3] > 0).sum().item())
    table_bytes = (tri.numel() + sph.numel()) * 4
    form = " tiled" if tiled else ""
    fan = intersect_vs_plain(
        f"{label} fan batch", lambda: ip.intersect_prims_c(tri, sph, base, p, ws, occlusion=True,
                                                           fan=FAN),
        lambda: intersect_prims_ref(tri, sph, base, p, ws, occlusion=True, fan=FAN),
        "occlusion fan" + form, FAN * b, n_tris, n_sph, table_bytes, 4, fan=FAN)
    gen = intersect_vs_plain(
        f"{label} fan batch, origins expanded",
        lambda: ip.intersect_prims_c(tri, sph, base, px, ws, occlusion=True),
        lambda: intersect_prims_ref(tri, sph, base, px, ws, occlusion=True),
        "occlusion" + form, FAN * b, n_tris, n_sph, table_bytes, 4)
    bitwise(label, fan["got"], gen["got"], "the generic occlusion mode")
    phase("kernel", f"{label} fan batch ({b} origins x {FAN}): the fan form {fan['ms']:.4f} ms, "
                    f"the generic occlusion mode {gen['ms']:.4f} ms on the same rays "
                    f"({gen['ms'] / fan['ms']:.3f}x); bitwise equal")
    return fan


def soldier_demo(directory):
    """The DEMO plus one stand-in soldier (2,560 triangles) standing on its
    floor."""
    sc = demo_scene()
    path = Path(directory) / "low_soldier.obj"
    segs, steps, height, radius, center, shape = STAND_INS["low_soldier.obj"]
    write_lathe_obj(path, segs, steps, height, radius, center, shape)
    sc.add(TriangleMesh.from_obj(path, standard_materials()["rough_plastic"],
                                 translation=SOLDIER_AT, name="soldier"))
    return sc


def intersect_kernels(soldier):
    """(d), (e) and (f): every mode of the wavefront intersector against its
    plain version at the NEE batch of one 1080p tile."""
    t0 = time.monotonic()
    cam = dataclasses.replace(demo_scene().camera, width=1920, height=1080)
    demo = pack_to(demo_scene().compile(), DEV)
    oc, dc = nee_batch(demo, cam)
    check(oc[0].numel() == 4 * 3 * TILE_PX, "NEE batch size")
    out = prims_vs_plain("(d) K2 DEMO", demo, oc, dc, tiled=False)
    out["occlusion fan"] = fan_vs_plain("(d) K2 DEMO", demo, cam, 2, tiled=False)
    phase("d", f"{time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    pack = pack_to(soldier.compile(), DEV, walk=True)
    n_tris = sum(m.positions.shape[0] for m in soldier.meshes)
    check(pack.tri_sc.shape[0] > 1024 and pack.n_tris <= 4096 and pack.walk is not None,
          f"(e) table {tuple(pack.tri_sc.shape)}, padded {pack.n_tris}, a BVH: "
          f"{pack.walk is not None}")
    phase("e", f"DEMO + soldier: {n_tris} triangles, table rows {pack.tri_sc.shape[0]}, "
               f"padded {pack.n_tris}")
    oc_e, dc_e = nee_batch(pack, cam, seed=1)
    out.update(prims_vs_plain("(e) K3 range", pack, oc_e, dc_e, tiled=True))
    out["occlusion fan tiled"] = fan_vs_plain("(e) K3 range", pack, cam, 3, tiled=True)
    phase("e", f"{time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    rows = demo.tri_sc
    no_sph = rows.new_empty((0, 4))
    # K4's launch alone, on the component planes: (B, 3) rows through
    # `intersect_tris` add two transposing copies
    out["tris"] = intersect_vs_plain(
        "(f) K4 DEMO triangles", lambda: ip.intersect_prims_c(rows, no_sph, 0, oc, dc),
        lambda: intersect_prims_ref(rows, no_sph, 0, oc, dc), "tris", oc[0].numel(),
        int(demo.tri_valid.sum().item()), 0, rows.numel() * 4, 16)
    o, d = torch.stack(oc, 1), torch.stack(dc, 1)
    bitwise("(f) intersect_tris", ip.intersect_tris(rows, o, d), out["tris"]["want"],
            "the plain version")
    rows_ms = cuda_ms(lambda: ip.intersect_tris(rows, o, d), 10, windows=5)
    phase("f", f"{time.monotonic() - t0:.1f} s; `intersect_tris` on (B, 3) rows, bitwise equal: "
               f"{rows_ms:.4f} ms with its copies. No render launches the triangles-only entry "
               f"(K4 has no render path), so its row's launches are 0")
    return out


WF_KERNELS = ("intersect_", "shade_pre", "shade_post", "camera_rays", "fold_kernel")


def wf_route(plain):
    """The block's wavefront route: the plain versions on the card
    (`wavefront.plain_route()`) or the kernels."""
    return wf.plain_route() if plain else contextlib.nullcontext()


def wf_launches():
    """Launches of the wavefront's kernels: its own four and the
    intersector."""
    return sum(wf.launches.values()) + ip.intersect_prims_c.launches


def wavefront_tile_profile(label, sc, plain):
    """One 65,536-pixel tile of `sc` (256x256, spp 1, mb 8) through one
    route: one run counted (bounces, launches), one under torch.profiler
    (wall, device busy, idle share, device events). Returns the profile
    with the launches and device events a bounce."""
    cam = dataclasses.replace(sc.camera, width=TILE_SIDE, height=TILE_SIDE)
    route = "plain" if plain else "cuda"

    def run():
        with wf_route(plain):
            return render_radiance(sc, cam, 1, 5, max_bounces=8, device=DEV)

    reset_counts()
    run()
    bounces = wf.calls[("shade_pre", route)]
    launches = wf_launches()
    prof = device_profile(f"{label}, {route} route", run,
                          kernel="intersect_" if plain else WF_KERNELS,
                          count=(lambda: ip.intersect_prims_c.launches) if plain else wf_launches)
    prof["launches_a_bounce"] = launches / bounces
    prof["events_a_bounce"] = prof["events"] / bounces
    # the tile's bounce loop alone (`_render_tile` on a moved pack): no scene
    # compile, no upload, no framebuffer copy
    (pack, method), = replicate_pack(sc.compile(), [DEV]).values()
    ids = torch.arange(TILE_PX, device=DEV)
    key = torch.tensor(prng.host_fold_in(prng.host_fold_in(prng.key(5).tolist(), 0), 0))

    def loop():
        with wf_route(plain):
            return _render_tile(pack, cam, ids, key, 1, 8, method)

    loop()
    prof["loop_ms"] = statistics.median(synced_s(loop) for _ in range(5)) * 1e3
    loop_prof = device_profile(f"{label}, {route} route, the bounce loop alone", loop,
                               kernel="intersect_" if plain else WF_KERNELS,
                               count=(lambda: ip.intersect_prims_c.launches) if plain
                               else wf_launches)
    prof["loop_busy_ms"], prof["loop_idle"] = loop_prof["busy_ms"], loop_prof["idle"]
    prof["loop_events_a_bounce"] = loop_prof["events"] / bounces
    phase("g", f"{label}, {route} route: render_radiance wall {prof['wall_ms']:.1f} ms (the "
               f"scene's compile and upload included), device busy {prof['busy_ms']:.1f} ms, "
               f"idle share {prof['idle']}; {bounces} bounces; "
               f"{prof['launches_a_bounce']:.2f} launches of the wavefront's and the "
               f"intersector's kernels a bounce, {prof['events_a_bounce']:.1f} device events a "
               f"bounce (everything the render ran over its bounces); the bounce loop alone "
               f"(`_render_tile`, median of 5): wall {prof['loop_ms']:.2f} ms, device busy "
               f"{prof['loop_busy_ms']:.2f} ms, idle share {prof['loop_idle']}, "
               f"{prof['loop_events_a_bounce']:.1f} device events a bounce")
    return prof


def wavefront_main():
    """(g)'s main path: the DEMO at WF_RES through the kernels and through
    the plain route, images and ray counts equal. Returns the four kernels'
    and the intersector's launches in the kernel route's render."""
    sc = demo_scene()
    cam = dataclasses.replace(sc.camera, width=WF_RES[0], height=WF_RES[1])
    reset_counts()
    t1 = time.monotonic()
    img, stats = render_radiance(sc, cam, WF_SPP, 0, max_bounces=8, device=DEV)
    wall = time.monotonic() - t1
    by_mode = dict(ip.intersect_prims_c.by_mode)
    launched = dict(wf.launches)
    check(by_mode.get("nearest", 0) > 0 and by_mode.get("occlusion fan", 0) > 0,
          f"the wavefront render launched {by_mode}")
    check(all(launched.get(k, 0) > 0 for k in wf.KERNELS), f"the wavefront kernels: {launched}")
    check(not any(r != "cuda" for _, r in wf.calls), f"a plain route ran: {dict(wf.calls)}")
    check(img.shape == (WF_RES[1], WF_RES[0], 3) and bool(np.isfinite(img).all()),
          "wavefront image")
    check(0.0 < float(img.mean()) < 10.0, f"wavefront image mean {img.mean()}")
    phase("g", f"wavefront {WF_RES[0]}x{WF_RES[1]} spp {WF_SPP} mb 8, kernel route: wall "
               f"{wall:.3f} s, render "
               f"{stats['elapsed_s']:.3f} s, {stats['rays']} rays, {stats['rays_per_s']:.4e} "
               f"rays/s, {stats['wavelength_paths_per_s']:.4e} wavelength-paths/s, "
               f"routes {sorted({r for _, r in wf.calls})}, launches {launched} (by instance "
               f"{dict(wf.by_instance)}), intersector "
               f"{by_mode}, megakernel launches {mk.trace_block.launches}")
    reset_counts()
    t1 = time.monotonic()
    with wf_route(True):
        img_p, stats_p = render_radiance(sc, cam, WF_SPP, 0, max_bounces=8, device=DEV)
    wall_p = time.monotonic() - t1
    check(not wf.launches, f"the plain route launched {dict(wf.launches)}")
    same = bool(np.array_equal(img.view(np.int32), img_p.view(np.int32)))
    phase("g", f"the same render, plain route: wall {wall_p:.3f} s, render "
               f"{stats_p['elapsed_s']:.3f} s, {stats_p['rays']} rays; image bitwise equal "
               f"{same} ({int((img != img_p).sum())} values differ, max abs err "
               f"{float(np.abs(img - img_p).max()):.3g}), rays equal "
               f"{stats['rays'] == stats_p['rays']}; {wall_p / wall:.1f}x the kernel route's wall")
    check(same and stats["rays"] == stats_p["rays"],
          "the 1080p wavefront image differs from the plain route's")
    return {"kernels": launched, "modes": by_mode}


def wavefront_path(mega_img, soldier):
    """(g): the wavefront engine end to end on the card, through its
    kernels, and against its plain route. Returns `wavefront_main`'s
    launches, the walk-only render's intersector launches and the tile's
    profiles by route."""
    t0 = time.monotonic()
    sc = demo_scene()
    main_launches = wavefront_main()
    # one tile's work (65,536 pixels, spp 1) under the profiler, both routes
    tile = {plain: wavefront_tile_profile("(g) one 65,536-pixel DEMO tile, spp 1 mb 8", sc,
                                          plain) for plain in (False, True)}
    phase("g", "that tile's intersector rays a launch, by mode (plain route): " + ", ".join(
        f"{m} {n / ip.intersect_prims_c.by_mode[m]:.0f}"
        for m, n in sorted(ip.intersect_prims_c.rays_by_mode.items())))

    # 384x384 renders in one tile of 147,456 pixels (the default 65,536
    # would pad the third tile to a full one)
    one_tile = 384 * 384
    img384, st = render_radiance(sc, sc.camera, 64, 0, max_bounces=8, tile_pixels=one_tile,
                                 device=DEV)
    check(bool(np.isfinite(img384).all()), "384x384 wavefront image")
    m_wf, m_mega = float(img384.mean()), float(mega_img.mean())
    rel = abs(m_wf - m_mega) / m_mega
    blocks = lambda x: x.reshape(12, 32, 12, 32, 3).mean(axis=(1, 3)).ravel()
    corr = float(np.corrcoef(blocks(img384), blocks(mega_img))[0, 1])
    phase("g", f"384x384 wavefront spp 64 ({st['elapsed_s']:.3f} s) vs megakernel spp 256: "
               f"means {m_wf:.5f} vs {m_mega:.5f}, relative diff {rel:.4f} (<0.03), "
               f"12x12 block-mean correlation {corr:.4f} (>0.95)")
    check(rel < 0.03 and corr > 0.95, "wavefront and megakernel images disagree")

    reset_counts()
    t1 = time.monotonic()
    img_s, st_s = render_radiance(soldier, soldier.camera, 8, 0, max_bounces=8,
                                  tile_pixels=one_tile, device=DEV)
    wall = time.monotonic() - t1
    walked = dict(ip.intersect_prims_c.by_mode)
    check(set(walked) == {"nearest walk", "occlusion walk"},
          f"the DEMO + soldier render launched {walked}")
    check(all(wf.launches[k] > 0 for k in wf.KERNELS), f"DEMO + soldier: {dict(wf.launches)}")
    check(bool(np.isfinite(img_s).all()) and float(img_s.mean()) > 0.0, "DEMO + soldier image")
    phase("g", f"DEMO + soldier 384x384 spp 8 mb 8: wall {wall:.3f} s, render "
               f"{st_s['elapsed_s']:.3f} s, {st_s['rays']} rays, {st_s['rays_per_s']:.4e} "
               f"rays/s, launches {dict(wf.launches)}, intersector {walked}")
    device_profile("DEMO + soldier 384x384 spp 1 mb 8", lambda: render_radiance(
        soldier, soldier.camera, 1, 5, max_bounces=8, tile_pixels=one_tile, device=DEV),
        kernel=WF_KERNELS, count=wf_launches)

    conf_wavefront()
    phase("g", f"{time.monotonic() - t0:.1f} s")
    return main_launches, walked, tile


def conf_wavefront(width=384, height=216):
    """The stand-in --conf scene (38,528 triangles, over DENSE_MAX_TRIS)
    through the CLI's wavefront engine: K3's walk alone, once for each
    primary batch and bounce, so no query took the eager bvh method. Then
    the same scene (the thin lens, the sky map, the textured floor) through
    render_radiance by both routes, bitwise."""
    from mcpt_tpu_torch.__main__ import main as cli

    t1 = time.monotonic()
    with tempfile.TemporaryDirectory() as models:
        write_stand_in_models(models)
        out = Path(models, "wf.png")
        reset_counts()
        cli(["--conf", str(ROOT / "conf.json"), "--models-dir", models, "--engine", "wavefront",
             "--width", str(width), "--height", str(height), "--spp", "1", "--out", str(out),
             "--device", DEV])
        conf_img = read_png(out)
        conf_modes, launched = dict(ip.intersect_prims_c.by_mode), dict(wf.launches)
        routes = {r for _, r in wf.calls}
        scene, _ = build_scene(load_config(ROOT / "conf.json"), models_dir=models)
    walks = {"nearest walk": launched.get("camera_rays", 0) + launched.get("shade_pre", 0),
             "occlusion walk": launched.get("shade_pre", 0)}
    check(conf_modes == walks and routes == {"cuda"},
          f"the --conf wavefront launched {conf_modes} (each primary batch and bounce's walks "
          f"{walks}) by the routes {routes}")
    check(all(launched.get(k, 0) > 0 for k in wf.KERNELS), f"--conf wavefront: {launched}")
    check(conf_img.shape[:2] == (height, width), f"--conf wavefront image {conf_img.shape}")
    phase("g", f"CLI --conf --engine wavefront {width}x{height} spp 1 mb 8: "
               f"{time.monotonic() - t1:.1f} s, routes {sorted(routes)}, intersector "
               f"{conf_modes} (every query the walk), launches {launched}, image mean "
               f"{float(conf_img[:, :, :3].mean()):.2f}/255")
    cam = dataclasses.replace(scene.camera, width=width, height=height)
    check(cam.use_dof and scene.env_pixels is not None, "conf.json: thin lens, sky map")
    t1 = time.monotonic()
    img, st = render_radiance(scene, cam, 1, 0, max_bounces=8, device=DEV)
    with wf_route(True):
        img_p, st_p = render_radiance(scene, cam, 1, 0, max_bounces=8, device=DEV)
    same = bool(np.array_equal(img.view(np.int32), img_p.view(np.int32)))
    phase("g", f"the --conf scene {width}x{height} spp 1 mb 8 ({scene.n_dir_sample} light "
               f"samples a vertex) through render_radiance, kernel route vs plain route: image bitwise equal {same} ({int((img != img_p).sum())} "
               f"values differ), rays {st['rays']} vs {st_p['rays']}; "
               f"{time.monotonic() - t1:.1f} s")
    check(same and st["rays"] == st_p["rays"],
          "the --conf wavefront image differs from the plain route's")


def same_bits(label, name, got, want):
    """`got` and `want` (tensors, or 3-tuples of them) bitwise equal
    (float32 compared as int32: +0 and -0 differ, NaN patterns must
    match)."""
    if isinstance(got, tuple):
        for k, (g, w) in enumerate(zip(got, want)):
            same_bits(label, f"{name}[{k}]", g, w)
        return
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{label}: {name} dtype/shape {got.dtype} {tuple(got.shape)} vs {want.dtype} "
          f"{tuple(want.shape)}")
    view = (lambda x: x.view(torch.int32)) if got.dtype == torch.float32 else (lambda x: x)
    differ = view(got) != view(want)
    check(not bool(differ.any()),
          f"{label}: {name} differs from the plain version on {int(differ.sum())} of "
          f"{got.numel()} lanes")


def kernels_vs_plain_trace(label, sc, seed, mb=8, timed=False):
    """(l): the four wavefront kernels against their plain versions on one
    65,536-pixel tile of `sc` (256x256, spp 1), bounce by bounce on the same
    inputs: the camera rays, every field of shade_pre (next rays, the fan,
    the per-lane terms), the intersector on the kernel's fan and next rays,
    shade_post's records row, next alive and ray count, the fold's
    radiance; then `trace_paths_c` through both routes end to end. With
    `timed`, each kernel's ms at depth 0 (the median of 5 means of 10),
    its plain version's ms (one run) and its bound."""
    t0 = time.monotonic()
    cam = dataclasses.replace(sc.camera, width=TILE_SIDE, height=TILE_SIDE)
    (pack, method), = replicate_pack(sc.compile(), [DEV]).values()
    ids = torch.arange(TILE_PX, device=DEV)
    (sample,) = prng.host_split(prng.key(seed).tolist(), 1)
    k_cam, key = torch.tensor(prng.host_split(sample), dtype=torch.int64, device=DEV)
    b, s = 3 * TILE_PX, wfr.n_samples(pack)
    chan = torch.arange(3, device=DEV).repeat(TILE_PX)
    lam = torch.tensor(WAVELEN_UM, device=DEV)[chan]
    o, d = wf.camera_rays(cam, ids, k_cam, 3)
    same_bits(label, "camera rays", (*o, *d), sum(wfr.camera_rays(cam, ids, k_cam, 3), ()))
    o0, d0 = o, d
    hit = intersect_c(pack, o, d, method=method)
    alive = torch.ones(b, dtype=torch.bool, device=DEV)
    rec, rec_p = wfr.new_records(mb, b, DEV), wfr.new_records(mb, b, DEV)
    rays, rays_p = (torch.zeros((), dtype=torch.int64, device=DEV) for _ in range(2))
    timing, bounces = {}, 0
    for depth in range(mb):
        if not bool(alive.any()):
            break
        bounces += 1
        args = (pack, o, d, hit, alive, depth, key, lam, chan)
        pre = wf.shade_pre(*args)
        for f, got, want in zip(wfr.PreOut._fields, pre, wfr.shade_pre(*args)):
            same_bits(label, f"depth {depth} shade_pre {f}", got, want)
        sh_t = (occlude_t_c(pack, pre.p_dl, pre.ws, method=method, fan=s)
                if s and pack.enable_shadow else None)
        nxt = intersect_c(pack, pre.p_new, pre.wi, method=method)
        post_args = (pack, pre, sh_t, nxt.prim)
        if timed and depth == 0:
            timing = time_halves(label, args, post_args, rec, rays, cam, ids, k_cam, b, s)
        nxt_alive = wf.shade_post(*post_args, rec, depth, rays)
        same_bits(label, f"depth {depth} shade_post alive", nxt_alive,
                  wfr.shade_post(*post_args, rec_p, depth, rays_p))
        for f in wfr.Records._fields:
            same_bits(label, f"depth {depth} record {f}", getattr(rec, f)[depth],
                      getattr(rec_p, f)[depth])
        check(int(rays) == int(rays_p), f"{label}: depth {depth} rays {int(rays)} vs "
                                        f"{int(rays_p)}")
        o, d, hit, alive = pre.p_new, pre.wi, nxt, nxt_alive
    rad = wf.fold(rec)
    same_bits(label, "fold radiance", rad, wfr.fold(rec))
    if timed:
        timing["fold"] = time_fold(label, rec, b)
    r_k, st_k = trace_paths_c(pack, o0, d0, lam, chan, key, max_bounces=mb, method=method)
    with wf_route(True):
        r_p, st_p = trace_paths_c(pack, o0, d0, lam, chan, key, max_bounces=mb, method=method)
    same_bits(label, "trace_paths_c radiance, kernel route vs plain route", r_k, r_p)
    same_bits(label, "trace_paths_c radiance vs the stepped fold", r_k, rad)
    check(int(st_k.rays) == int(st_p.rays) == int(rays) + b,
          f"{label}: rays {int(st_k.rays)} vs {int(st_p.rays)}")
    phase("l", f"{label}: {b} lanes, {s} light samples a vertex, intersector "
               f"{pack.walk is not None and 'walk' or method}, "
               f"{'thin lens' if cam.use_dof else 'pinhole'}, {pack.n_sph_emitters} emissive "
               f"spheres, {bounces} bounces: camera_rays, "
               f"shade_pre, shade_post and fold bitwise equal to their plain versions on every "
               f"lane at every bounce (records, next rays, fan, alive), radiance and "
               f"{int(st_k.rays)} rays equal through both routes; mean radiance "
               f"{float(r_k.mean()):.5f}; {time.monotonic() - t0:.1f} s")
    return timing


def table_bytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def cuda_ms_cold(fn, reps=20):
    """Device milliseconds of one fn() whose inputs come from DRAM: each run
    timed alone between two CUDA events after a read of L2_FLUSH_BYTES
    that evicts the L2 (a read, so no dirty line is left for fn to write
    back), the median of `reps`; the runs queue behind a spin, as in
    `cuda_ms`."""
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=DEV)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(4 * SPIN_CYCLES * reps)
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


# aten ops that move, gather or allocate data (no arithmetic of a lane)
MOVES = frozenset((
    "view", "_unsafe_view", "reshape", "expand", "clone", "copy_", "stack", "cat", "select",
    "slice", "unbind", "detach", "alias", "lift_fresh", "t", "permute", "unsqueeze", "squeeze",
    "index", "index_put", "index_put_", "_index_put_impl_", "take", "zeros", "zeros_like",
    "new_zeros", "empty", "empty_like", "new_empty", "full", "full_like", "fill_", "fill",
    "arange", "repeat", "sum", "searchsorted", "scalar_tensor", "_local_scalar_dense",
    "empty_strided", "new_empty_strided", "as_strided", "split", "split_with_sizes"))


def plain_ops(fn):
    """The float32 operations `fn` (a plain version) runs: the elements of
    every aten op's float or bool result, but of ops that move, gather or
    allocate data (`MOVES`) and of integer results (the draws' hashing,
    which the bound counts as integer operations, and row ids). The plain
    versions are straight-line over all lanes, so this is what the kernel's
    lanes compute, selects and compares included."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Tally(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ not in MOVES:
                for x in tree_flatten(out)[0]:
                    if isinstance(x, torch.Tensor) and (x.is_floating_point() or
                                                        x.dtype == torch.bool):
                        Tally.n += x.numel()
            return out

    with torch.no_grad(), Tally():
        fn()
    return Tally.n


def kernel_row(label, name, kernel, plain, flops, nbytes, extra="", iops=0):
    """A wavefront kernel's row of the kernels line: its ms from DRAM
    (`cuda_ms_cold`), its plain version's ms (one run) and its bound; the
    back-to-back time with its inputs L2-resident is printed beside them,
    and the bound's three terms (float and integer operations, bytes).
    `flops` None: the float32 operations the plain version runs
    (`plain_ops`)."""
    kernel()  # warm
    plain()
    plain_ms = synced_s(plain) * 1e3
    if flops is None:
        flops = plain_ops(plain)
    ms = cuda_ms_cold(kernel)
    warm_ms = cuda_ms(kernel, 10, windows=5)
    bound_ms, bound_by = roofline(flops, nbytes, iops)
    terms = {"float operations": flops / PEAK_F32 * 1e3, "integer operations":
             iops / PEAK_I32 * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3}
    phase("kernel", f"{label} [{name}]: kernel {ms:.4f} ms with the L2 flushed before each "
                    f"launch ({warm_ms:.4f} ms back to back, L2-resident), plain "
                    f"{plain_ms:.1f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
                    f"{nbytes / 1e6:.2f} MB, {flops:.4g} float and {iops:.4g} integer "
                    f"operations: " + ", ".join(f"{k} {v:.5f} ms" for k, v in terms.items())
                    + f"; bounded by {max(terms, key=terms.get)}), share "
                    f"{bound_ms / ms:.4f}{extra}")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": 0.0, "bound_ms": bound_ms,
            "bound_by": bound_by}


def time_halves(label, args, post_args, rec, rays, cam, ids, k_cam, b, s):
    """The camera, shade_pre and shade_post at the tile's depth-0 shapes:
    kernel ms, plain ms and the bound (each input read once, each output
    written once: the lane planes, the tables the lanes read, the fan).
    shade_pre's float operations are its plain version's (`plain_ops`), its
    integer operations the threefry hashes a lane runs (`vertex_iops`). The
    camera's work is a pixel's, whose ray its lanes repeat:
    `OPS_PER['camera']` float operations and 2 draws (4 through a thin
    lens) a pixel; its bytes, a pixel's id (8 B) and the key read, and 6
    floats written to each of its lanes."""
    pack = args[0]
    p_px = ids.numel()
    cam_row = kernel_row(label, "camera_rays", lambda: wf.camera_rays(cam, ids, k_cam, 3),
                         lambda: wfr.camera_rays(cam, ids, k_cam, 3),
                         p_px * OPS_PER["camera"], 8 * p_px + 16 + 24 * b,
                         iops=p_px * (4 if cam.use_dof else 2) * DRAW_OPS)
    pre_row = kernel_row(label, "shade_pre", lambda: wf.shade_pre(*args),
                         lambda: wfr.shade_pre(*args), None, vertex_bytes(pack, b, s),
                         iops=vertex_iops(b, s))
    scratch, rays_s = wfr.Records(*(x.clone() for x in rec)), rays.clone()
    post_bytes = b * (12 * s + 16 + 2 + 4 + 12 + 2) + 8 + table_bytes(pack.prim_emissive)
    post_row = kernel_row(label, "shade_post",
                          lambda: wf.shade_post(*post_args, scratch, 0, rays_s),
                          lambda: wfr.shade_post(*post_args, scratch, 0, rays_s),
                          b * (3 * s + 12), post_bytes)
    return {"camera_rays": cam_row, "shade_pre": pre_row, "shade_post": post_row}


def vertex_tables(pack):
    """Bytes of the tables the vertex kernels read, and of the env texels
    two lookups a lane touch (at most the map)."""
    return table_bytes(pack.tri_shade, pack.sph_shade, pack.mat_fat, pack.emt_fat,
                       pack.emt_intra_cum, pack.lmesh_cum, pack.lmesh_area, pack.lmesh_first,
                       pack.lmesh_count)


def vertex_bytes(pack, b, s):
    """shade_pre's bytes for b lanes at s light samples: in, a lane's ray,
    hit, flags, wavelength and channel (53 B) and the key; out, its next
    ray, fan origin and terms (13 floats, 2 flags) and each sample's
    direction, threshold and contribution; the tables read once."""
    env = pack.env_pixels if pack.use_env else pack.env_pixels[:0]
    env_bytes = min(table_bytes(env), 2 * 4 * 4 * b)  # the texels 2 lookups a lane touch
    return b * (53 + 13 * 4 + 2 + 5 * 4 * s) + 16 + vertex_tables(pack) + env_bytes


def vertex_iops(b, s):
    """The integer operations of the vertex kernels' threefry hashes for b
    lanes at s light samples: the bounce's 3 keys a lane (`THREEFRY_OPS`
    each) and the draws, 4 a lane and 4 a sample (`DRAW_OPS` each)."""
    return b * (3 * THREEFRY_OPS + (4 + 4 * s) * DRAW_OPS)


def time_fold(label, rec, b):
    """The fold on the tile's records. Its bytes are what the lanes' values
    need: the terminal flags up to each lane's first terminal depth f, the
    leaf there, the l_dir and w of the f depths before it (the kernel reads
    just these), and the output; its operations, six a folded depth."""
    depth = rec.leaf.shape[0]
    term = rec.terminal
    first = torch.where(term.any(0), term.to(torch.int32).argmax(0), depth).to(torch.int64)
    folded = int(first.sum())
    nbytes = (int(torch.clamp(first + 1, max=depth).sum()) + 4 * int((first < depth).sum())
              + 8 * folded + 4 * b)
    return kernel_row(label, "fold", lambda: wf.fold(rec), lambda: wfr.fold(rec),
                      6 * folded, nbytes, f" ({depth} records a lane, {folded / b:.3f} "
                                          f"folded a lane)")


# (l): shade_post's and fold's edges: lane counts around shade_post's
# vector instance's lanes a thread (`wavefront.VECTOR_LANES`: a lane count
# they do not divide takes the scalar instance, whose record rows at depth
# > 0 start off the vector's grid), a view that starts off it, light-sample
# counts (0: no shadow rows), record depths (over one chunk of the fold's
# flag search: 20)
EDGE_LANES = (1, 3, 4, 5, 6, 4096, 4097)
EDGE_SAMPLES = (0, 1, 4, 40)
EDGE_DEPTHS = (1, 8, 20)


def _spiked(rng, n, lo, hi, spikes, rate=0.25):
    """n float32 uniform in [lo, hi), a `rate` of them one of `spikes`."""
    x = rng.uniform(lo, hi, n).astype(np.float32)
    m = rng.random(n) < rate
    x[m] = rng.choice(np.asarray(spikes, np.float32), int(m.sum()))
    return x


def post_case(b, s, seed, shadows=True):
    """shade_post's inputs for b lanes at s light samples (numpy, from
    `seed`): contributions with 0, -0, the clamp's 15 and 5, NaN and ±inf
    among them; shadow t below, equal to and above each threshold, and NaN;
    fac with 1, 0 and NaN; flags at random; next prims from -1 up into a
    7-row emissive table holding 0.5, the float above it and NaN.
    `shadows=False`: no shadow t (the pack's shadows off)."""
    rng = np.random.default_rng(seed)
    n = s * b
    thr = rng.uniform(0.0, 10.0, n).astype(np.float32)
    sh_t = thr + rng.choice(np.float32([-1.0, 0.0, 0.0, 1.0]), n)
    sh_t[rng.random(n) < 0.1] = np.nan
    emissive = np.float32([[0.0], [1.0], [0.5], [np.nextafter(np.float32(0.5), 1)], [np.nan],
                           [2.0], [0.0]])
    return {
        "contrib": _spiked(rng, n, -0.5, 8.0, [0.0, -0.0, 15.0, 5.0, np.nan, np.inf, -np.inf]),
        "thr": thr, "sh_t": sh_t if shadows else None,
        "fac": _spiked(rng, b, -1.0, 4.0, [1.0, 1.0, 0.0, np.nan]),
        "leaf_pre": _spiked(rng, b, -1.0, 20.0, [np.nan, 15.0]),
        "env_c": _spiked(rng, b, 0.0, 5.0, [0.0, 5.0, np.nan]),
        "w": _spiked(rng, b, 0.0, 3.0, [0.0, np.inf, np.nan]),
        "at_vertex": rng.random(b) < 0.7, "rr_kill": rng.random(b) < 0.2,
        "nxt_prim": rng.integers(-1, len(emissive), b).astype(np.int32),
        "prim_emissive": emissive,
    }


def fold_records(depth, b, seed):
    """Adversarial records for the fold (numpy, from `seed`; each (depth,
    b)): the lanes' first terminal depths f cover every depth and `depth`
    (no terminal depth), shuffled, so a thread's lanes differ; the flags
    after f at random; before f, l_dir with the direct clamp's edges 0 and
    15 and w with 0, 1 and 5 among uniform values (w 1 on a leaf of 5
    lands on the indirect clamp's edge); at f, a leaf with 0, -0, 5 and 15
    among them; after f, and in the leaf at every depth but f, NaN, ±inf
    and ±1e30 among uniform values. No -0 in l_dir: torch.clamp keeps -0
    where XLA's clip gives +0, so -0 would compare by value only."""
    rng = np.random.default_rng(seed)
    first = rng.permutation(np.arange(b) % (depth + 1))
    d = np.arange(depth)[:, None]
    after, at = d > first, d == first
    junk = [np.nan, np.inf, -np.inf, 1e30, -1e30]

    def plane(lo, hi, spikes):
        x = _spiked(rng, depth * b, lo, hi, spikes).reshape(depth, b)
        bad = _spiked(rng, depth * b, -2.0, 20.0, junk, rate=0.5).reshape(depth, b)
        return x, bad

    l_dir, bad = plane(-2.0, 20.0, [0.0, 15.0])
    l_dir = np.where(after, bad, l_dir)
    w, bad = plane(0.0, 3.0, [0.0, 1.0, 5.0])
    w = np.where(after, bad, w)
    leaf, bad = plane(-1.0, 20.0, [0.0, -0.0, 5.0, 15.0])
    leaf = np.where(at, leaf, bad)
    terminal = at | (after & (rng.random((depth, b)) < 0.5))
    return {"l_dir": l_dir, "w": w, "leaf": leaf, "terminal": terminal}


def _lane_view(x, dev, offset):
    """`x` (numpy) as a tensor on `dev`, a view `offset` elements into a
    buffer of its own (offset 1: its rows start off the 16-byte grid)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    buf = torch.empty(offset + t.numel(), dtype=t.dtype, device=dev)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def post_edge(b, s, seed, dev, shadows=True, offset=0, depth=2):
    """shade_post's kernel route and plain version on `post_case(b, s,
    seed, shadows)` (its planes `offset` elements into their buffers),
    each writing row `depth` of its own 3-deep records and adding to its
    own ray count (7 to start): returns [(name, got, want)] over the next
    alive, every record plane (all rows: the others untouched) and the ray
    count."""
    case = post_case(b, s, seed, shadows)
    t = {k: (None if v is None else _lane_view(v, dev, offset)) for k, v in case.items()}
    pack = SimpleNamespace(prim_emissive=t["prim_emissive"], n_dir_sample=s,
                           n_emitters=int(s > 0))
    pre = wfr.PreOut(p_new=None, wi=None, p_dl=None, ws=None,
                     **{k: t[k] for k in ("thr", "contrib", "fac", "leaf_pre", "env_c", "w",
                                          "at_vertex", "rr_kill")})
    out = []
    for route in ("cuda", "plain"):
        rec = wfr.new_records(3, b, dev)
        rays = torch.full((), 7, dtype=torch.int64, device=dev)
        alive = wf.shade_post(pack, pre, t["sh_t"], t["nxt_prim"], rec, depth, rays,
                              route=route)
        out.append((alive, *rec, rays))
    names = ("alive", *wfr.Records._fields, "rays")
    return [(f"shade_post {name}", g, w) for name, g, w in zip(names, *out)]


def fold_edge(depth, b, seed, dev, offset=0):
    """fold's kernel route and plain version on `fold_records(depth, b,
    seed)` (each plane `offset` elements into its buffer): [(name, got,
    want)]."""
    rec = wfr.Records(**{k: _lane_view(v, dev, offset)
                         for k, v in fold_records(depth, b, seed).items()})
    return [("fold radiance", wf.fold(rec, route="cuda"), wf.fold(rec, route="plain"))]


def edge_instance(b, offset):
    """shade_post's instance for an edge case, as its C entry picks it:
    ("shade_post", lanes a thread), the vector instance's lanes where they
    divide b and the planes start on its grid (offset 0), else 1."""
    lanes = wf.VECTOR_LANES
    return "shade_post", lanes if b % lanes == 0 and not offset else 1


# (l): camera_rays' edges, (pixels, first id, view offset): lane counts
# around its vector instance's floats a store (`wavefront.CAMERA_VECTOR`: a
# lane count it does not divide takes the scalar instance) and around its
# 256-thread blocks, a tile's ids at an offset (as `_render_tile` passes
# them), ids to both sides of 2^31 and below 0 (the 64-bit division), ids
# through a view off the 16-byte grid; each at 1 and 3 lanes a pixel,
# pinhole and thin lens
CAMERA_EDGES = ((1, 0, 0), (3, 0, 0), (4, 0, 0), (5, 0, 0), (43, 0, 0), (256, 0, 0),
                (257, 0, 0), (4096, 0, 0), (4099, 0, 0), (4096, 3 * TILE_PX, 0),
                (8, 2**31 - 4, 0), (8, -6, 0), (4096, 0, 1))


def edge_camera(dof):
    """The 1920x1080 DEMO camera, through the thin lens of `lens_lamp_demo`
    if `dof`."""
    sc = lens_lamp_demo() if dof else demo_scene()
    return dataclasses.replace(sc.camera, width=1920, height=1080)


def camera_edge(pixels, first, offset, per, dof, dev):
    """camera_rays' kernel route and plain version on ids first .. first +
    pixels - 1 (a view `offset` elements into its buffer) of `edge_camera`:
    [(name, got, want)] over the six planes."""
    ids = _lane_view(np.arange(first, first + pixels, dtype=np.int64), dev, offset)
    key = torch.tensor([0x2A, 0xC0FFEE], dtype=torch.int64, device=dev)
    cam = edge_camera(dof)
    got = sum(wf.camera_rays(cam, ids, key, per, route="cuda"), ())
    want = sum(wf.camera_rays(cam, ids, key, per, route="plain"), ())
    return [(f"camera_rays plane {k}", g, w) for k, (g, w) in enumerate(zip(got, want))]


def camera_instance(pixels, per):
    """camera_rays' instance for an edge case, as its C entry picks it:
    ("camera_rays", floats a store), the vector instance's where they divide
    the lane count (the wrapper's planes then start on its grid), else 1."""
    v = wf.CAMERA_VECTOR
    return "camera_rays", v if pixels * per % v == 0 else 1


def camera_edges():
    """(l): camera_rays bitwise against its plain version at `CAMERA_EDGES`
    x 1 and 3 lanes a pixel x pinhole and thin lens, each through the
    instance `camera_instance` names; both instances must launch."""
    t0 = time.monotonic()
    before = collections.Counter(wf.by_instance)
    cases = [(edge, per, dof) for edge in CAMERA_EDGES for per in (1, 3) for dof in (False, True)]
    for (pixels, first, offset), per, dof in cases:
        what = f"{pixels} pixels from id {first} (view offset {offset}), {per} lanes a pixel, " \
               f"{'thin lens' if dof else 'pinhole'}"
        was = collections.Counter(wf.by_instance)
        for name, got, want in camera_edge(pixels, first, offset, per, dof, DEV):
            same_bits(f"(l) camera edges {what}", name, got, want)
        ran, instance = wf.by_instance - was, camera_instance(pixels, per)
        check(ran == collections.Counter({instance: 1}),
              f"(l) camera edges {what}: launched {dict(ran)}, not {instance}")
    ran = wf.by_instance - before
    check(all(ran["camera_rays", v] > 0 for v in (wf.CAMERA_VECTOR, 1)),
          f"(l) camera edges: not every camera_rays instance launched: {dict(ran)}")
    phase("l", f"camera_rays at its edges ({len(cases)} cases: (pixels, first id, view offset) "
               f"{CAMERA_EDGES} x 1 and 3 lanes a pixel x pinhole and thin lens) bitwise equal to "
               f"its plain version; launches by instance {dict(ran)}; "
               f"{time.monotonic() - t0:.1f} s")


def post_fold_edges():
    """(l): shade_post and fold bitwise against their plain versions at
    their edges (`EDGE_LANES` x `EDGE_SAMPLES`, shadows off at 4 samples,
    x `EDGE_DEPTHS` for the fold, and each at 4,096 lanes through views
    offset by one element); both instances of shade_post must launch, each
    where the lane count and the rows' alignment say, and the fold once a
    case."""
    t0 = time.monotonic()
    before = collections.Counter(wf.by_instance)
    cases = [("shade_post", dict(b=b, s=s), post_edge, (b, s, 10 * b + s, DEV))
             for b in EDGE_LANES for s in EDGE_SAMPLES]
    cases += [("shade_post", dict(b=b, s=4, shadows=False), post_edge,
               (b, 4, b, DEV, False)) for b in EDGE_LANES]
    cases.append(("shade_post", dict(b=4096, s=4, offset=1), post_edge, (4096, 4, 3, DEV, True, 1)))
    cases += [("fold", dict(b=b, depth=depth), fold_edge, (depth, b, 10 * b + depth, DEV))
              for b in EDGE_LANES for depth in EDGE_DEPTHS]
    cases.append(("fold", dict(b=4096, depth=8, offset=1), fold_edge, (8, 4096, 5, DEV, 1)))
    for kernel, what, fn, args in cases:
        was, was_fold = collections.Counter(wf.by_instance), wf.launches["fold"]
        for name, got, want in fn(*args):
            same_bits(f"(l) edges {what}", name, got, want)
        ran = wf.by_instance - was
        if kernel == "shade_post":
            instance = edge_instance(what["b"], what.get("offset", 0))
            check(ran == collections.Counter({instance: 1}),
                  f"(l) edges {what}: launched {dict(ran)}, not {instance}")
        else:
            check(not ran and wf.launches["fold"] == was_fold + 1,
                  f"(l) edges {what}: {wf.launches['fold'] - was_fold} fold launches")
    ran = wf.by_instance - before
    check(all(ran["shade_post", v] > 0 for v in (wf.VECTOR_LANES, 1)),
          f"(l) edges: not every shade_post instance launched: {dict(ran)}")
    phase("l", f"shade_post and fold at their edges ({len(cases)} cases: lanes "
               f"{EDGE_LANES}, light samples {EDGE_SAMPLES} and shadows off, fold depths "
               f"{EDGE_DEPTHS}, adversarial records, views off the vectors' grid) bitwise equal to "
               f"their plain versions, ray counts equal; launches by instance {dict(ran)}; "
               f"{time.monotonic() - t0:.1f} s")


def lens_lamp_demo():
    """The DEMO seen through a thin lens (focused at 800, aperture radius 8)
    with an emissive sphere beside its area light: the camera's lens draws
    and the light pick's sphere branch."""
    sc = demo_scene()
    sc.add(Sphere((200.0, 120.0, 300.0), 40.0, make_light_material(1.0), "lamp"))
    sc.camera = dataclasses.replace(sc.camera, use_dof=True, focal_distance=800.0,
                                    aperture_radius=8.0)
    return sc


def wavefront_kernels(soldier):
    """(l): the four wavefront kernels bitwise against their plain versions
    on the DEMO (timed), the sky-lit DEMO, DEMO + soldier (the walk), the
    DEMO at 40 light samples and the DEMO through a thin lens with an
    emissive sphere; then camera_rays, shade_post and fold at their edges
    (`camera_edges`, `post_fold_edges`)."""
    t0 = time.monotonic()
    timing = kernels_vs_plain_trace("(l) DEMO", demo_scene(), 1, timed=True)
    sky = demo_scene()
    sky.load_env_map(SKY)
    kernels_vs_plain_trace("(l) sky-lit DEMO", sky, 2)
    kernels_vs_plain_trace("(l) DEMO + soldier", soldier, 3)
    forty = demo_scene()
    forty.n_dir_sample = 40
    kernels_vs_plain_trace("(l) DEMO, 40 light samples", forty, 4)
    lens = lens_lamp_demo()
    check(lens.camera.use_dof and lens.compile().n_sph_emitters == 1,
          "the thin-lens DEMO: one emissive sphere")
    kernels_vs_plain_trace("(l) DEMO, thin lens and an emissive sphere", lens, 5)
    camera_edges()
    post_fold_edges()
    phase("l", f"{time.monotonic() - t0:.1f} s")
    return timing


def lockstep_path(pack, regen_img):
    """(h1) and (h2): the lockstep kernel against its plain version, then its
    main path."""
    t0 = time.monotonic()
    sc = demo_scene()
    tables = SceneTables.from_pack(pack, device="cuda")
    kernel_vs_plain(tables, dataclasses.replace(sc.camera, width=64, height=48), 8, 6, 11,
                    "(h1) DEMO small", every_lane=True, regen=False)
    at_demo = kernel_vs_plain(tables, sc.camera, 2, 8, 3, "(h1) DEMO main-path lanes",
                              every_lane=True, regen=False)
    x4 = cornell_x4(sky=False)
    x4_tables = SceneTables.from_pack(x4.compile(cluster_threshold=8), device="cuda")
    check(x4_tables.use_bvh and not x4_tables.use_env, "the x4 Cornell tables: BVH, no env")
    x4_cam = dataclasses.replace(x4.camera, width=384, height=384)
    kernel_vs_plain(x4_tables, dataclasses.replace(x4.camera, width=64, height=48), 8, 6, 11,
                    "(h1) x4 Cornell small", every_lane=True, regen=False)
    at_bvh = kernel_vs_plain(x4_tables, x4_cam, 2, 8, 3, "(h1) x4 Cornell lanes",
                             every_lane=True, regen=False)
    phase("h1", f"{time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    reset_counts()
    img, stats = render_mega(pack, sc.camera, 256, seed=0, max_bounces=8, device="cuda",
                             regen=False)
    launches = dict(mk.trace_block.by_instance)
    check(launches.get("mega_lockstep<4, false>", 0) > 0,
          f"the lockstep main path launched {launches}")
    check(img.shape == (384, 384, 3) and bool(np.isfinite(img).all()), "lockstep image")
    d_mean, corr, quad, tile = golden(img)
    blocks = lambda x: x.reshape(12, 32, 12, 32, 3).mean(axis=(1, 3)).ravel()

    def vs_regen(a, b):
        rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
        return rel, float(np.corrcoef(blocks(a), blocks(b))[0, 1])

    # held as displayed (pixels clipped to [0, 1]): both kernels keep the
    # reference's unclamped Russian-roulette early return, whose rare
    # grazing-light samples reach -2e5 (one pixel of a 384x384 spp 256
    # render averaged -828: PERF.md), which no mean of 256 samples absorbs
    rel_raw, corr_raw = vs_regen(img, regen_img)
    rel, corr_rg = vs_regen(np.clip(img, 0.0, 1.0), np.clip(regen_img, 0.0, 1.0))
    phase("h2", f"lockstep 384x384 spp 256 mb 8: {stats['elapsed_s']:.3f} s, {stats['rays']} "
                f"rays, {stats['rays_per_s']:.4e} rays/s, launches {launches}; vs reference: "
                f"channel mean diff {np.round(d_mean, 3).tolist()} (|.|<6.5), corr {corr:.4f} "
                f"(>0.9), quadrant {quad:.3f} (<6.5), tile {tile:.3f} (<24); vs phase 4's regen "
                f"image in [0, 1]: means {float(np.clip(img, 0, 1).mean()):.5f} vs "
                f"{float(np.clip(regen_img, 0, 1).mean()):.5f}, relative diff {rel:.5f} (<0.01), "
                f"12x12 block-mean correlation {corr_rg:.6f} (>0.99); unclipped: relative diff "
                f"{rel_raw:.5f}, correlation {corr_raw:.5f}, lowest pixels lockstep "
                f"{float(img.min()):.4g}, regen {float(regen_img.min()):.4g}")
    check(np.abs(d_mean).max() < 6.5 and corr > 0.9 and quad < 6.5 and tile < 24.0,
          "lockstep 384x384 image outside tests/test_golden.py bounds")
    check(rel < 0.01 and corr_rg > 0.99, "the lockstep and regen images disagree")
    device_profile("(h2) lockstep DEMO 384x384 spp 256 mb 8", lambda: render_mega(
        pack, sc.camera, 256, seed=1, max_bounces=8, device="cuda", regen=False),
        kernel="mega_lockstep")
    per_launch = ms_per_launch(lambda: render_mega(
        pack, sc.camera, 256, seed=2, max_bounces=8, device="cuda", regen=False))

    reset_counts()
    img_x4, st_x4 = render_mega(x4_tables, x4_cam, 16, seed=0, max_bounces=8, device="cuda",
                                regen=False)
    bvh_launches = dict(mk.trace_block.by_instance)
    check(bvh_launches.get("mega_lockstep<4, true>", 0) > 0,
          f"the x4 Cornell lockstep render launched {bvh_launches}")
    check(bool(np.isfinite(img_x4).all()) and float(img_x4.mean()) > 0.0, "x4 Cornell image")
    bvh_per_launch = ms_per_launch(lambda: render_mega(
        x4_tables, x4_cam, 16, seed=1, max_bounces=8, device="cuda", regen=False))
    phase("h2", f"x4 Cornell lockstep 384x384 spp 16 mb 8: {st_x4['elapsed_s']:.3f} s, "
                f"{st_x4['rays']} rays, launches {bvh_launches}, image mean "
                f"{float(img_x4.mean()):.4f}; {time.monotonic() - t0:.1f} s")
    return ((launches["mega_lockstep<4, false>"], at_demo, per_launch),
            (bvh_launches["mega_lockstep<4, true>"], at_bvh, bvh_per_launch))


def stride_equivalence(pack):
    """(h4): the lane-strided sharded render on one card, bitwise against
    the single render, then over every card."""
    t0 = time.monotonic()
    cam = demo_scene().camera
    tables = SceneTables.from_pack(pack, device="cuda")
    for regen in (True, False):
        single, s1 = render_mega(tables, cam, 4, seed=7, max_bounces=8, device="cuda",
                                 regen=regen)
        sharded, s4 = render_mega_sharded(tables, cam, 4, seed=7, devices=["cuda:0"] * 4,
                                          max_bounces=8, regen=regen)
        same = bool(np.array_equal(single, sharded))
        phase("h4", f"regen={regen}: ['cuda:0'] x 4 vs one launch set: image equal {same}, "
                    f"rays {s4['rays']} vs {s1['rays']}, per-device rays "
                    f"{s4['per_device_rays']}, pad lanes {s4['pad_lanes']}")
        check(same and s4["rays"] == s1["rays"], f"stride equivalence fails (regen={regen})")
    img, st = render_mega_sharded(pack, cam, 4, seed=7, max_bounces=8)
    check(bool(np.isfinite(img).all()), "sharded image")
    phase("h4", f"devices=None: {st['devices']} device(s), {st['rays']} rays, per-device rays "
                f"{st['per_device_rays']}, pad lanes {st['pad_lanes']}, "
                f"{st['elapsed_s']:.3f} s; {time.monotonic() - t0:.1f} s")


def many_samples():
    """(i): both kernels' flat per-vertex loop at many samples a lane, where
    every lane ends and restarts many paths, bitwise against the plain
    versions on every lane."""
    t0 = time.monotonic()
    demo = demo_scene()
    tables = SceneTables.from_pack(demo.compile(), device="cuda")
    cam96 = dataclasses.replace(demo.camera, width=96, height=96)
    for regen in (True, False):
        kernel_vs_plain(tables, cam96, 8, 8, 21, "(i) DEMO many samples", every_lane=True,
                        regen=regen)
    for regen in (True, False):
        x4 = cornell_x4(sky=regen)  # the lockstep kernel takes no env map
        x4_tables = SceneTables.from_pack(x4.compile(cluster_threshold=8), device="cuda")
        kernel_vs_plain(x4_tables, x4.camera, 8, 8, 21, "(i) x4 Cornell many samples",
                        every_lane=True, regen=regen)
    phase("i", f"{time.monotonic() - t0:.1f} s")


def any_light_count():
    """(j): 40 light samples a vertex through both kernels and the CLI."""
    t0 = time.monotonic()
    # the x4 box at 32x24: its plain version walks the BVH at 40 rays a fan
    for name, sc, threshold, w, h in (("DEMO", demo_scene(), 1024, 64, 48),
                                      ("x4 Cornell", cornell_x4(sky=False), 8, 32, 24)):
        sc.n_dir_sample = 40
        tables = SceneTables.from_pack(sc.compile(cluster_threshold=threshold), device="cuda")
        for regen in (True, False):
            kernel_vs_plain(tables, dataclasses.replace(sc.camera, width=w, height=h), 2, 6, 11,
                            f"(j) {name} 40 light samples", every_lane=True, regen=regen)
            want = (f"mega_regen<-32, false, {str(tables.use_bvh).lower()}>" if regen
                    else f"mega_lockstep<-32, {str(tables.use_bvh).lower()}>")
            check(mk.trace_block.last_instance == want,
                  f"(j) launched {mk.trace_block.last_instance}, not {want}")
    from mcpt_tpu_torch.__main__ import main as cli

    with tempfile.TemporaryDirectory() as d:
        write_stand_in_models(d)
        conf = json.loads((ROOT / "conf.json").read_text())
        conf["scene"]["directLightSample"] = 40
        conf["scene"]["envMap"] = str(SKY)
        Path(d, "conf.json").write_text(json.dumps(conf))
        reset_counts()
        cli(["--conf", str(Path(d, "conf.json")), "--models-dir", d, "--no-strict-parity",
             "--width", "384", "--height", "216", "--spp", "1", "--out", str(Path(d, "j.png"))])
        img = read_png(Path(d, "j.png"))
    launches = dict(mk.trace_block.by_instance)
    check(launches.get("mega_regen<-32, true, true>", 0) > 0, f"(j) the CLI launched {launches}")
    check(img.shape[:2] == (216, 384), f"(j) image {img.shape}")
    phase("j", f"CLI --conf --no-strict-parity, directLightSample 40, 384x216 spp 1: launches "
               f"{launches}, image mean {float(img[:, :, :3].mean()):.2f}/255; "
               f"{time.monotonic() - t0:.1f} s")


class CheckedAdam(torch.optim.Adam):
    """Adam (lr 1e-2, the train step's default) that first checks every
    gradient it is handed for NaN and infinities and keeps the last ones."""

    def step(self, closure=None):
        self.seen = [p.grad.detach().clone() for g in self.param_groups for p in g["params"]]
        check(all(bool(torch.isfinite(g).all()) for g in self.seen),
              f"a non-finite gradient: {self.seen}")
        return super().step(closure)


def synced_s(fn):
    """Host seconds of fn() up to a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    return time.monotonic() - t0


def train_cell(label, host, cam, ids, spp, mb, steps, profile=False):
    """make_train_step of `host` at `cam` over the pixel ids `ids` (spp, mb,
    method auto, Adam checking its gradients), toward half the megakernel's
    image: `steps` steps, the last `steps - 1` timed, then one forward
    render under torch.no_grad and one with autograd recording; with
    `profile`, one more step under torch.profiler."""
    n_pix = cam.width * cam.height
    img, _ = render_mega(host, cam, 16, seed=9, max_bounces=mb, device=DEV)
    target = 0.5 * img.reshape(n_pix, 3)
    init_fn, step = diff.make_train_step(host, cam, target, CheckedAdam, spp=spp,
                                         max_bounces=mb, method="auto", device=DEV)
    params, opt = init_fn()
    start = [p.detach().clone() for p in params]
    ids = ids.to(DEV)
    losses, walls = [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for k in range(steps):
        walls.append(synced_s(lambda: losses.append(float(step(
            params, opt, ids, prng.key(k, DEV))[2]))))
    by_mode = dict(ip.intersect_prims_c.by_mode)
    rays = dict(ip.intersect_prims_c.rays_by_mode)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(by_mode.get("nearest", 0) > 0 and by_mode.get("occlusion fan", 0) > 0,
          f"{label}: the train step launched {by_mode}")
    halves = {k: v for k, v in wf.calls.items() if k[0] != "camera_rays"}
    bwd = {k: wf.launches[k] for k in wf.BWD_KERNELS}
    check(set(r for _, r in halves) == {"cuda"} and all(wf.launches[k] > 0 for k in wf.KERNELS[1:])
          and all(bwd.values()), f"{label}: the train step's halves ran {halves}, "
                                 f"launching {dict(wf.launches)}")
    check(all(np.isfinite(losses)), f"{label}: losses {losses}")
    check(any(bool((a.detach() != b).any()) for a, b in zip(params, start)),
          f"{label}: no parameter moved")
    gnorm = [float(g.abs().max()) for g in opt.seen]
    (pack, meth), = replicate_pack(host, [DEV]).values()
    p = diff.SceneParams(*(x.detach() for x in params))
    with torch.no_grad():
        fwd = synced_s(lambda: diff.render_lanes(diff.apply_params(pack, p), cam, ids,
                                                 prng.key(7, DEV), spp=spp,
                                                 max_bounces=mb, method=meth))
    leaves = diff.SceneParams(*(x.detach().requires_grad_() for x in params))
    graph = synced_s(lambda: diff.render_lanes(diff.apply_params(pack, leaves), cam, ids,
                                               prng.key(7, DEV), spp=spp, max_bounces=mb,
                                               method=meth))
    calls = {f"{n} {r}": v for (n, r), v in sorted(wf.calls.items())}
    fb_ms = statistics.median(walls[1:]) * 1e3 / spp
    phase("k", f"{label}: {ids.numel()} pixels ({3 * ids.numel()} lanes), spp {spp} mb {mb}, "
               f"{steps} Adam steps: walls {[round(w, 4) for w in walls]} s, losses "
               f"{[round(x, 6) for x in losses]}; fwd {fwd * 1e3 / spp:.1f} ms/spp "
               f"(torch.no_grad), {graph * 1e3 / spp:.1f} ms/spp recording the graph; fwd+bwd "
               f"{fb_ms:.1f} ms/spp (median of the steps after the first), bwd/fwd "
               f"{(fb_ms - fwd * 1e3 / spp) / (fwd * 1e3 / spp):.3f} against torch.no_grad, "
               f"{(fb_ms - graph * 1e3 / spp) / (graph * 1e3 / spp):.3f} against the recording "
               f"forward; peak memory {peak:.2f} GB (torch.cuda.max_memory_allocated); the last "
               f"gradients' largest magnitudes {[round(g, 6) for g in gnorm]}, none NaN; K2 "
               f"launches {by_mode}, rays {rays}; wavefront calls by route {calls} over "
               f"{steps} steps; backward kernel launches {bwd}")
    if profile:
        device_profile(f"{label} one train step", lambda: step(params, opt, ids,
                                                               prng.key(11, DEV)),
                       kernel=tuple(k + "_kernel" for k in wf.BWD_KERNELS),
                       count=lambda: sum(wf.launches[k] for k in wf.BWD_KERNELS))
    del step, opt, params
    torch.cuda.empty_cache()
    return {k: v // steps for k, v in bwd.items()}


def card_vs_cpu():
    """(k2): the train step's loss and gradients at 64x48, spp 2, mb 4 on the
    card (K2) and on the CPU (its plain version), as tests/test_torch_diff.py
    holds the port to JAX: radiance entries beyond 1e-5 relative (flips)
    weigh 0 in the loss on both sides, at most 2% of the paths; gradient
    elements within 1e-3 relative or 1e-5 of their field's largest."""
    sc = demo_scene()
    host = sc.compile()
    cam = dataclasses.replace(sc.camera, width=64, height=48)
    n = cam.width * cam.height
    target = np.random.default_rng(3).uniform(0.0, 0.5, (n, 3)).astype(np.float32)
    runs = {}
    for dev, meth in ((DEV, "auto"), ("cpu", "kernel")):
        pack, meth = replicate_pack(host, [dev], meth)[torch.device(dev)]
        runs[dev] = (pack, meth)

    def grads(dev, weight):
        pack, meth = runs[dev]
        p = diff.SceneParams(*(x.requires_grad_() for x in diff.params_from_pack(host, dev)))
        fb = diff.render_lanes(diff.apply_params(pack, p), cam, torch.arange(n, device=dev),
                               prng.key(3, dev), spp=2, max_bounces=4, method=meth)
        w = torch.from_numpy(weight).to(dev)
        loss = torch.mean(w * (fb - torch.from_numpy(target).to(dev)) ** 2)
        g = torch.autograd.grad(loss, list(p))
        return float(loss), fb.detach().cpu().numpy(), [x.cpu().numpy() for x in g]

    reset_counts()
    ones = np.ones_like(target)
    _, fb_gpu, _ = grads(DEV, ones)
    check(ip.intersect_prims_c.by_mode.get("occlusion fan", 0) > 0, "(k2) no K2 launch")
    _, fb_cpu, _ = grads("cpu", ones)
    rel = np.abs(fb_gpu - fb_cpu) / np.maximum(np.abs(fb_cpu), 1e-30)
    flipped = rel > 1e-5
    share = float(flipped.sum()) / (flipped.size * 2)
    check(share <= 0.02, f"(k2) {share:.4f} of the paths flipped between card and CPU")
    weight = (~flipped).astype(np.float32)
    (l_gpu, _, g_gpu), (l_cpu, _, g_cpu) = grads(DEV, weight), grads("cpu", weight)
    worst_rel = worst_floor = 0.0
    for f, a, b in zip(diff.SceneParams._fields, g_gpu, g_cpu):
        check(np.isfinite(a).all(), f"(k2) non-finite gradient {f}")
        top, err = np.abs(b).max(initial=0.0), np.abs(a - b)
        check(np.all(err <= np.maximum(1e-3 * np.abs(b), 1e-5 * top)),
              f"(k2) {f}: card {a} against CPU {b}")
        big = np.abs(b) > 1e-6 * top
        if big.any():
            worst_rel = max(worst_rel, float((err[big] / np.abs(b)[big]).max()))
            worst_floor = max(worst_floor, float(err.max() / top))
    loss_err = abs(l_gpu - l_cpu) / l_cpu
    check(loss_err <= 1e-5, f"(k2) loss {l_gpu} on the card against {l_cpu} on the CPU")
    phase("k", f"(k2) card against CPU, 64x48 spp 2 mb 4: flipped entries {int(flipped.sum())} "
               f"of {flipped.size} ({share:.4f} of the paths), radiance "
               f"{float(rel[~flipped].max()):.3g} relative elsewhere; loss {loss_err:.3g} "
               f"relative; gradients {worst_rel:.3g} relative, {worst_floor:.3g} of the field's "
               f"largest (bounds 1e-3, 1e-5)")


def pre_bwd_bytes(pack, b, s):
    """shade_pre_bwd's bytes for b lanes at s light samples: in, a lane's
    ray, hit, flags, channel, key, its 10 seeds and each sample's; out, its
    o and d adjoints, its material row's adjoint and each sample's emitter
    row's, with their ids; the tables read once."""
    return b * (53 + 40 + 4 * s + 24 + 13 * 4 + 8 + s * (17 * 4 + 8)) + 16 + vertex_tables(pack)


def vertex_at_step(sc):
    """shade_pre and shade_pre_bwd at the (k1) step's 442,368 lanes (the
    384x384 DEMO's depth-0 vertices, the next ray's seeds given): each timed
    as `kernel_row` times them, the rows printed only."""
    pack = pack_to(sc.compile(), DEV)
    key = prng.key(22, DEV)
    px = sc.camera.width * sc.camera.height
    o, d = wf.camera_rays(sc.camera, torch.arange(px, device=DEV), key, 3)
    b, s = o[0].numel(), wfr.n_samples(pack)
    chan = torch.arange(b, device=DEV) % 3
    lam = torch.tensor(WAVELEN_UM, dtype=torch.float32, device=DEV)[chan]
    alive = torch.ones(b, dtype=torch.bool, device=DEV)
    hit = intersect_c(pack, o, d)
    args = (pack, o, d, hit, alive, 0, key, lam, chan)
    gen = torch.Generator(device=DEV).manual_seed(6)
    grads = {k: torch.randn(b, generator=gen, device=DEV) for k in (*wfr.RAY_OUT, *wfr.LEAF_OUT)}
    grads["contrib"] = torch.randn(s * b, generator=gen, device=DEV)
    label = f"(k5) DEMO {sc.camera.width}x{sc.camera.height}, {b} lanes"
    kernel_row(label, "shade_pre", lambda: wf.shade_pre(*args), lambda: wfr.shade_pre(*args),
               None, vertex_bytes(pack, b, s), iops=vertex_iops(b, s))
    kernel_row(label, "shade_pre_bwd", lambda: wf.shade_pre_bwd_rows(*args, grads),
               lambda: wfr.shade_pre_bwd(*args, grads), None, pre_bwd_bytes(pack, b, s),
               iops=vertex_iops(b, s))


def backward_kernels(train_launches):
    """(k5): the three backward kernels bitwise against their plain versions
    at a tile's depth-0 shapes (196,608 lanes, the next ray's seeds given;
    `shade_pre_bwd` also at the depth 1-3 vertices of the tile's paths),
    on the DEMO (timed with a cold L2: `kernel_row`), the sky-lit DEMO, the
    DEMO at 40 light samples and the DEMO through a thin lens with an
    emissive sphere; then two train steps' gradients, bitwise equal.
    Returns {kernel: (launches in a (k1) step, measurements)}."""
    t0 = time.monotonic()
    sky = demo_scene()
    sky.load_env_map(SKY)
    forty = demo_scene()
    forty.n_dir_sample = 40
    rows = {}
    for label, sc in (("(k5) DEMO", demo_scene()), ("(k5) sky-lit DEMO", sky),
                      ("(k5) DEMO, 40 light samples", forty),
                      ("(k5) DEMO, thin lens and an emissive sphere", lens_lamp_demo())):
        pack = pack_to(sc.compile(), DEV)
        cam = dataclasses.replace(sc.camera, width=TILE_SIDE, height=TILE_SIDE)
        key = prng.key(21, DEV)
        o, d = wf.camera_rays(cam, torch.arange(TILE_PX, device=DEV), key, 3)
        b = o[0].numel()
        chan = torch.arange(b, device=DEV) % 3
        lam = torch.tensor(WAVELEN_UM, dtype=torch.float32, device=DEV)[chan]
        alive = torch.ones(b, dtype=torch.bool, device=DEV)
        hit = intersect_c(pack, o, d)
        pre = wf.shade_pre(pack, o, d, hit, alive, 0, key, lam, chan)
        s = wfr.n_samples(pack)
        gen = torch.Generator(device=DEV).manual_seed(5)
        grads = {k: torch.randn(b, generator=gen, device=DEV)
                 for k in (*wfr.RAY_OUT, *wfr.LEAF_OUT)}
        grads["contrib"] = torch.randn(s * b, generator=gen, device=DEV)
        args = (pack, o, d, hit, alive, 0, key, lam, chan, grads)
        got = wf.shade_pre_bwd(*args, route="cuda")
        want = wf.shade_pre_bwd(*args, route="plain")
        for name, g, w in zip(("g_o", "g_d"), got[:2], want[:2]):
            for k in range(3):
                same_bits(label, f"shade_pre_bwd {name}{k}", g[k], w[k])
        same_bits(label, "shade_pre_bwd g_mat", got[2], want[2])
        same_bits(label, "shade_pre_bwd g_emt", got[3], want[3])
        # the next bounces' vertices (refraction, total internal reflection,
        # dead lanes), where a lane's reverse takes other blocks
        rec_d = wfr.new_records(4, b, DEV)
        rays_d = torch.zeros((), dtype=torch.int64, device=DEV)
        pre_d = pre
        for depth in range(1, 4):
            sh = (occlude_t_c(pack, pre_d.p_dl, pre_d.ws, fan=s) if s and pack.enable_shadow
                  else None)
            nxt = intersect_c(pack, pre_d.p_new, pre_d.wi)
            alive_d = wf.shade_post(pack, pre_d, sh, nxt.prim, rec_d, depth - 1, rays_d)
            args_d = (pack, pre_d.p_new, pre_d.wi, nxt, alive_d, depth, key, lam, chan)
            for name, g, w in zip(("g_o", "g_d", "g_mat", "g_emt"),
                                  wf.shade_pre_bwd(*args_d, grads, route="cuda"),
                                  wf.shade_pre_bwd(*args_d, grads, route="plain")):
                same_bits(label, f"depth {depth} shade_pre_bwd {name}", g, w)
            pre_d = wf.shade_pre(*args_d)
        sh_t = occlude_t_c(pack, pre.p_dl, pre.ws, fan=s) if s and pack.enable_shadow else None
        g3 = [torch.randn(b, generator=gen, device=DEV) for _ in range(3)]
        post = (pre, sh_t, s, *g3)
        for name, g, w in zip(("g_contrib", "g_fac", "g_leaf_pre", "g_env_c", "g_w"),
                              wf.shade_post_bwd(*post, route="cuda"),
                              wf.shade_post_bwd(*post, route="plain")):
            same_bits(label, f"shade_post_bwd {name}", g, w)
        depth = TRAIN_MB
        rec = wfr.Records(torch.randn((depth, b), generator=gen, device=DEV) * 4,
                          torch.rand((depth, b), generator=gen, device=DEV) * 3,
                          torch.rand((depth, b), generator=gen, device=DEV) * 6,
                          torch.rand((depth, b), generator=gen, device=DEV) < 0.3)
        g_rad = torch.randn(b, generator=gen, device=DEV)
        for name, g, w in zip(("g_l_dir", "g_w", "g_leaf"), wf.fold_bwd(rec, g_rad, route="cuda"),
                              wf.fold_bwd(rec, g_rad, route="plain")):
            same_bits(label, f"fold_bwd {name}", g, w)
        phase("k", f"{label}: shade_pre_bwd (at depths 0-3), shade_post_bwd and fold_bwd "
                   f"bitwise equal to their plain versions at {b} lanes, {s} light samples")
        if rows:
            continue
        rows["shade_pre_bwd"] = kernel_row(
            label, "shade_pre_bwd", lambda: wf.shade_pre_bwd_rows(*args),
            lambda: wfr.shade_pre_bwd(*args), None, pre_bwd_bytes(pack, b, s),
            iops=vertex_iops(b, s))
        vertex_at_step(sc)
        post_bytes = b * (12 * s + 4 + 2 + 12 + 4 * s + 16)
        rows["shade_post_bwd"] = kernel_row(
            label, "shade_post_bwd", lambda: wf.shade_post_bwd(*post, route="cuda"),
            lambda: wfr.shade_post_bwd(*post), b * (5 * s + 12), post_bytes)
        rows["fold_bwd"] = kernel_row(
            label, "fold_bwd", lambda: wf.fold_bwd(rec, g_rad, route="cuda"),
            lambda: wfr.fold_bwd(rec, g_rad), b * depth * 14, b * (depth * 25 + 4))
    # two steps' gradients, bitwise
    sc = demo_scene()
    host = sc.compile()
    cam = dataclasses.replace(sc.camera, width=128, height=128)
    (pack, meth), = replicate_pack(host, [DEV]).values()
    runs = []
    for _ in range(2):
        p = diff.SceneParams(*(x.requires_grad_() for x in diff.params_from_pack(host, DEV)))
        fb = diff.render_lanes(diff.apply_params(pack, p), cam,
                               torch.arange(128 * 128, device=DEV), prng.key(4, DEV), spp=2,
                               max_bounces=TRAIN_MB, method=meth)
        runs.append(torch.autograd.grad(((fb - 0.3) ** 2).mean(), list(p)))
    for f, a, b2 in zip(diff.SceneParams._fields, *runs):
        same_bits("(k5) two train steps", f"gradient {f}", a, b2)
    phase("k", f"(k5) two train steps' gradients (DEMO 128x128, spp 2, mb {TRAIN_MB}) bitwise "
               f"equal; {time.monotonic() - t0:.1f} s")
    check(all(train_launches.get(k, 0) > 0 for k in rows),
          f"(k5) a backward kernel took no launch in the (k1) step: {train_launches}")
    return {k: (train_launches.get(k, 0), m) for k, m in rows.items()}


def training_path():
    """(k): the training path on the card (see the module docstring)."""
    t0 = time.monotonic()
    sc = demo_scene()
    host = sc.compile()
    k1 = train_cell("(k1) DEMO 384x384", host, sc.camera,
                    torch.arange(sc.camera.width * sc.camera.height), TRAIN_SPP, TRAIN_MB, 3,
                    profile=True)
    card_vs_cpu()
    cam = dataclasses.replace(sc.camera, width=1920, height=1080)
    train_cell("(k3) DEMO 1920x1080, first pixels", host, cam, torch.arange(MILLION_PIXELS),
               TRAIN_SPP, TRAIN_MB, 2, profile=True)

    target, _ = render_mega(host, sc.camera, 64, seed=5, max_bounces=TRAIN_MB, device=DEV)
    init_fn, step = diff.make_train_step_hybrid(host, sc.camera, 0.5 * target, spp_res=64,
                                                spp_grad=TRAIN_SPP, max_bounces=TRAIN_MB,
                                                device=DEV)
    params, opt = init_fn()
    step(params, opt, prng.key(0, DEV), 0)  # warm
    step.timer.totals.clear()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    wall = synced_s(lambda: step(params, opt, prng.key(1, DEV), 1))
    peak = torch.cuda.max_memory_allocated() / 1e9
    mega = dict(mk.trace_block.by_instance)
    k2 = dict(ip.intersect_prims_c.by_mode)
    check(mega.get("mega_regen<4, false, false>", 0) > 0 and k2.get("occlusion fan", 0) > 0,
          f"(k4) the hybrid step launched {mega} and {k2}")
    routes = {r for (_, r) in wf.calls}
    check(routes == {"cuda"} and all(wf.launches[k] for k in wf.BWD_KERNELS),
          f"(k4) the hybrid step's wavefront calls {dict(wf.calls)}")
    split = {k: round(v, 4) for k, v in step.timer.totals.items()}
    phase("k", f"(k4) hybrid step, DEMO 384x384, spp_res 64, spp_grad {TRAIN_SPP}, mb "
               f"{TRAIN_MB}: wall {wall:.4f} s, split {split} s (render: K1 and the residual; "
               f"vjp: the pull-back and Adam); peak memory {peak:.2f} GB; K1 launches {mega}, "
               f"K2 launches {k2}, wavefront launches {dict(wf.launches)}")
    device_profile("(k4) one hybrid step", lambda: step(params, opt, prng.key(2, DEV), 2),
                   kernel=tuple(k + "_kernel" for k in wf.BWD_KERNELS),
                   count=lambda: sum(wf.launches[k] for k in wf.BWD_KERNELS))
    del step, opt, params
    torch.cuda.empty_cache()

    bwd = backward_kernels(k1)
    t1 = time.monotonic()
    reset_counts()
    dryrun_multichip(4)  # on ["cuda:0"] * 4 where the host has fewer than 4 cards
    routes = {r for (_, r) in wf.calls}
    check("plain (autograd)" not in routes and all(wf.launches[k] for k in wf.BWD_KERNELS),
          f"(k7) dryrun_multichip's wavefront calls {dict(wf.calls)}")
    phase("k", f"(k7) dryrun_multichip(4), {torch.cuda.device_count()} card(s): passed in "
               f"{time.monotonic() - t1:.1f} s, wavefront launches {dict(wf.launches)}")
    with tempfile.TemporaryDirectory() as d:
        reset_counts()
        img, st = render_radiance(sc, sc.camera, 1, 0, max_bounces=8, device=DEV, trace_dir=d)
        trace = Path(d) / TRACE_FILE
        check(trace.exists(), "(k6) no trace written")
        events = json.loads(trace.read_text())["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        check(any("intersect_" in e.get("name", "") for e in kern),
              "(k6) the trace holds no intersector kernel")
        phase("k", f"(k6) render_radiance 384x384 spp 1 mb 8 with trace_dir: {trace.name} "
                   f"{trace.stat().st_size / 1e6:.1f} MB, {len(events)} events, {len(kern)} "
                   f"device kernels; render {st['elapsed_s']:.3f} s")
    phase("k", f"{time.monotonic() - t0:.1f} s")
    return bwd


def main():
    t0 = time.monotonic()
    environment()
    build_s = build()
    pack = demo_scene().compile()
    tables = SceneTables.from_pack(pack, device="cuda")
    t1 = time.monotonic()
    kernel_vs_plain(tables, dataclasses.replace(demo_scene().camera, width=64, height=48),
                    8, 6, 11, "small")
    at_main = kernel_vs_plain(tables, demo_scene().camera, 2, 8, 3, "main-path lanes")
    phase("kernel", f"{time.monotonic() - t1:.1f} s")
    t1 = time.monotonic()
    launches, mega_img, main_per_launch = main_path(pack)
    phase("main", f"{time.monotonic() - t1:.1f} s")
    t1 = time.monotonic()
    regen_rate = throughput(tables)
    phase("perf", f"{time.monotonic() - t1:.1f} s")
    at_env, env_launches, env_per_launch = env_and_bvh_vs_plain()
    bvh_vs_smem()
    conf_launches, at_conf, conf_per_launch = conf_path(build_s)
    with tempfile.TemporaryDirectory() as models:
        soldier = soldier_demo(models)
    at_prims = intersect_kernels(soldier)
    at_deep = deep_trees()
    wf_main, soldier_launches, _ = wavefront_path(mega_img, soldier)
    at_wf = wavefront_kernels(soldier)
    ls_demo, ls_bvh = lockstep_path(pack, mega_img)
    t1 = time.monotonic()
    throughput(tables, regen=False, earlier=("the regen kernel, phase 5", regen_rate))
    phase("h3", f"{time.monotonic() - t1:.1f} s")
    stride_equivalence(pack)
    many_samples()
    any_light_count()
    at_bwd = training_path()
    phase("total", f"{time.monotonic() - t0:.1f} s")
    for name, per_launch in (("mega_regen<4, false, false>", main_per_launch),
                             ("mega_regen<4, true, false>", env_per_launch),
                             ("mega_regen<4, true, true>", conf_per_launch),
                             ("mega_lockstep<4, false>", ls_demo[2]),
                             ("mega_lockstep<4, true>", ls_bvh[2])):
        phase("launch", f"{name}: device ms per launch in its main-path render "
                        f"{per_launch:.3f} (CUDA events)")
    for m in (at_main, at_env, at_conf, ls_demo[1], ls_bvh[1]):
        info = m["info"]
        phase("occupancy", f"{info['instance']}: {info['registers']} registers, "
                           f"{info['local_bytes']} local bytes, {info['threads']} threads a "
                           f"block, {info['blocks_per_sm']} resident blocks per SM "
                           f"({info['blocks_per_sm'] * info['threads'] // 32} of 64 warps), "
                           f"{info['smem_bytes']} bytes of shared memory a block")
    print(card(), flush=True)
    src = "mcpt_tpu_torch/csrc/megakernel.cu"
    rows = [
        ("mega_regen<4, false, false>", src, "mcpt_tpu/kernels/megakernel.py:1860", launches,
         at_main),
        ("mega_regen<4, true, false> (env lookup)", src, "mcpt_tpu/kernels/megakernel.py:241",
         env_launches, at_env),
        ("mega_regen<4, true, true> (BVH walks)", src, "mcpt_tpu/kernels/cluster.py:835",
         conf_launches, at_conf),
    ]
    src = "mcpt_tpu_torch/csrc/mega_lockstep.cu"
    for name, (n, at, _) in (("mega_lockstep<4, false>", ls_demo),
                             ("mega_lockstep<4, true> (BVH walks)", ls_bvh)):
        rows.append((name, src, "mcpt_tpu/kernels/megakernel.py:1579", n, at))
    src = "mcpt_tpu_torch/csrc/intersect_prims.cu"
    k2 = "mcpt_tpu/kernels/intersect_pallas.py:326"
    k3 = "mcpt_tpu/kernels/intersect_pallas.py:135"
    for mode, replaces, counts in (("nearest", k2, wf_main["modes"]),
                                   ("occlusion", k2, wf_main["modes"]),
                                   ("occlusion fan", k2, wf_main["modes"]),
                                   ("nearest tiled", k3, soldier_launches),
                                   ("occlusion tiled", k3, soldier_launches),
                                   ("occlusion fan tiled", k3, soldier_launches),
                                   ("nearest walk", k3, soldier_launches),
                                   ("occlusion walk", k3, soldier_launches)):
        rows.append((f"intersect_prims<{mode}>", src, replaces, counts.get(mode, 0),
                     at_prims[mode]))
    # no render launches the triangles-only entry (K4 has no render path)
    rows.append(("intersect_prims<tris>", src, "mcpt_tpu/kernels/intersect_pallas.py:53", 0,
                 at_prims["tris"]))
    # no Pallas kernel: the JAX code XLA compiles under jit that each replaces
    src = "mcpt_tpu_torch/csrc/wavefront.cu"
    for name, replaces in (("camera_rays", "mcpt_tpu/camera.py:55"),
                           ("shade_pre", "mcpt_tpu/integrator.py:200"),
                           ("shade_post", "mcpt_tpu/integrator.py:266"),
                           ("fold", "mcpt_tpu/integrator.py:347")):
        rows.append((name, src, replaces, wf_main["kernels"][name], at_wf[name]))
    # the deep trees' instances: the walks of the same clustered kernels
    for name, (n, m) in at_deep.items():
        stem = ("intersect_prims" if name.startswith("intersect")
                else "megakernel" if "regen" in name else "mega_lockstep")
        src = f"mcpt_tpu_torch/csrc/{stem}.cu"
        replaces = k3 if name.startswith("intersect") else "mcpt_tpu/kernels/cluster.py:835"
        rows.append((name, src, replaces, n, m))
    # no Pallas kernel: the backward XLA compiles under jax.value_and_grad
    for name, (n, m) in at_bwd.items():
        rows.append((name, "mcpt_tpu_torch/csrc/wavefront_bwd.cu", "mcpt_tpu/diff.py:136", n, m))
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": n, "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
        "library_ms": None,
    } for name, source, replaces, n, m in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
