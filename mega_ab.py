"""Old-against-new timing of the two megakernels (in one process) and of the
wavefront intersector and render (a process per turn) on one GPU:
`python3 mega_ab.py --parent _checkout/parent [--tree NAME=DIR ...]`.

`--parent DIR` holds another tree (for example the parent commit, unpacked
with `git archive <commit> | tar -x -C _checkout/parent`; `_checkout/` is
git-ignored); each `--tree NAME=DIR` one more tree to time beside it (a
design tried). Each tree's `csrc/megakernel.cu` and `csrc/mega_lockstep.cu`
build with nvcc (the library build's flags; every nvcc started together)
into `mcpt_tpu_torch/_build/ab/<tree>/`, and each tree runs on the tables
its own `kernels/tables.py` lays out, passed by its own
`kernels/megakernel.py::kernel_args` (`load_tree`). The script prints every
instance's ptxas line (registers, stack, spills) and, where the tree has the
occupancy query, each timed instance's resident blocks per SM.

Then it times, with CUDA events, each instance's main-path launch as
`chip_smoke.py` makes it, the trees in turns (parent, new, ..., then the
reverse order), `--rounds` times:
- `mega_regen<4, false, false>`: the 384x384 DEMO at spp 256, mb 8, one
  launch (and its compare shape: the same lanes at spp 2);
- `mega_regen<4, true, false>`: the DEMO under assets/sky.png, spp 64;
- `mega_regen<4, true, true>`: the --conf 1080p render on the stand-in
  meshes, spp 32, its six 2^20-lane launches (ms per launch), and its
  compare shape (`chip_smoke.py` phase (c)'s block: 384x384x3 lanes from
  `CONF_BLOCK_OFFSET`, spp 1, seed 2);
- `mega_regen<-32, true, true>`: the same render with `--no-strict-parity`,
  which takes conf.json's 32 light samples, at spp 4;
- `mega_lockstep<4, false>`: the 384x384 DEMO at spp 256 (and spp 2);
- `mega_lockstep<4, true>`: the x4 Cornell box at 384x384, spp 16.
and the wavefront shapes, for which each tree runs in a process of its own
(`python -P mega_ab.py --wavefront-turn`, with the tree's root first on the
import path: the wavefront's modules import each other by package name, so
a tree cannot be loaded beside another):
- `wavefront DEMO`: the intersector's sweep (K2) as the wavefront calls it
  (`intersect_c` and `occlude_t_c`, method kernel) at `chip_smoke.py` phase
  (d)'s 786,432 NEE rays of the DEMO, then the render's own shadow batch
  (B = 196,608 first hits with 4 directions each, phase (d)'s fan batch)
  in the fan form (`occlude_t_c(..., fan=4)`; a tree without it takes the
  origins expanded) and in the generic form on the origins expanded, then
  the DEMO's wavefront render at 384x384, spp 8, mb 8, in one tile;
- `wavefront DEMO + soldier`: the intersector (the walk) at phase
  (e)'s 786,432 NEE rays of the DEMO plus one stand-in soldier, on the pack
  as `render_radiance` moves it, then that scene's render at 384x384, spp
  8, mb 8, in one tile;
- `shade_pre`, `shade_pre_bwd`: the vertex kernels alone (the backward with
  the next ray's seeds) at the DEMO's depth-0 vertices of a 256x256 tile
  (196,608 lanes) and of the 384x384 train step (442,368 lanes): each
  tree's wavefront sources built (ptxas lines and build seconds printed),
  the kernel bitwise against the tree's own plain version, then timed
  with the L2 evicted before each launch (the median of 20, `cold_ms`) and
  back to back (the median of 5 means of 10). shade_pre's outputs must
  equal the parent's; shade_pre_bwd's gradients may differ from another
  design's in their last bits, so only its own plain version holds it;
- `shade_post`, `fold`: the bounce's second half at the same two shapes'
  depth-0 bounce (the tree's shade_pre, the fan's t and the next hit), and
  the fold on the records of their 8 bounces traced by the tree's kernels:
  each tree's sources built (ptxas lines printed), the kernel bitwise
  against the tree's own plain version (shade_post's records row, next
  alive and ray count; the radiance), its outputs equal to the parent's,
  then timed cold and back to back as the vertex kernels are; the
  instance a tree's C entry reports it launched is printed where it
  reports one. shade_post also runs on the tile's first 196,605 lanes (an
  odd count: the scalar instance, its sample rows copied off the 8-byte
  grid), and each tree's wrapper's host time a call is timed at 0 lanes
  (the checks and the C entry, which launches nothing: `host_us`);
- `camera_rays`: the camera alone at 65,536 and 147,456 pixels (196,608
  and 442,368 lanes at 3 a pixel), through the DEMO's pinhole at 3 lanes
  and 1 a pixel and conf.json's thin lens at 3, and at 65,535 pixels (at 3
  lanes not a multiple of 4), each bitwise against the tree's own plain
  version and the parent's planes, timed cold and back to back, with the
  instance the tree's C entry reports; each tree's first turn profiles the
  1080p DEMO wavefront render at spp 2 (device ms a camera_rays launch);
- `deep K3`: K3's deep walk (`intersect_walk_deep`, nearest and occlusion)
  at `chip_smoke.py` (d-deep)'s 196,608 rays through the box (the tree's
  own `chip_smoke.deep_rays`, so the parent must be a tree that has it),
  on the chain and the interior-first chain of DEEP_LEVELS (64) levels
  (`chip_smoke.chain_pack`: the same leaves, the walks' stacks at 1 and 63
  entries), each bitwise against the tree's own plain walk and the
  parent's answers, timed cold and back to back.
`--shapes deep` takes `deep K3` and the megakernels' deep instances on the
same two trees: `mega_regen_deep<4, false>` and `mega_lockstep_deep<4>` at
(d-deep)'s launch (2^20 lanes of the 1080p x4 box, spp 1, mb 8; each tree
allocates their stacks with its own `walk_stack`), in this process; each
turn times one launch after a read that evicts the L2 (cold), then three
launches back to back. Medians are printed with their range over the
turns.
Each intersector call is timed with CUDA events (the median of 9 means of
40 launches, queued behind a spin of the device: `queued_ms`), each render by the host's wall clock after a warm-up render
at spp 1; on a tree's first turn the spp 1 render runs under
`chip_smoke.device_profile` (device busy time, idle share and ms a launch
by kernel instance, printed). With `--sass DIR` each tree's first turn also
disassembles its intersector library with the toolkit's `cuobjdump -sass`,
writes it to DIR/<tree>.sass, and counts the instructions of each sweep
kernel's row loop per (ray, row) pair (`sweep_sass`), with the time that
count takes at the card's issue rate.
`--shapes A,B` keeps only those shapes. Every tree's output planes, and its
intersector answers and wavefront image, must equal the parent's bitwise on
every lane, or the script fails. It prints one JSON object as its last line,
and with `--out FILE` writes it there too. `--rounds 0` checks the trees
and times nothing (the wavefront shape runs one turn per tree, for its
check).
"""

import argparse
import concurrent.futures
import ctypes
import dataclasses
import hashlib
import importlib
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke
from mcpt_tpu_torch.bench import card
from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.config import build_scene, load_config
from mcpt_tpu_torch.kernels import build as kbuild
from mcpt_tpu_torch.kernels import megakernel as mk
from mcpt_tpu_torch.kernels.megakernel_ref import cam_static
from mcpt_tpu_torch.render import BLOCK_LANES

ROOT = Path(__file__).resolve().parent
AB_DIR = kbuild.BUILD_DIR / "ab"
SOURCES = {True: ("megakernel.cu", "mcpt_mega_trace"),
           False: ("mega_lockstep.cu", "mcpt_mega_lockstep")}
WAVEFRONT = ("wavefront DEMO", "wavefront DEMO + soldier", "shade_pre", "shade_pre_bwd",
             "shade_post", "fold", "camera_rays", "deep K3")
# the `deep` set: the trees' levels (chip_smoke.chain_pack, the chain and the
# interior-first chain), the megakernels' lanes (the first block of the
# 1080p x4 box, chip_smoke.py (d-deep)'s) and K3's rays (3 tiles of pixels)
DEEP_LEVELS = 64
DEEP_FORMS = ("chain", "interior-first")
# the vertex kernels' and shade_post's and fold's shapes: the DEMO's depth-0
# vertices of a 256x256 tile (196,608 lanes) and of the 384x384 train step
# (442,368 lanes)
VERTEX_SIDES = (256, 384)


KERNEL_MODULES = ("tables", "megakernel", "megakernel_ref")


def load_tree(root):
    """{name: module} of `KERNEL_MODULES` as the tree at `root` has them
    (its `mcpt_tpu_torch/kernels/`), imported apart from this process's own
    `mcpt_tpu_torch`, which is left as it was: each tree lays out its tables
    and passes them to its kernels its own way."""
    def own():
        return [k for k in sys.modules if k == "mcpt_tpu_torch" or k.startswith("mcpt_tpu_torch.")]

    saved = {k: sys.modules.pop(k) for k in own()}
    sys.path.insert(0, str(root))
    try:
        return {m: importlib.import_module(f"mcpt_tpu_torch.kernels.{m}") for m in KERNEL_MODULES}
    finally:
        sys.path.remove(str(root))
        for k in own():
            del sys.modules[k]
        sys.modules.update(saved)


def ptxas(log):
    """{instance: {registers, stack, spill_stores, spill_loads}} of every
    instance in nvcc's -Xptxas -v output."""
    out = {}
    for line in mk.ptxas_summary(log):
        name, rest = line.split(": ", 1)
        num = lambda pat: int(m[1]) if (m := re.search(pat, rest)) else 0
        out[name] = {"registers": num(r"(\d+) registers"), "stack": num(r"(\d+) bytes stack"),
                     "spill_stores": num(r"(\d+) bytes spill stores"),
                     "spill_loads": num(r"(\d+) bytes spill loads")}
    return out


def build_one(tree, regen, csrc):
    """nvcc one source of one tree; returns (library path, ptxas dict)."""
    source, _ = SOURCES[regen]
    out = AB_DIR / tree / f"lib{Path(source).stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
           str(csrc / source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{tree} {source}: nvcc failed\n{res.stderr[-4000:]}")
    return out, ptxas(res.stderr + res.stdout)


class Library:
    """One tree's build of one source, bound with ctypes, with the tree's
    own `kernel_args` (module `mk`)."""

    def __init__(self, path, regen, mk_tree):
        lib = ctypes.CDLL(str(path))
        entry = SOURCES[regen][1]
        self.mk = mk_tree
        self.fn = getattr(lib, entry)
        self.fn.argtypes = [ctypes.c_void_p] * 8
        self.fn.restype = ctypes.c_int
        try:
            self.info_fn = getattr(lib, entry + "_info")
            self.info_fn.argtypes = [ctypes.c_void_p] * 6
            self.info_fn.restype = ctypes.c_int
        except AttributeError:  # a tree from before the query existed
            self.info_fn = None

    def launch(self, tables, cs, seed, lane_offset, spp, n, mb):
        rad = torch.empty(n, dtype=torch.float32, device="cuda")
        rays = torch.empty(n, dtype=torch.float32, device="cuda")
        # a deep tree's walk stacks, as the tree's own trace_block sizes them
        stack = self.mk.walk_stack(tables, n) if hasattr(self.mk, "walk_stack") else None
        args = self.mk.kernel_args(tables, cs, seed, lane_offset, spp, n, mb, rad, rays,
                                   **({} if stack is None else {"stack": stack}))
        launched = (ctypes.c_int * 4)()  # S and flags; a tree may write 3 or 4
        stream = torch.cuda.current_stream().cuda_stream
        status = self.fn(*args, stream, ctypes.cast(launched, ctypes.c_void_p))
        if status != 0:
            raise RuntimeError(f"launch failed: cudaError {status}")
        return rad, rays

    def info(self, tables, cs, mb):
        if self.info_fn is None:
            return None
        out = torch.empty(1, device="cuda")
        args = self.mk.kernel_args(tables, cs, 0, 0, 1, 1, mb, out, out)[:4]
        launched, info = (ctypes.c_int * 4)(), (ctypes.c_int * 5)()
        status = self.info_fn(*args, ctypes.cast(launched, ctypes.c_void_p),
                              ctypes.cast(info, ctypes.c_void_p))
        if status != 0:
            raise RuntimeError(f"query failed: cudaError {status}")
        return {"blocks_per_sm": info[0], "threads": info[1], "registers": info[2],
                "local_bytes": info[3], "smem_bytes": info[4]}


@dataclasses.dataclass
class Shape:
    """One instance's main-path launches: lanes [offset, offset + n) for each
    (offset, n) of `blocks`, at spp and mb, on the scene `pack`."""
    instance: str
    regen: bool
    pack: object
    cs: dict
    spp: int
    mb: int
    blocks: tuple
    seed: int = 1
    cold: bool = False  # also time each launch after an L2 eviction, and back to back


def blocks_of(lanes):
    """render_mega's launches over `lanes` lanes."""
    return tuple((off, min(BLOCK_LANES, lanes - off)) for off in range(0, lanes, BLOCK_LANES))


def shapes():
    demo = demo_scene().compile()
    cam = demo_scene().camera
    n384 = blocks_of(384 * 384 * 3)
    sky = demo_scene()
    sky.load_env_map(chip_smoke.SKY)
    x4 = chip_smoke.cornell_x4(sky=False)
    x4_cam = dataclasses.replace(x4.camera, width=384, height=384)
    with tempfile.TemporaryDirectory() as models:
        chip_smoke.write_stand_in_models(models)
        scene, _ = build_scene(load_config(ROOT / "conf.json"), models_dir=models)
        scene32, _ = build_scene(load_config(ROOT / "conf.json"), models_dir=models,
                                 strict_parity=False)
    conf = scene.compile()
    conf_blocks = blocks_of(scene.camera.width * scene.camera.height * 3)
    return {
        "regen DEMO spp 256": Shape("mega_regen<4, false, false>", True, demo, cam_static(cam),
                                    256, 8, n384),
        "regen DEMO spp 2": Shape("mega_regen<4, false, false>", True, demo, cam_static(cam),
                                  2, 8, n384, seed=3),
        "regen sky DEMO spp 64": Shape("mega_regen<4, true, false>", True, sky.compile(),
                                       cam_static(cam), 64, 8, n384),
        "regen conf 1080p spp 32": Shape("mega_regen<4, true, true>", True, conf,
                                         cam_static(scene.camera), chip_smoke.CONF_SPP, 8,
                                         conf_blocks),
        "regen conf 32 samples spp 4": Shape("mega_regen<-32, true, true>", True,
                                             scene32.compile(), cam_static(scene32.camera), 4,
                                             8, conf_blocks),
        "regen conf block spp 1": Shape("mega_regen<4, true, true>", True, conf,
                                        cam_static(scene.camera), 1, 8,
                                        ((chip_smoke.CONF_BLOCK_OFFSET, 384 * 384 * 3),), seed=2),
        "lockstep DEMO spp 256": Shape("mega_lockstep<4, false>", False, demo, cam_static(cam),
                                       256, 8, n384),
        "lockstep DEMO spp 2": Shape("mega_lockstep<4, false>", False, demo, cam_static(cam),
                                     2, 8, n384, seed=3),
        "lockstep x4 Cornell spp 16": Shape("mega_lockstep<4, true>", False,
                                            x4.compile(cluster_threshold=8),
                                            cam_static(x4_cam), 16, 8, n384),
        **deep_shapes(),
    }


def deep_shapes():
    """The megakernels' part of the `deep` set: `mega_regen_deep<4, false>`
    and `mega_lockstep_deep<4>` at chip_smoke.py (d-deep)'s launch (its
    DEEP_LANES lanes of the 1080p x4 box, spp 1, mb 8, seed 7) on the chain
    and the interior-first chain of DEEP_LEVELS levels (the same leaves;
    their walks' stacks hold 1 and DEEP_LEVELS - 1 entries)."""
    cam = dataclasses.replace(chip_smoke.cornell_x4(sky=False).camera, width=1920, height=1080)
    out = {}
    for form in DEEP_FORMS:
        pack = chip_smoke.chain_pack(DEEP_LEVELS, interior_first=form != "chain")
        for regen, inst in ((True, "mega_regen_deep<4, false>"),
                            (False, "mega_lockstep_deep<4>")):
            out[f"deep {'regen' if regen else 'lockstep'} {form} {DEEP_LEVELS}"] = Shape(
                inst, regen, pack, cam_static(cam), 1, 8, ((0, chip_smoke.DEEP_LANES),),
                seed=7, cold=True)
    return out


def run_shape(lib, tables, sh):
    """All of a shape's launches; returns the planes, concatenated."""
    outs = [lib.launch(tables, sh.cs, sh.seed, off, sh.spp, n, sh.mb) for off, n in sh.blocks]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def sweep_sass(lib, dump=None):
    """The intersector library `lib` in the toolkit's `cuobjdump -sass`
    (written to `dump` if given). Returns {"loops": {sweep kernel: [{
    instructions, pairs, per_pair, lds}, ...]}, "walk": {walk kernel: sha1
    of its instructions}}. The loops are each sweep kernel's innermost loops
    (a backward branch and what it closes) that hold a triangle test: a
    (ray, row) pair divides once (`op2 * w12 / det_g`: one FCHK, the IEEE
    division's check) and takes no sqrt, so a loop's pairs an iteration are
    its FCHKs; per_pair counts every instruction of its body statically, the
    call of the division's slow path included."""
    tools = Path(kbuild.nvcc()).parent
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    if dump:
        Path(dump).parent.mkdir(parents=True, exist_ok=True)
        Path(dump).write_text(sass)
    funcs, name = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = funcs.setdefault(m[1], [])
        elif name is not None and (m := re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)):
            name.append((int(m[1], 16), m[2].strip()))
    out = {"loops": {}, "walk": {}}
    for mangled, ins in funcs.items():
        pretty = subprocess.run(["c++filt", mangled], capture_output=True, text=True).stdout
        kernel = pretty.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
        if kernel.startswith("intersect_walk<"):
            text = "\n".join(t for _, t in ins)
            out["walk"][kernel] = hashlib.sha1(text.encode()).hexdigest()
            continue
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
            if m and int(m[1], 16) < addr:
                loops.append((int(m[1], 16), addr))
        rows = []
        for lo, hi in loops:
            if any(o != (lo, hi) and lo <= o[0] and o[1] <= hi for o in loops):
                continue  # not innermost
            ops = [next(w for w in t.split() if not w.startswith("@")) for a, t in ins
                   if lo <= a <= hi]
            fchk = sum(op.startswith("FCHK") for op in ops)
            if fchk and not any(op.startswith(("MUFU.RSQ", "MUFU.SQRT")) for op in ops):
                rows.append({"instructions": len(ops), "pairs": fchk,
                             "per_pair": len(ops) / fchk,
                             "lds": sum(op.startswith("LDS") for op in ops)})
        if rows:
            out["loops"][kernel] = rows
    return out


def queued_ms(fn, reps):
    """Device ms of fn(), the mean of `reps` runs queued behind a spin of
    the device that outlasts their issue from the host (`chip_smoke.cuda_ms`'s
    method; a turn imports its own tree's chip_smoke, which may time
    otherwise)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000 * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def issue_ms(instructions):
    """The least time the card issues `instructions` thread instructions in:
    each SM issues one warp instruction a clock from each of its 4
    schedulers, at the SM clock's maximum (`nvidia-smi clocks.max.sm`)."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True,
                               check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return instructions / (sms * 4 * 32 * mhz * 1e6) * 1e3, sms, mhz


def cold_ms(fn, reps=20):
    """Device ms of one fn() whose inputs come from DRAM: each run timed
    alone between CUDA events after a 256 MB read that evicts the L2, the
    median of `reps` (`chip_smoke.cuda_ms_cold`'s method, kept here, as
    `queued_ms` is, so that every tree's turn times the same way)."""
    flush = torch.ones((256 << 20) // 4, dtype=torch.float32, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(4_000_000 * reps)
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(start.elapsed_time(end) for start, end in events)[reps // 2]


def vertex_turn(out, shape):
    """One turn of a vertex kernel's shape (`shade_pre`, or `shade_pre_bwd`
    with the next ray's seeds) on the tree first on the import path: the
    tree's wavefront sources built (their ptxas lines and build seconds
    printed), the kernel bitwise against the tree's own plain version, then
    timed at each of VERTEX_SIDES cold (`cold_ms`) and back to back
    (`queued_ms`). shade_pre's outputs go to `out`.npz, to be held against
    the parent's; shade_pre_bwd's change in their last bits with its
    reverse's design, so each tree holds its own plain version only."""
    import numpy as np

    from mcpt_tpu_torch import prng
    from mcpt_tpu_torch.intersect import intersect_c
    from mcpt_tpu_torch.kernels import wavefront as wf
    from mcpt_tpu_torch.kernels import wavefront_ref as wfr
    from mcpt_tpu_torch.scene import pack_to

    for source in (wf.SOURCE, wf.BWD_SOURCE):
        t0 = time.monotonic()
        kbuild.build(source, True, summary=lambda log, name=source.name: [
            f"[ptxas] {name} {line}" for line in kbuild.ptxas_lines(log)])
        print(f"[build] {source.name} {time.monotonic() - t0:.1f} s", flush=True)
    scene = demo_scene()
    pack = pack_to(scene.compile(), "cuda")
    res, answers = {"modes": {}}, {}
    for side in VERTEX_SIDES:
        cam = dataclasses.replace(scene.camera, width=side, height=side)
        key = prng.key(21, "cuda")
        o, d = wf.camera_rays(cam, torch.arange(side * side, device="cuda"), key, 3)
        b, s = o[0].numel(), wfr.n_samples(pack)
        chan = torch.arange(b, device="cuda") % 3
        lam = torch.tensor([0.7, 0.5461, 0.4358], device="cuda")[chan]
        alive = torch.ones(b, dtype=torch.bool, device="cuda")
        args = (pack, o, d, intersect_c(pack, o, d), alive, 0, key, lam, chan)
        if shape == "shade_pre":
            fn = lambda: wf.shade_pre(*args)
            got, want = fn(), wfr.shade_pre(*args)
            flat, flat_w = [], []
            for f, g, w in zip(got._fields, got, want):
                gs, ws = (g, w) if isinstance(g, tuple) else ((g,), (w,))
                for k, (x, y) in enumerate(zip(gs, ws)):
                    answers[f"{b}_{f}{k}"] = x.cpu().numpy()
                    flat.append(x)
                    flat_w.append(y)
        else:
            gen = torch.Generator(device="cuda").manual_seed(5)
            grads = {k: torch.randn(b, generator=gen, device="cuda")
                     for k in (*wfr.RAY_OUT, *wfr.LEAF_OUT)}
            grads["contrib"] = torch.randn(s * b, generator=gen, device="cuda")
            fn = lambda: wf.shade_pre_bwd_rows(*args, grads)
            got = wf.shade_pre_bwd(*args, grads, route="cuda")
            want = wf.shade_pre_bwd(*args, grads, route="plain")
            flat = [*got[0], *got[1], got[2], got[3]]
            flat_w = [*want[0], *want[1], want[2], want[3]]
        for g, w in zip(flat, flat_w):
            view = (lambda x: x.view(torch.int32)) if g.dtype == torch.float32 else (lambda x: x)
            if not torch.equal(view(g), view(w)):
                raise AssertionError(f"{shape} at {b} lanes: the kernel differs from its plain "
                                     f"version on {int((view(g) != view(w)).sum())} entries")
        torch.cuda.synchronize()
        res["modes"][f"{b} lanes"] = "bitwise equal to its plain version"
        cold_ms(fn, 5)  # warm: the host's first calls, the card's clocks
        res[f"{b} lanes_ms"] = cold_ms(fn)
        res[f"{b} lanes warm_ms"] = sorted(queued_ms(fn, 10) for _ in range(5))[2]
    np.savez(f"{out}.npz", **answers)
    Path(f"{out}.json").write_text(json.dumps(res))


def post_fold_turn(out, shape):
    """One turn of `shade_post` or `fold` on the tree first on the import
    path, at each of VERTEX_SIDES: the DEMO's lanes traced by the tree's
    kernels for up to 8 bounces (shade_pre, the intersector's fan and
    nearest query, shade_post), then shade_post on the depth-0 bounce's
    inputs into fresh records, or the fold on the traced records, bitwise
    against the tree's plain version, its outputs to `out`.npz (held
    against the parent's), timed cold (`cold_ms`) and back to back
    (`queued_ms`); shade_post also on the tile's first b - 3 lanes (odd),
    and the wrapper's host time a call at 0 lanes (`host_us`)."""
    import numpy as np

    from mcpt_tpu_torch import prng
    from mcpt_tpu_torch.intersect import intersect_c, occlude_t_c
    from mcpt_tpu_torch.kernels import wavefront as wf
    from mcpt_tpu_torch.kernels import wavefront_ref as wfr
    from mcpt_tpu_torch.parallel import replicate_pack

    t0 = time.monotonic()
    kbuild.build(wf.SOURCE, True, summary=lambda log: [
        f"[ptxas] {wf.SOURCE.name} {line}" for line in kbuild.ptxas_lines(log)])
    print(f"[build] {wf.SOURCE.name} {time.monotonic() - t0:.1f} s", flush=True)
    scene = demo_scene()
    (pack, method), = replicate_pack(scene.compile(), ["cuda"]).values()
    res, answers = {"modes": {}}, {}
    for side in VERTEX_SIDES:
        cam = dataclasses.replace(scene.camera, width=side, height=side)
        key = prng.key(21, "cuda")
        o, d = wf.camera_rays(cam, torch.arange(side * side, device="cuda"), key, 3)
        b, s = o[0].numel(), wfr.n_samples(pack)
        chan = torch.arange(b, device="cuda") % 3
        lam = torch.tensor([0.7, 0.5461, 0.4358], device="cuda")[chan]
        alive = torch.ones(b, dtype=torch.bool, device="cuda")
        hit = intersect_c(pack, o, d, method=method)
        rec = wfr.new_records(8, b, "cuda")
        rays = torch.zeros((), dtype=torch.int64, device="cuda")
        for depth in range(8):
            pre = wf.shade_pre(pack, o, d, hit, alive, depth, key, lam, chan)
            sh_t = occlude_t_c(pack, pre.p_dl, pre.ws, method=method, fan=s)
            nxt = intersect_c(pack, pre.p_new, pre.wi, method=method)
            if depth == 0:
                post_args = (pack, pre, sh_t, nxt.prim)
            alive = wf.shade_post(pack, pre, sh_t, nxt.prim, rec, depth, rays)
            o, d, hit = pre.p_new, pre.wi, nxt
            if not bool(alive.any()):
                break
        checked = {}
        if shape == "shade_post":
            cases = [(b, post_args)]
            if side == VERTEX_SIDES[0]:
                cases.append((b - 3, post_lanes(post_args, s, b - 3)))
            for n, args in cases:
                runs = []
                for post in (wf.shade_post, wfr.shade_post):
                    row, cnt = wfr.new_records(1, n, "cuda"), torch.zeros_like(rays)
                    runs.append([post(*args, row, 0, cnt), *(x[0] for x in row), cnt])
                scratch, cnt = wfr.new_records(1, n, "cuda"), torch.zeros_like(rays)
                checked[n] = (runs, ("alive", *wfr.Records._fields, "rays"),
                              lambda args=args, scratch=scratch, cnt=cnt:
                              wf.shade_post(*args, scratch, 0, cnt))
            empty, none = wfr.new_records(1, 0, "cuda"), post_lanes(post_args, s, 0)
            idle = lambda: wf.shade_post(*none, empty, 0, rays)
        else:
            checked[b] = (([wf.fold(rec)], [wfr.fold(rec)]), ("radiance",), lambda: wf.fold(rec))
            empty = wfr.new_records(8, 0, "cuda")
            idle = lambda: wf.fold(empty)
        timed = {}
        for n, ((got, want), names, fn) in checked.items():
            for name, g, w in zip(names, got, want):
                view = (lambda x: x.view(torch.int32)) if g.dtype == torch.float32 \
                    else (lambda x: x)
                if not torch.equal(view(g), view(w)):
                    raise AssertionError(f"{shape} at {n} lanes: {name} differs from its plain "
                                         f"version on {int((view(g) != view(w)).sum())} entries")
                answers[f"{n}_{name}"] = g.cpu().numpy()
            torch.cuda.synchronize()
            instance = {f"{k[0]}<{k[1]}>": v for k, v in getattr(wf, "by_instance", {}).items()
                        if k[0] == shape}
            res["modes"][f"{n} lanes"] = ("bitwise equal to its plain version"
                                          + (f", instances {instance}" if instance else ""))
            timed[f"{n} lanes"] = fn
        if side == VERTEX_SIDES[0]:
            timed.update(post_fold_scaling(shape, b, s, post_args, rec))
            res["host_us"] = host_us(idle)
        for label, f in timed.items():
            res["modes"].setdefault(label, "timed")
            cold_ms(f, 5)  # warm: the host's first calls, the card's clocks
            res[f"{label}_ms"] = cold_ms(f)
            res[f"{label} warm_ms"] = sorted(queued_ms(f, 10) for _ in range(5))[2]
    np.savez(f"{out}.npz", **answers)
    Path(f"{out}.json").write_text(json.dumps(res))


def post_lanes(post_args, s, n):
    """shade_post's arguments (`post_args`, at s light samples) cut to
    their first n lanes: the sample rows copied to n lanes a row, so that
    row k starts at k·n·4 bytes, as the tracer lays them out for n lanes."""
    pack, pre, sh_t, prim = post_args
    b = pre.fac.shape[0]
    rows = lambda x: x.view(s, b)[:, :n].contiguous().view(-1)
    pre = pre._replace(**{f: rows(getattr(pre, f)) for f in ("thr", "contrib")},
                       **{f: getattr(pre, f)[:n] for f in
                          ("fac", "leaf_pre", "env_c", "w", "at_vertex", "rr_kill")})
    return pack, pre, None if sh_t is None else rows(sh_t), prim[:n]


def host_us(fn, calls=5000, reps=7):
    """The host's microseconds a call of fn (a wrapper called at 0 lanes,
    which launches nothing): the median of `reps` means of `calls` calls."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return sorted(times)[reps // 2]


def post_fold_scaling(shape, b, s, post_args, rec):
    """What bounds `shade_post` or `fold` at the tile's shape, by its time
    at other lane counts on the same inputs: the first 4 lanes (one block:
    the launch and its chain of dependent reads), the tile's b lanes
    repeated 4 and 16 times (the slope: the bytes' rate), and a library
    sum reading as many bytes as the kernel moves at b lanes (what one
    launch that streams those bytes takes, timed the same way; for the
    fold, the bytes of the sectors it touches, `fold_sector_bytes`), and
    the two CUDA events with nothing between them."""
    from mcpt_tpu_torch.kernels import wavefront as wf
    from mcpt_tpu_torch.kernels import wavefront_ref as wfr

    def lanes(x, k, per=1):  # each of the `per` planes of x: its first 4 lanes, or k copies
        x = x.reshape(per, -1)
        return (x[:, :4] if k == 0 else x.repeat(1, k)).reshape(-1).contiguous()

    def at(k):
        n = 4 if k == 0 else b * k
        if shape == "fold":
            rk = wfr.Records(*(x[:, :4].contiguous() if k == 0 else x.repeat(1, k)
                               for x in rec))
            return n, lambda: wf.fold(rk)
        pack, pre, sh_t, prim = post_args
        pk = pre._replace(**{f: lanes(getattr(pre, f), k, s) for f in ("thr", "contrib")},
                          **{f: lanes(getattr(pre, f), k) for f in
                             ("fac", "leaf_pre", "env_c", "w", "at_vertex", "rr_kill")})
        sk, nk = lanes(sh_t, k, s), lanes(prim, k)
        row, cnt = wfr.new_records(1, n, "cuda"), torch.zeros((), dtype=torch.int64,
                                                               device="cuda")
        return n, lambda: wf.shade_post(pack, pk, sk, nk, row, 0, cnt)

    out = {}
    for k in (0, 4, 16):
        n, f = at(k)
        out[f"{n} lanes" + (f" (the tile's x{k})" if k else "")] = f
    if shape == "shade_post":
        nbytes = b * (12 * s + 16 + 2 + 4 + 12 + 2)
    else:
        term = rec.terminal
        depth = term.shape[0]
        first = torch.where(term.any(0), term.to(torch.int32).argmax(0), depth).to(torch.int64)
        needed = (int(torch.clamp(first + 1, max=depth).sum()) + 4 * int((first < depth).sum())
                  + 8 * int(first.sum()) + 4 * b)
        nbytes = fold_sector_bytes(term)  # what the DRAM moves for it
    buf = torch.ones(nbytes // 4, dtype=torch.float32, device="cuda")
    what = "" if shape == "shade_post" else (f", the fold's 32-byte sectors (its bound counts "
                                             f"{needed / 1e6:.2f} MB)")
    out[f"library sum of {nbytes / 1e6:.2f} MB{what}"] = lambda: buf.sum()
    out["no launch (the two events alone)"] = lambda: None
    return out


def fold_sector_bytes(term):
    """The bytes of the 32-byte sectors that the fold reads and writes on
    records with these terminal flags (D, B), each sector once: at each
    depth d the flags' sector (32 lanes) where a lane of it still searches
    at d's chunk of 8 depths, the leaf's sector (8 lanes) where a lane of it
    ends at d, the l_dir and w sectors where a lane of it folds d, and the
    output. The bound counts only the bytes each lane needs; a sector is
    moved whole for any lane of it."""
    depth, b = term.shape
    first = torch.where(term.any(0), term.to(torch.int32).argmax(0), depth)
    d = torch.arange(depth, device=term.device)[:, None]

    def sectors(mask, lanes):
        pad = -b % lanes
        m = torch.nn.functional.pad(mask.to(torch.uint8), (0, pad)).reshape(depth, -1, lanes)
        return 32 * int(m.any(-1).sum())

    return (sectors(first >= d - d % 8, 32) + sectors(first == d, 8)
            + 2 * sectors(first > d, 8) + 4 * b)


def conf_camera(width, height):
    """conf.json's camera (a thin lens) at width x height."""
    from mcpt_tpu_torch.camera import Camera

    cc = json.loads((ROOT / "conf.json").read_text())["camera"]
    return Camera(width=width, height=height, fov=float(cc["fov"]),
                  position=tuple(cc["position"]), target=tuple(cc["target"]),
                  up=tuple(cc["up"]), use_dof=bool(cc["useDOF"]),
                  focal_distance=float(cc["focusDistance"]),
                  aperture_radius=float(cc["apertureRadius"]))


def camera_turn(out, profile):
    """One turn of `camera_rays` on the tree first on the import path: the
    tree's wavefront sources built (every kernel's ptxas line printed), then
    at each of VERTEX_SIDES' pixel counts (65,536 and 147,456: 196,608 and
    442,368 lanes at 3 a pixel) the ids 0 .. P - 1 at 3 lanes a pixel and 1
    through the DEMO's pinhole, and at 3 through conf.json's thin lens; at
    the tile's count less one (its lanes not a multiple of 4) at 3 through
    the pinhole: each bitwise against the tree's own plain version, its planes
    to `out`.npz (held against the parent's), timed cold (`cold_ms`) and
    back to back (`queued_ms`). On the first turn the 1080p DEMO wavefront
    render, spp 2, runs under `chip_smoke.device_profile` (its device ms a
    launch of camera_rays)."""
    import numpy as np

    from mcpt_tpu_torch import prng
    from mcpt_tpu_torch.kernels import wavefront as wf
    from mcpt_tpu_torch.render import render_radiance

    t0 = time.monotonic()
    kbuild.build(wf.SOURCE, True, summary=lambda log: [
        f"[ptxas] {wf.SOURCE.name} {line}" for line in kbuild.ptxas_lines(log)])
    print(f"[build] {wf.SOURCE.name} {time.monotonic() - t0:.1f} s", flush=True)
    scene = demo_scene()
    key = prng.key(21, "cuda")
    cases = []
    for side in VERTEX_SIDES:
        p = side * side
        pin = dataclasses.replace(scene.camera, width=side, height=side)
        cases += [(f"{p} px x3 pinhole", pin, p, 3), (f"{p} px x1 pinhole", pin, p, 1),
                  (f"{p} px x3 thin lens", conf_camera(1920, 1080), p, 3)]
        if side == VERTEX_SIDES[0]:
            cases.append((f"{p - 1} px x3 pinhole", pin, p - 1, 3))
    res, answers = {"modes": {}}, {}
    for label, cam, p, per in cases:
        ids = torch.arange(p, device="cuda")
        fn = lambda cam=cam, ids=ids, per=per: wf.camera_rays(cam, ids, key, per)
        before = dict(getattr(wf, "by_instance", {}))
        got = sum(fn(), ())
        want = sum(wf.camera_rays(cam, ids, key, per, route="plain"), ())
        for k, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"camera_rays {label}: plane {k} differs from its plain "
                                     f"version on {int((g != w).sum())} lanes")
            answers[f"{label} {k}"] = g.cpu().numpy()
        torch.cuda.synchronize()
        ran = {f"{k[0]}<{k[1]}>": v - before.get(k, 0)
               for k, v in getattr(wf, "by_instance", {}).items()
               if k[0] == "camera_rays" and v != before.get(k, 0)}
        res["modes"][label] = ("bitwise equal to its plain version"
                               + (f", instances {ran}" if ran else ""))
        cold_ms(fn, 5)  # warm: the host's first calls, the card's clocks
        res[f"{label}_ms"] = cold_ms(fn)
        res[f"{label} warm_ms"] = sorted(queued_ms(fn, 10) for _ in range(5))[2]
    if profile:
        cam = dataclasses.replace(scene.camera, width=1920, height=1080)
        render_radiance(scene, cam, 1, 0, max_bounces=8, device="cuda")  # warm-up
        chip_smoke.device_profile("camera_rays: the 1080p DEMO wavefront, spp 2", lambda:
                                  render_radiance(scene, cam, 2, 0, max_bounces=8,
                                                  device="cuda"),
                                  kernel="camera_rays", count=lambda: wf.launches["camera_rays"])
    np.savez(f"{out}.npz", **answers)
    Path(f"{out}.json").write_text(json.dumps(res))


def deep_turn(out):
    """One turn of K3's deep walk (`intersect_walk_deep`) on the tree first
    on the import path: the tree's intersector built (its ptxas lines
    printed), then on the chain and the interior-first chain of DEEP_LEVELS
    levels (`chip_smoke.chain_pack`, moved as `render_radiance` moves a
    scene: `pack_to(..., walk=True)`), nearest and occlusion, on
    chip_smoke.py (d-deep)'s 196,608 rays through the box: bitwise against
    the tree's own plain walk, answers to `out`.npz (held against the
    parent's), timed cold (`cold_ms`) and back to back (`queued_ms`)."""
    import numpy as np

    from mcpt_tpu_torch.kernels import intersect_prims as ip
    from mcpt_tpu_torch.kernels.intersect_prims_ref import intersect_walk_ref
    from mcpt_tpu_torch.scene import pack_to

    t0 = time.monotonic()
    kbuild.build(ip.SOURCE, True, summary=lambda log: [
        f"[ptxas] {ip.SOURCE.name} {line}" for line in kbuild.ptxas_lines(log)])
    print(f"[build] {ip.SOURCE.name} {time.monotonic() - t0:.1f} s", flush=True)
    oc, dc = chip_smoke.deep_rays("cuda")
    res, answers = {"modes": {}}, {}
    for form in DEEP_FORMS:
        pack = pack_to(chip_smoke.chain_pack(DEEP_LEVELS, interior_first=form != "chain"),
                       "cuda", walk=True)
        for occ in (False, True):
            label = f"{'occlusion' if occ else 'nearest'} {form} {DEEP_LEVELS}"
            fn = lambda pack=pack, occ=occ: ip.intersect_prims_c(
                pack.tri_sc, pack.sph_geom, pack.n_tris, oc, dc, occlusion=occ, walk=pack.walk)
            got = fn()
            mode = ip.intersect_prims_c.last_mode
            want = intersect_walk_ref(pack.walk.bvh, pack.walk.leaf, pack.sph_geom, pack.n_tris,
                                      oc, dc, occlusion=occ, depth=pack.walk.depth)
            for k, (g, w) in enumerate(zip(got, want)):
                if w is None:
                    continue
                view = (lambda x: x.view(torch.int32)) if g.is_floating_point() else (lambda x: x)
                if not torch.equal(view(g), view(w)):
                    raise AssertionError(f"K3 {label}: output {k} differs from the plain walk "
                                         f"on {int((view(g) != view(w)).sum())} rays")
                answers[f"{label} {k}"] = g.cpu().numpy()
            torch.cuda.synchronize()
            res["modes"][label] = f"{mode}, bitwise equal to the plain walk"
            cold_ms(fn, 5)  # warm: the host's first calls, the card's clocks
            res[f"{label}_ms"] = cold_ms(fn)
            res[f"{label} warm_ms"] = sorted(queued_ms(fn, 10) for _ in range(5))[2]
    np.savez(f"{out}.npz", **answers)
    Path(f"{out}.json").write_text(json.dumps(res))


def wavefront_turn(out, shape, profile, sass=None):
    """One turn of a wavefront shape in this process, on the tree first on
    the import path: writes its answers and image to `out`.npz and its
    numbers to `out`.json."""
    import collections

    import numpy as np

    from mcpt_tpu_torch.intersect import intersect_c, occlude_t_c
    from mcpt_tpu_torch.kernels import intersect_prims as ip
    from mcpt_tpu_torch.render import render_radiance
    from mcpt_tpu_torch.scene import pack_to

    if shape in ("shade_pre", "shade_pre_bwd"):
        return vertex_turn(out, shape)
    if shape in ("shade_post", "fold"):
        return post_fold_turn(out, shape)
    if shape == "camera_rays":
        return camera_turn(out, profile)
    if shape == "deep K3":
        return deep_turn(out)
    cam = dataclasses.replace(demo_scene().camera, width=1920, height=1080)
    if shape == "wavefront DEMO":
        scene = demo_scene()
        pack = pack_to(scene.compile(), "cuda")
        oc, dc = chip_smoke.nee_batch(pack, cam)
        # the fan batch: B first hits, 4 directions each, ray k·B + i from hit i
        fo, fd = chip_smoke.nee_batch(pack, cam, seed=2, shadow=4)
        b = 3 * chip_smoke.TILE_PX
        p, ws = tuple(x[b:2 * b] for x in fo), tuple(x[b:] for x in fd)
        px = tuple(x.repeat(4) for x in p)
        if "fan" in inspect.signature(occlude_t_c).parameters:
            fan = lambda: (occlude_t_c(pack, p, ws, method="kernel", fan=4),)
        else:  # a tree without the fan form
            fan = lambda: (occlude_t_c(pack, px, ws, method="kernel"),)
        calls = (("nearest", lambda: intersect_c(pack, oc, dc, method="kernel")),
                 ("occlusion", lambda: (occlude_t_c(pack, oc, dc, method="kernel"),)),
                 ("fan", fan),
                 ("fan expanded", lambda: (occlude_t_c(pack, px, ws, method="kernel"),)))
    else:
        with tempfile.TemporaryDirectory() as d:
            scene = chip_smoke.soldier_demo(d)
        # as render_radiance moves the scene on the card (a tree's walk tables
        # where the tree's pack_to takes them)
        walk = {"walk": True} if "walk" in inspect.signature(pack_to).parameters else {}
        pack = pack_to(scene.compile(), "cuda", **walk)
        oc, dc = chip_smoke.nee_batch(pack, cam, seed=1)
        calls = (("nearest", lambda: intersect_c(pack, oc, dc, method="kernel")),
                 ("occlusion", lambda: (occlude_t_c(pack, oc, dc, method="kernel"),)))
    res, answers = {"modes": {}}, {}
    for name, fn in calls:
        got = fn()
        torch.cuda.synchronize()
        res["modes"][name] = ip.intersect_prims_c.last_mode
        res[f"{name}_ms"] = sorted(queued_ms(fn, 40) for _ in range(9))[4]
        answers.update({f"{name}_{k}": x.cpu().numpy() for k, x in zip("tpuv", got)})

    def render(spp, seed):
        return render_radiance(scene, scene.camera, spp, seed, max_bounces=8,
                               tile_pixels=384 * 384, device="cuda")

    render(1, 1)  # warm-up
    ip.intersect_prims_c.by_mode = collections.Counter()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    answers["image"], stats = render(8, 0)
    torch.cuda.synchronize()
    res["render_wall_s"] = time.monotonic() - t0
    res["render_launches"] = dict(ip.intersect_prims_c.by_mode)
    res["rays"] = int(stats["rays"])
    if profile:
        chip_smoke.device_profile(f"{shape} 384x384 spp 1 mb 8", lambda: render(1, 5),
                                  kernel="intersect_")
    if sass:
        res["sass"] = sweep_sass(ip.build(), sass)
        # each timed sweep's row loop at the card's issue rate: the loop of
        # most pairs an iteration of the instance that ran its mode
        res["issue_ms"] = {}
        low = lambda x: str(x).lower()
        new = any(k.startswith("intersect_sweep<") for k in res["sass"]["loops"])
        for name, _ in calls:
            mode = res["modes"][name]
            if mode.endswith("walk"):
                continue
            occ, fan = mode.startswith("occlusion"), " fan" in mode
            key = f"intersect_sweep<{low(occ)}, {low(fan)}" if new else \
                f"intersect_prims<{low(occ)}>"
            loops = [lp for k, v in res["sass"]["loops"].items() if k.startswith(key) for lp in v]
            if loops:
                per_pair = max(loops, key=lambda lp: lp["pairs"])["per_pair"]
                pairs = answers[f"{name}_t"].size * pack.tri_sc.shape[0]
                res["issue_ms"][name] = issue_ms(pairs * per_pair)[0]
    np.savez(f"{out}.npz", **answers)
    Path(f"{out}.json").write_text(json.dumps(res))


def wavefront_ab(roots, shapes, rounds, result, sass=None):
    """The wavefront shapes: each tree's turns, each in a process of its own
    from the tree's root, the trees in turns; every tree's answers and image
    bitwise equal to the parent's (the first turn's)."""
    import numpy as np

    trees = tuple(roots)
    with tempfile.TemporaryDirectory() as work:
        for shape in shapes:
            ref = None
            for r in range(max(rounds, 1)):
                for t in (trees if r % 2 == 0 else trees[::-1]):
                    out = Path(work) / f"{t}_{r}"
                    turns = result["trees"][t].setdefault("wavefront", {}).setdefault(shape, [])
                    first = not turns
                    cmd = [sys.executable, "-P", str(Path(__file__).resolve()),
                           "--wavefront-turn", str(out), shape] + (["--profile"] if first else [])
                    if first and sass:
                        cmd += ["--sass", str(Path(sass).resolve() / f"{t}.sass")]
                    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
                        [str(roots[t].resolve())]
                        + [x for x in [os.environ.get("PYTHONPATH")] if x])}
                    t0 = time.monotonic()
                    proc = subprocess.run(cmd, cwd=roots[t], env=env, capture_output=True,
                                          text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(f"{t}: {shape} turn failed\n{proc.stdout[-3000:]}\n"
                                           f"{proc.stderr[-6000:]}")
                    for line in proc.stdout.splitlines():
                        if line.startswith(("[profile]", "[ptxas]", "[build]")):
                            print(f"[ab] {t}: {line}", flush=True)
                    res = json.loads(Path(f"{out}.json").read_text())
                    turns.append(res)
                    got = dict(np.load(f"{out}.npz"))
                    ref = ref or got
                    for key, want in ref.items():
                        if not np.array_equal(got[key], want):
                            raise AssertionError(f"{t} {shape}: {key} differs from the parent's "
                                                 f"on {(got[key] != want).sum()} entries")
                    timed = ", ".join(f"{k} {res[f'{k}_ms']:.4f} ms [{m}]"
                                      for k, m in res["modes"].items())
                    if "render_wall_s" in res:
                        timed += (f", render spp 8 wall {res['render_wall_s']:.3f} s, "
                                  f"launches {res['render_launches']}")
                    else:
                        timed += ", back to back " + ", ".join(
                            f"{k} {res[f'{k} warm_ms']:.4f} ms" for k in res["modes"])
                    if "host_us" in res:
                        timed += f", the wrapper at 0 lanes {res['host_us']:.2f} us a call (host)"
                    print(f"[ab] {t} {shape} turn {r + 1}: {timed}; "
                          f"{time.monotonic() - t0:.1f} s; bitwise equal to the parent's",
                          flush=True)
                    if res.get("issue_ms"):
                        print(f"[ab] {t} {shape}: the row loops at the card's issue rate "
                              + ", ".join(f"{k} {v:.4f} ms" for k, v in res["issue_ms"].items()),
                              flush=True)
                    if "sass" in res:
                        walk = result["trees"][t]["walk_sass"] = res["sass"]["walk"]
                        same = walk == result["trees"][trees[0]].get("walk_sass")
                        print(f"[ab] {t} sass: the walk kernels' instructions "
                              f"{'equal' if same else 'differ from'} {trees[0]}'s", flush=True)
                    for kernel, loops in res.get("sass", {}).get("loops", {}).items():
                        for lp in loops:
                            print(f"[ab] {t} sass {kernel}: row loop of {lp['instructions']} "
                                  f"instructions, {lp['pairs']} pairs, {lp['lds']} shared "
                                  f"loads: {lp['per_pair']:.2f} instructions a pair", flush=True)
            if rounds:
                for t in trees:
                    turns = result["trees"][t]["wavefront"][shape]
                    walls = ["render_wall"] if "render_wall_s" in turns[0] else []
                    warm = [f"{k} warm" for k in turns[0]["modes"] if f"{k} warm_ms" in turns[0]]
                    for k in [*turns[0]["modes"], *warm, *walls]:
                        key = "render_wall_s" if k == "render_wall" else f"{k}_ms"
                        label = "render spp 8 wall (s)" if k == "render_wall" else k
                        xs = sorted(x[key] for x in turns)
                        result["trees"][t]["median_ms"][f"{shape} {label}"] = xs[len(xs) // 2]
                        result["trees"][t].setdefault("range_ms", {})[f"{shape} {label}"] = [
                            xs[0], xs[-1]]
                    if "host_us" in turns[0]:
                        result["trees"][t]["median_ms"][f"{shape} host us a call, 0 lanes"] = \
                            sorted(x["host_us"] for x in turns)[len(turns) // 2]


def main():
    if "--wavefront-turn" in sys.argv:
        i = sys.argv.index("--wavefront-turn")
        sass = sys.argv[sys.argv.index("--sass") + 1] if "--sass" in sys.argv else None
        return wavefront_turn(sys.argv[i + 1], sys.argv[i + 2], "--profile" in sys.argv, sass)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a tree holding mcpt_tpu_torch/")
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="one more tree to time (a design tried)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--shapes", help="comma-separated shape labels to keep (default: all)")
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--sass", metavar="DIR",
                    help="disassemble each tree's intersector into DIR and count its sweep's "
                         "instructions a pair")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mega_ab.py needs a CUDA GPU")
    roots = {"parent": Path(args.parent), "new": ROOT,
             **dict((n, Path(d)) for n, d in (t.split("=", 1) for t in args.tree))}
    keep = args.shapes.split(",") if args.shapes else None
    if keep and "deep" in keep:  # the deep set: the megakernels' shapes and K3's
        keep = [k for k in keep if k != "deep"] + [
            f"deep {k} {form} {DEEP_LEVELS}" for k in ("regen", "lockstep")
            for form in DEEP_FORMS] + ["deep K3"]
    cases = shapes() if keep is None or set(keep) - set(WAVEFRONT) else {}
    if keep:
        unknown = set(keep) - set(cases) - set(WAVEFRONT)
        if unknown:
            raise SystemExit(f"unknown shapes {sorted(unknown)}; known: "
                             f"{sorted(cases) + list(WAVEFRONT)}")
        cases = {k: v for k, v in cases.items() if k in keep}
    result = {"card": card(), "trees": {t: {"root": str(r), "median_ms": {}}
                                        for t, r in roots.items()}}
    if cases:
        megakernel_ab(roots, cases, args.rounds, result)
    waves = [w for w in WAVEFRONT if keep is None or w in keep]
    if waves:
        wavefront_ab(roots, waves, args.rounds, result, args.sass)
    for t, rec in result["trees"].items():
        ranges = rec.get("range_ms", {})
        print(f"[ab] {t}: medians " + ", ".join(
            f"{k} {m:.4f}" + (f" ({ranges[k][0]:.4f}-{ranges[k][1]:.4f})" if k in ranges else "")
            for k, m in rec["median_ms"].items()), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(card(), flush=True)
    print(json.dumps(result), flush=True)


def megakernel_ab(roots, cases, rounds, result):
    """The megakernel shapes, in this process: every tree's two sources
    built at once, each tree's planes bitwise equal to the parent's, then
    `rounds` timed rounds (ms per launch, medians in `result`)."""
    trees = tuple(roots)
    mods = {t: load_tree(r) for t, r in roots.items()}
    jobs = [(t, regen) for t in trees for regen in (True, False)]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda j: build_one(j[0], j[1], roots[j[0]] / "mcpt_tpu_torch" / "csrc"), jobs)))
    libs = {j: Library(path, j[1], mods[j[0]]["megakernel"]) for j, (path, _) in built.items()}
    tables = {(t, label): mods[t]["tables"].SceneTables.from_pack(sh.pack, device="cuda")
              for t in trees for label, sh in cases.items()}
    ref = {}
    for t in trees:
        regs = {**built[t, True][1], **built[t, False][1]}
        rec = result["trees"][t]
        rec.update({"ptxas": regs, "instances": {}, "ms": {}})
        for label, sh in cases.items():
            lib = libs[t, sh.regen]
            inst = rec["instances"].setdefault(sh.instance, dict(regs.get(sh.instance, {})))
            q = lib.info(tables[t, label], sh.cs, sh.mb)
            inst["blocks_per_sm"] = q["blocks_per_sm"] if q else None
            got = run_shape(lib, tables[t, label], sh)  # warm
            torch.cuda.synchronize()
            if label not in ref:
                ref[label] = got
            if not all(torch.equal(a, b) for a, b in zip(got, ref[label])):
                raise AssertionError(f"{t} {label}: output differs from the parent's on "
                                     f"{(got[0] != ref[label][0]).sum().item()} lanes")
            rec["ms"][label] = []
            if sh.cold:
                rec["ms"][f"{label} back to back"] = []
        print(f"[ab] {t}: built, bitwise equal to the parent on every shape; "
              f"{json.dumps(rec['instances'])}", flush=True)
        for name, r in sorted(regs.items()):
            print(f"[ab] {t} ptxas {name}: {r['registers']} registers, {r['stack']} bytes "
                  f"stack, {r['spill_stores']}/{r['spill_loads']} bytes spill stores/loads",
                  flush=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # a read that evicts the L2 before a `cold` shape's launch
    flush = torch.ones((256 << 20) // 4, dtype=torch.float32, device="cuda") if any(
        sh.cold for sh in cases.values()) else None
    for r in range(rounds):
        order = trees if r % 2 == 0 else trees[::-1]
        for label, sh in cases.items():
            for t in order:
                ms = result["trees"][t]["ms"]
                run = lambda: run_shape(libs[t, sh.regen], tables[t, label], sh)
                if sh.cold:
                    flush.sum()
                start.record()
                run()
                end.record()
                torch.cuda.synchronize()
                ms[label].append(start.elapsed_time(end) / len(sh.blocks))
                if sh.cold:  # then 3 launches queued back to back
                    start.record()
                    for _ in range(3):
                        run()
                    end.record()
                    torch.cuda.synchronize()
                    ms[f"{label} back to back"].append(start.elapsed_time(end) / 3 /
                                                       len(sh.blocks))
        print(f"[ab] round {r + 1}/{rounds} done", flush=True)
    for t in trees:
        rec = result["trees"][t]
        rec["median_ms"].update({k: sorted(x)[len(x) // 2] for k, x in rec["ms"].items() if x})
        rec.setdefault("range_ms", {}).update(
            {k: [min(x), max(x)] for k, x in rec["ms"].items() if x})


if __name__ == "__main__":
    sys.exit(main())
