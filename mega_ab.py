"""Old-against-new timing of the two megakernels on one GPU, in one process:
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
`--shapes A,B` keeps only those shapes. Every tree's output planes must
equal the parent's bitwise on every lane (radiance and ray counts), or the
script fails. It prints one JSON object as its last line, and with `--out
FILE` writes it there too. `--rounds 0` checks the trees and times
nothing.
"""

import argparse
import concurrent.futures
import ctypes
import dataclasses
import importlib
import json
import re
import subprocess
import sys
import tempfile
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
        args = self.mk.kernel_args(tables, cs, seed, lane_offset, spp, n, mb, rad, rays)
        launched = (ctypes.c_int * 3)()
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
        launched, info = (ctypes.c_int * 3)(), (ctypes.c_int * 5)()
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
    }


def run_shape(lib, tables, sh):
    """All of a shape's launches; returns the planes, concatenated."""
    outs = [lib.launch(tables, sh.cs, sh.seed, off, sh.spp, n, sh.mb) for off, n in sh.blocks]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a tree holding mcpt_tpu_torch/")
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="one more tree to time (a design tried)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--shapes", help="comma-separated shape labels to keep (default: all)")
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mega_ab.py needs a CUDA GPU")
    roots = {"parent": Path(args.parent), "new": ROOT,
             **dict((n, Path(d)) for n, d in (t.split("=", 1) for t in args.tree))}
    trees = tuple(roots)
    mods = {t: load_tree(r) for t, r in roots.items()}
    jobs = [(t, regen) for t in trees for regen in (True, False)]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda j: build_one(j[0], j[1], roots[j[0]] / "mcpt_tpu_torch" / "csrc"), jobs)))
    libs = {j: Library(path, j[1], mods[j[0]]["megakernel"]) for j, (path, _) in built.items()}
    cases = shapes()
    if args.shapes:
        keep = args.shapes.split(",")
        unknown = set(keep) - set(cases)
        if unknown:
            raise SystemExit(f"unknown shapes {sorted(unknown)}; known: {sorted(cases)}")
        cases = {k: v for k, v in cases.items() if k in keep}
    tables = {(t, label): mods[t]["tables"].SceneTables.from_pack(sh.pack, device="cuda")
              for t in trees for label, sh in cases.items()}
    result = {"card": card(), "trees": {}}
    ref = {}
    for t in trees:
        regs = {**built[t, True][1], **built[t, False][1]}
        rec = result["trees"][t] = {"root": str(roots[t]), "ptxas": regs, "instances": {},
                                    "ms": {}}
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
        print(f"[ab] {t}: built, bitwise equal to the parent on every shape; "
              f"{json.dumps(rec['instances'])}", flush=True)
        for name, r in sorted(regs.items()):
            print(f"[ab] {t} ptxas {name}: {r['registers']} registers, {r['stack']} bytes "
                  f"stack, {r['spill_stores']}/{r['spill_loads']} bytes spill stores/loads",
                  flush=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for r in range(args.rounds):
        order = trees if r % 2 == 0 else trees[::-1]
        for label, sh in cases.items():
            for t in order:
                start.record()
                run_shape(libs[t, sh.regen], tables[t, label], sh)
                end.record()
                torch.cuda.synchronize()
                result["trees"][t]["ms"][label].append(start.elapsed_time(end) / len(sh.blocks))
        print(f"[ab] round {r + 1}/{args.rounds} done", flush=True)
    for t in trees:
        med = {k: sorted(x)[len(x) // 2] for k, x in result["trees"][t]["ms"].items() if x}
        result["trees"][t]["median_ms"] = med
        print(f"[ab] {t}: median ms per launch " +
              ", ".join(f"{k} {m:.3f}" for k, m in med.items()), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(card(), flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
