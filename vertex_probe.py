"""Where the wavefront vertex kernels' time goes, on one GPU:
`python3 vertex_probe.py [--tree NAME=DIR ...] [--variants DIR]`.

Times `shade_pre` and `shade_pre_bwd` (the next ray's seeds given) of each
tree, each in a process of its own with the tree's root first on the
import path (as `mega_ab.py`'s wavefront turns run), with the L2 evicted
before each launch (the median of 20, `mega_ab.cold_ms`):
- at the DEMO tile's 196,608 depth-0 lanes with 0, 1, 4 and 8 light
  samples a vertex (the samples' share and the vertex's);
- at each bounce of the 384x384 DEMO's paths (442,368 lanes, the train
  step's; depth 0 the camera rays' vertices, depth d the lanes after d
  bounces through the kernels, dead lanes included as the step runs them),
  with the share of lanes alive.
It checks nothing against the plain versions, so that a tree whose
arithmetic was changed to attribute time can be timed. `--variants DIR`
first writes three such copies of this tree's package into DIR and times
them beside it: `fastdiv` (built with `-prec-div=false`), `f32sqrt` (the
sqrt's derivative in float32, not float64) and `nodraw` (a uniform from a
multiplicative hash of its index, not threefry). This tree runs as `new`.
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
VARIANTS = {
    "fastdiv": ("kernels/build.py", '"-fmad=false",', '"-fmad=false", "-prec-div=false",'),
    "f32sqrt": ("csrc/wf_vertex.cuh",
                "static_cast<float>(static_cast<double>(g) / (2.0 * sqrt(static_cast<double>(x))))",
                "g / (2.0f * sqrtf(x))"),
    "nodraw": ("csrc/wf_random.cuh",
               "  const Key h = threefry(k, idx);\n"
               "  return __uint_as_float(((h.a ^ h.b) >> 9) | 0x3F800000u) - 1.0f;",
               "  return __uint_as_float((((idx * 2654435761u) ^ k.a ^ k.b) >> 9) | 0x3F800000u)"
               " - 1.0f;"),
}


def make_variants(directory):
    """{name: root} of the attribution copies of this tree's package."""
    out = {}
    for name, (rel, old, new) in VARIANTS.items():
        root = Path(directory) / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(ROOT / "mcpt_tpu_torch", root / "mcpt_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = root / "mcpt_tpu_torch" / rel
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{name}: {rel} no longer holds the code it replaces")
        path.write_text(text.replace(old, new))
        out[name] = root
    return out


def turn(name):
    """Time the tree first on the import path (one process)."""
    import importlib.util

    import torch

    # this script's own mega_ab (a tree may carry another)
    spec = importlib.util.spec_from_file_location("mega_ab", ROOT / "mega_ab.py")
    mega_ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mega_ab)
    cold_ms = mega_ab.cold_ms

    from mcpt_tpu_torch import prng
    from mcpt_tpu_torch.builtin_scenes import demo_scene
    from mcpt_tpu_torch.intersect import intersect_c, occlude_t_c
    from mcpt_tpu_torch.kernels import wavefront as wf
    from mcpt_tpu_torch.kernels import wavefront_ref as wfr
    from mcpt_tpu_torch.scene import pack_to

    def lanes(sc, side):
        pack = pack_to(sc.compile(), "cuda")
        cam = dataclasses.replace(sc.camera, width=side, height=side)
        key = prng.key(21, "cuda")
        o, d = wf.camera_rays(cam, torch.arange(side * side, device="cuda"), key, 3)
        b, s = o[0].numel(), wfr.n_samples(pack)
        chan = torch.arange(b, device="cuda") % 3
        lam = torch.tensor([0.7, 0.5461, 0.4358], device="cuda")[chan]
        gen = torch.Generator(device="cuda").manual_seed(5)
        grads = {k: torch.randn(b, generator=gen, device="cuda")
                 for k in (*wfr.RAY_OUT, *wfr.LEAF_OUT)}
        grads["contrib"] = torch.randn(s * b, generator=gen, device="cuda")
        alive = torch.ones(b, dtype=torch.bool, device="cuda")
        return pack, key, lam, chan, grads, o, d, intersect_c(pack, o, d), alive

    def times(args, grads):
        pre = lambda: wf.shade_pre(*args)  # noqa: E731
        bwd = lambda: wf.shade_pre_bwd_rows(*args, grads)  # noqa: E731
        cold_ms(pre, 5)
        cold_ms(bwd, 5)
        return round(cold_ms(pre), 4), round(cold_ms(bwd), 4)

    out = {}
    for s in (0, 1, 4, 8):
        sc = demo_scene()
        sc.n_dir_sample = s
        pack, key, lam, chan, grads, o, d, hit, alive = lanes(sc, 256)
        out[f"S{s} pre"], out[f"S{s} bwd"] = times(
            (pack, o, d, hit, alive, 0, key, lam, chan), grads)
    pack, key, lam, chan, grads, o, d, hit, alive = lanes(demo_scene(), 384)
    b, s = o[0].numel(), wfr.n_samples(pack)
    rec = wfr.new_records(4, b, "cuda")
    rays = torch.zeros((), dtype=torch.int64, device="cuda")
    for depth in range(4):
        args = (pack, o, d, hit, alive, depth, key, lam, chan)
        out[f"d{depth} alive"] = round(float(alive.float().mean()), 4)
        out[f"d{depth} pre"], out[f"d{depth} bwd"] = times(args, grads)
        pre = wf.shade_pre(*args)
        nxt = intersect_c(pack, pre.p_new, pre.wi)
        alive = wf.shade_post(pack, pre, occlude_t_c(pack, pre.p_dl, pre.ws, fan=s), nxt.prim,
                              rec, depth, rays)
        o, d, hit = pre.p_new, pre.wi, nxt
    print(f"[probe] {name} {json.dumps(out)}", flush=True)


def main():
    if "--turn" in sys.argv:
        return turn(sys.argv[sys.argv.index("--turn") + 1])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="a tree holding mcpt_tpu_torch/ to time beside this one")
    ap.add_argument("--variants", metavar="DIR",
                    help="write the attribution copies of this tree into DIR and time them")
    args = ap.parse_args()
    trees = {"new": ROOT, **{n: Path(d) for n, d in (t.split("=", 1) for t in args.tree)}}
    if args.variants:
        trees.update(make_variants(args.variants))
    for name, root in trees.items():
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(root.resolve()), str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x])}
        proc = subprocess.run([sys.executable, "-P", str(Path(__file__).resolve()), "--turn", name],
                              cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{name} failed\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        print("\n".join(line for line in proc.stdout.splitlines()
                        if line.startswith("[probe]")), flush=True)


if __name__ == "__main__":
    sys.exit(main())
