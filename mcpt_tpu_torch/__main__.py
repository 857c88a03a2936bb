"""CLI entry: `python -m mcpt_tpu_torch` (the megakernel engine of
`python -m mcpt_tpu`).

  python -m mcpt_tpu_torch --conf conf.json --models-dir path/to/models
  python -m mcpt_tpu_torch --demo --spp 64
  python -m mcpt_tpu_torch --demo --width 256 --height 256 --out img.png
  python -m mcpt_tpu_torch --demo --device cpu --width 8 --height 8 --spp 1

Prints the render wall-clock as H:M:S.ms like main.cpp:336-348.
"""

import argparse
import dataclasses
import sys

from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.config import DEFAULT_MODELS_DIR, build_scene, load_config
from mcpt_tpu_torch.film import save_png
from mcpt_tpu_torch.render import render_mega


def format_duration(seconds: float) -> str:
    ms = int(round(seconds * 1000.0))
    hrs, ms = divmod(ms, 3600_000)
    mins, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1000)
    return f"{hrs}:{mins}:{secs}.{ms}"


def main(argv=None):
    p = argparse.ArgumentParser(prog="mcpt_tpu_torch")
    p.add_argument("--conf", default=None, help="conf.json path (chess scene)")
    p.add_argument("--demo", action="store_true", help="built-in Cornell DEMO scene")
    p.add_argument("--models-dir", default=DEFAULT_MODELS_DIR)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--max-bounces", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument(
        "--no-strict-parity",
        action="store_true",
        help="fix the reference's dead-key config quirks (see config.py)",
    )
    args = p.parse_args(argv)

    if args.demo:
        scene = demo_scene()
        opts = {"spp": 2048, "output": "./output.png"}
    elif args.conf:
        scene, opts = build_scene(
            load_config(args.conf), models_dir=args.models_dir,
            strict_parity=not args.no_strict_parity,
        )
    else:
        p.error("need --conf or --demo")
    cam = scene.camera
    if args.width:
        cam = dataclasses.replace(cam, width=args.width)
    if args.height:
        cam = dataclasses.replace(cam, height=args.height)
    spp = args.spp if args.spp is not None else opts["spp"]
    out = args.out if args.out is not None else opts["output"]
    print(f"SPP: {spp}")
    fb, stats = render_mega(
        scene.compile(), cam, spp, seed=args.seed,
        max_bounces=args.max_bounces, device=args.device,
    )
    if out:
        save_png(out, fb)
    print(f"Writing image to {out}")
    print(
        f"Rendering finished in {format_duration(stats['elapsed_s'])} "
        f"({stats['rays_per_s']:.3e} rays/s, "
        f"{stats['wavelength_paths'] / max(stats['elapsed_s'], 1e-9):.3e} "
        f"wavelength-paths/s, device={args.device})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
