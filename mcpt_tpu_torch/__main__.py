"""CLI entry: `python -m mcpt_tpu_torch` (counterpart of `python -m mcpt_tpu`).

  python -m mcpt_tpu_torch --conf conf.json --models-dir path/to/models
  python -m mcpt_tpu_torch --demo --spp 64
  python -m mcpt_tpu_torch --demo --width 256 --height 256 --out img.png
  python -m mcpt_tpu_torch --demo --engine wavefront --spp 8 --checkpoint state.npz
  python -m mcpt_tpu_torch --demo --device cpu --width 8 --height 8 --spp 1

`--engine auto` (the default) renders through the megakernel unless
`--checkpoint` asks for a resumable render, which only the wavefront engine
gives; `--engine mega --checkpoint` is an error. Prints the render
wall-clock as H:M:S.ms like main.cpp:336-348, and the engine it took.
"""

import argparse
import dataclasses
import sys

from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.config import DEFAULT_MODELS_DIR, build_scene, load_config
from mcpt_tpu_torch.film import save_png
from mcpt_tpu_torch.render import ran_since, render, render_mega, wavefront_counts
from mcpt_tpu_torch.utils.progress import format_duration


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
        "--engine",
        default="auto",
        choices=["auto", "mega", "wavefront"],
        help="auto takes the megakernel unless --checkpoint is given; wavefront "
        "is the tile-based engine (resumable with --checkpoint)",
    )
    p.add_argument(
        "--method",
        default="auto",
        choices=["auto", "kernel", "dense", "bvh"],
        help="the wavefront engine's intersector",
    )
    p.add_argument("--checkpoint", default=None, help="resumable render state file")
    p.add_argument(
        "--no-strict-parity",
        action="store_true",
        help="fix the reference's dead-key config quirks (see config.py)",
    )
    args = p.parse_args(argv)
    if args.engine == "mega" and args.checkpoint:
        p.error(
            "--engine mega does not support --checkpoint "
            "(use --engine wavefront for resumable renders)"
        )

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
    engine = "wavefront" if args.engine == "wavefront" or args.checkpoint else "mega"
    if engine == "mega":
        fb, stats = render_mega(
            scene.compile(), cam, spp, seed=args.seed,
            max_bounces=args.max_bounces, device=args.device,
        )
        if out:
            save_png(out, fb)
    else:
        before = wavefront_counts()
        fb, stats = render(
            scene, cam, spp, key=args.seed, out_path=out, max_bounces=args.max_bounces,
            method=args.method, progress=True, checkpoint_path=args.checkpoint,
            device=args.device,
        )
        print(f"Wavefront: {ran_since(before)}")
    print(f"Writing image to {out}")
    print(
        f"Rendering finished in {format_duration(stats['elapsed_s'])} "
        f"({stats['rays_per_s']:.3e} rays/s, "
        f"{stats['wavelength_paths'] / max(stats['elapsed_s'], 1e-9):.3e} "
        f"wavelength-paths/s, engine={engine}, device={args.device})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
