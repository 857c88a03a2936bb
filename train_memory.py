"""Autograd's saved bytes a lane of the train step's forward, counted on the
CPU: the reckoning of the step's device memory before it runs on a card.

    python3 train_memory.py [--width 32] [--height 32] [--spp 1] [--mb 4] [--oracle]

Runs `diff.render_lanes` of the DEMO with autograd recording and sums, with
`torch.autograd.graph.saved_tensors_hooks`, the bytes of every distinct
storage saved for backward. The bounce runs as the card runs it: the
wavefront's Functions (`kernels/wavefront.py` ShadePre, ShadePost, Fold),
which save a bounce's inputs for their backward kernels; with `--oracle`,
the plain forward under autograd instead (`wavefront.autograd_oracle()`,
the route the train step took before the backward kernels). The
intersector runs under `torch.no_grad`, as the card's kernel does (its
outputs carry no graph; on the CPU the plain route builds one that
`integrator._detach_hit` drops). Prints the total, the bytes a lane (3 a
pixel) and the count of saved storages.
"""

import argparse
import contextlib
import dataclasses

import torch

import mcpt_tpu_torch.integrator as integrator
from mcpt_tpu_torch import prng
from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.diff import SceneParams, apply_params, params_from_pack, render_lanes
from mcpt_tpu_torch.kernels import wavefront
from mcpt_tpu_torch.scene import pack_to


def without_graph(fn):
    def call(*args, **kw):
        with torch.no_grad():
            return fn(*args, **kw)

    return call


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--mb", type=int, default=4)
    ap.add_argument("--oracle", action="store_true",
                    help="the plain forward under autograd, not the Functions")
    args = ap.parse_args(argv)
    integrator.intersect_c = without_graph(integrator.intersect_c)
    integrator.occlude_t_c = without_graph(integrator.occlude_t_c)
    sc = demo_scene()
    host = sc.compile()
    cam = dataclasses.replace(sc.camera, width=args.width, height=args.height)
    params = SceneParams(*(x.requires_grad_() for x in params_from_pack(host)))
    saved = {}

    def keep(t):
        saved[(t.untyped_storage().data_ptr(), t.dtype)] = t.untyped_storage().nbytes()
        return t

    n_pix = args.width * args.height
    route = wavefront.autograd_oracle() if args.oracle else contextlib.nullcontext()
    with route, torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
        render_lanes(apply_params(pack_to(host, "cpu"), params), cam, torch.arange(n_pix),
                     prng.key(0), spp=args.spp, max_bounces=args.mb, method="dense")
    total = sum(saved.values())
    print(f"DEMO {args.width}x{args.height} spp {args.spp} mb {args.mb}"
          f"{' (plain forward under autograd)' if args.oracle else ''}: saved for backward "
          f"{total / 1e6:.1f} MB, {total / (3 * n_pix):.0f} bytes a lane, {len(saved)} storages")


if __name__ == "__main__":
    main()
