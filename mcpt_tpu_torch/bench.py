"""Headline benchmark of the port: DEMO Cornell box at 1080p on one GPU.

  python -m mcpt_tpu_torch.bench

Prints ONE JSON line, the one `bench.py` prints:
  {"metric": "rays_per_s", "value": N, "unit": "rays/s", "vs_baseline": R}

Rays are counted as bench.py counts them (1 primary per camera sample,
`n_dir_sample` shadow rays per path vertex, 1 bounce ray per RR survivor that
is traced), against the same derived CPU-reference baseline of 1.48e7 rays/s
(BASELINE.md). The render runs through the CUDA megakernel; there is no CPU
fallback: without a card this exits with an error. A warmup render (which
also builds the kernel) is excluded; the value is the median of the timed
renders. The card's name and power limit go to stderr beside the number.

Env knobs: BENCH_SPP (default 2048), BENCH_MB (max bounces, default 8),
BENCH_REPEATS (timed renders, default 3), BENCH_NDIR (light samples per
path vertex, default the DEMO's 4; other counts take the kernel's generic
instances). MCPT_BENCH_WAVEFRONT=1 times the tile-based wavefront engine
instead, as bench.py does: one render (`render_radiance`, key 0, its
kernels built outside the timed region), its rays counted as the
wavefront counts them, and the route and intersector launches it ran
(`render.ran_since`) on stderr; the host starts a few launches a bounce
(PERF.md has its time at 1080p), so set BENCH_SPP low.
"""

import dataclasses
import json
import os
import subprocess
import sys

import torch

from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.kernels.tables import SceneTables
from mcpt_tpu_torch.render import (ran_since, render_mega, render_radiance, resolve_device,
                                   wavefront_counts)

BASELINE_RAYS_PER_S = 1.48e7


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card() -> str:
    """`name, power.limit` of GPU 0 as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def measure(dev, spp, max_bounces, n_rep=3, n_dir=None, wavefront=False, width=1920,
            height=1080) -> float:
    """rays/s of the DEMO at width x height on `dev`: the median of `n_rep`
    megakernel renders after a warmup render, or with `wavefront` one
    wavefront render."""
    sc = demo_scene()
    if n_dir is not None:
        sc.n_dir_sample = n_dir
    cam = dataclasses.replace(sc.camera, width=width, height=height)
    log(f"bench: {dev} spp={spp} mb={max_bounces} n_dir_sample={sc.n_dir_sample} "
        f"engine={'wavefront' if wavefront else 'mega'}")
    if wavefront:
        before = wavefront_counts()
        _, stats = render_radiance(sc, cam, spp, 0, max_bounces=max_bounces, device=dev)
        log(f"wavefront render: {stats['elapsed_s']:.3f}s rays={stats['rays']} -> "
            f"{stats['rays_per_s']:.4e} rays/s, {ran_since(before)}")
        return stats["rays_per_s"]
    tables = SceneTables.from_pack(sc.compile(), device=dev)
    _, stats = render_mega(tables, cam, spp, seed=7, max_bounces=max_bounces, device=dev)
    log(f"warmup: {stats['elapsed_s']:.2f}s")
    samples = []
    for rep in range(n_rep):
        _, stats = render_mega(
            tables, cam, spp, seed=1 + rep, max_bounces=max_bounces, device=dev
        )
        samples.append(stats["rays_per_s"])
        log(
            f"timed render {rep + 1}/{n_rep}: {stats['elapsed_s']:.3f}s "
            f"rays={stats['rays']} -> {stats['rays_per_s']:.4e} rays/s"
        )
    samples.sort()
    return samples[len(samples) // 2]


def main():
    dev = resolve_device("cuda")
    log(f"bench: {torch.cuda.get_device_name(dev)}")
    rays_per_s = measure(
        dev,
        int(os.environ.get("BENCH_SPP", "2048")),
        int(os.environ.get("BENCH_MB", "8")),
        int(os.environ.get("BENCH_REPEATS", "3")),
        int(os.environ["BENCH_NDIR"]) if "BENCH_NDIR" in os.environ else None,
        wavefront=os.environ.get("MCPT_BENCH_WAVEFRONT", "0") == "1",
    )
    log(f"rays/s {rays_per_s:.4e} on {card()}")
    print(
        json.dumps(
            {
                "metric": "rays_per_s",
                "value": round(rays_per_s, 1),
                "unit": "rays/s",
                "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
