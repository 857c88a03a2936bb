"""Per-query work of the plain versions' BVH walks on one `--conf` block, on
the CPU: `python3 bvh_walk_stats.py [--tree DIR] [--lanes N]`.

Renders lanes `chip_smoke.CONF_BLOCK_OFFSET` .. + N (default 3072) of the
`--conf conf.json` scene on `chip_smoke.write_stand_in_models`'s stand-in
meshes (38,528 triangles) through the regen kernel's plain version
(`trace_block_ref`, spp 1, mb 8, seed 2: `chip_smoke.py` phase (c)'s block
and seed) with the work tally on, and splits the tally between the
nearest-hit walks (the tree's `bvh_nearest`) and the shadow-fan walks (its
`bvh_fan`). The walks' code and tables are those of the tree at `--tree`
(default this checkout; another tree, e.g. the parent commit unpacked with
`git archive <commit> | tar -x -C _checkout/parent`, runs on its own
`kernels/tables.py` and `kernels/megakernel_ref.py`), so two trees' walk
orders compare on the same rays' first vertices. Prints one JSON object:
per nearest query its node loads (the walk's `row` tally of child-pair rows;
a walk of the threaded tree, which has no such tally, loads one node per
box test), box tests and Woop tests; per shadow ray its box tests, triangle
predicates and per-origin triangle terms; and per fan walk (one per lane at
a vertex and call of the tree's `bvh_fan`: the four rays of a vertex
together, or each ray on its own) the same with its node loads.
"""

import argparse
import collections
import json
import tempfile
from pathlib import Path

import chip_smoke
import mega_ab
from mcpt_tpu_torch.config import build_scene, load_config

ROOT = Path(__file__).resolve().parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="a tree holding mcpt_tpu_torch/")
    ap.add_argument("--lanes", type=int, default=3072)
    args = ap.parse_args()
    mods = mega_ab.load_tree(args.tree)
    ref = mods["megakernel_ref"]
    with tempfile.TemporaryDirectory() as models:
        chip_smoke.write_stand_in_models(models)
        scene, _ = build_scene(load_config(ROOT / "conf.json"), models_dir=models)
    tables = mods["tables"].SceneTables.from_pack(scene.compile())
    work = {"nearest": collections.Counter(), "fan": collections.Counter()}
    ops = collections.Counter()

    def tallied(part, fn, rays_of):
        def wrapped(*a, **kw):
            before = collections.Counter(ops)
            out = fn(*a, **kw)
            work[part].update(ops - before)
            live = int(a[-1].sum())
            work[part]["queries"] += live
            work[part]["rays"] += live * rays_of(a)
            return out
        return wrapped

    ref.bvh_nearest = tallied("nearest", ref.bvh_nearest, lambda a: 1)
    ref.bvh_fan = tallied("fan", ref.bvh_fan, lambda a: len(a[2]))
    cam = ref.cam_static(scene.camera)
    ref.trace_block_ref(tables, cam, 2, chip_smoke.CONF_BLOCK_OFFSET, 1, args.lanes, 8, ops=ops)
    near, fan = work["nearest"], work["fan"]
    if "row" not in ops:  # a walk without the row tally: one node a step per ray
        near["row"], fan["row"] = near["slab"], fan["slab"]
    per = lambda c, k, n: round(c[k] / max(c[n], 1), 3)
    print(json.dumps({
        "tree": args.tree, "lanes": args.lanes, "bvh_rows": int(tables.bvh.shape[0]),
        "nearest": {"queries": near["queries"], "node_loads": per(near, "row", "queries"),
                    "box_tests": per(near, "slab", "queries"),
                    "woop_tests": per(near, "woop", "queries")},
        "fan_per_ray": {"rays": fan["rays"], "box_tests": per(fan, "slab", "rays"),
                        "tri_tests": per(fan, "fan_tri", "rays"),
                        "origin_terms": per(fan, "fan_origin", "rays")},
        "fan_per_walk": {"walks": fan["queries"], "node_loads": per(fan, "row", "queries"),
                         "box_tests": per(fan, "slab", "queries"),
                         "tri_tests": per(fan, "fan_tri", "queries"),
                         "origin_terms": per(fan, "fan_origin", "queries")},
    }))


if __name__ == "__main__":
    main()
