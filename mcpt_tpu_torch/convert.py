"""Carry a scene compiled by the JAX package across to the port.

`tables_from_pack(arrays, static)` takes the fields of a
`mcpt_tpu.scene.ScenePack` as numpy arrays (`PACK_FIELDS`) plus its static
ints (`PACK_STATIC`) and returns the same `SceneTables` that the port's own
`Scene.compile()` builds — the renderer's counterpart of loading weights;
`pack_from_arrays` returns the port's `ScenePack` of those fields, which the
wavefront path reads (the wavefront fields and `bvh_fat` ride along), and
`params_from_arrays` the port's `diff.SceneParams` of a JAX `SceneParams`
(the trained parameters of inverse rendering).
The JAX pack's flat BVH (`bvh_*`, possibly from its native builder) is
carried as it is, not rebuilt, when the JAX compile chose its clustered path
(`n_cl_nodes > 0`); the env map is carried at full resolution. This module
does not import the JAX package; the caller converts:

    arrays = {f: np.asarray(getattr(jax_pack, f)) for f in PACK_FIELDS}
    static = {s: getattr(jax_pack, s) for s in PACK_STATIC}
    tables = tables_from_pack(arrays, static)
"""

import numpy as np
import torch

from mcpt_tpu_torch.diff import SceneParams
from mcpt_tpu_torch.kernels.tables import SceneTables
from mcpt_tpu_torch.scene import ScenePack

PACK_FIELDS = (
    "tri_sc", "tri_shade", "tri_occ_sc", "sph_geom", "sph_shade", "mat_fat",
    "mat_textured", "emt_fat", "emt_mesh", "emt_intra_cum", "emt_mesh_area",
    "lmesh_cum", "emit_total_area", "background", "rr_rate", "inv_rr",
    "env_pixels", "bvh_min", "bvh_max", "bvh_miss", "bvh_leaf_start",
    "bvh_leaf_count", "bvh_prims", "tri_w", "tri_c", "tri_nr2", "tri_valid", "tri_mt",
    "prim_emissive", "bvh_fat",
)
PACK_STATIC = (
    "n_emitters", "n_sph_emitters", "enable_shadow", "n_dir_sample",
    "use_env", "n_cl_nodes", "n_tris",
)
_INT_FIELDS = ("emt_mesh", "bvh_miss", "bvh_leaf_start", "bvh_leaf_count", "bvh_prims")
_BOOL_FIELDS = ("mat_textured", "tri_valid")


def pack_from_arrays(arrays: dict, static: dict) -> ScenePack:
    """The port's `ScenePack` holding the JAX pack's fields as they are
    (the wavefront path reads it directly)."""
    f32 = np.float32
    clustered = static["n_cl_nodes"] > 0
    return ScenePack(
        **{
            f: (np.asarray(arrays[f], bool) if f in _BOOL_FIELDS
                else np.asarray(arrays[f], np.int32) if f in _INT_FIELDS
                else np.asarray(arrays[f], f32))
            for f in PACK_FIELDS
            if clustered or f == "bvh_fat" or not f.startswith("bvh_")
        },
        t_pad=int(static["n_tris"]),
        n_emitters=int(static["n_emitters"]),
        n_sph_emitters=int(static["n_sph_emitters"]),
        enable_shadow=bool(static["enable_shadow"]),
        n_dir_sample=int(static["n_dir_sample"]),
        use_env=bool(static["use_env"]),
    )


def params_from_arrays(arrays: dict, device=None):
    """The port's `diff.SceneParams` of JAX's `SceneParams` fields as numpy
    arrays (`{f: np.asarray(v) for f, v in jax_params._asdict().items()}`),
    float32 tensors on `device`."""
    return SceneParams(**{
        f: torch.tensor(np.asarray(arrays[f], np.float32), device=device)
        for f in SceneParams._fields
    })


def tables_from_pack(arrays: dict, static: dict, device=None) -> SceneTables:
    return SceneTables.from_pack(pack_from_arrays(arrays, static), device=device)
