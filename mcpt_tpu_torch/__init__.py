"""mcpt_tpu_torch — the path tracer of `mcpt_tpu`, ported to PyTorch and CUDA.

The JAX package `mcpt_tpu` is the reference; this package mirrors its module
names. The main path is `config.build_scene` (or a built-in scene) →
`Scene.compile()` → `SceneTables` → `render_mega` →
`kernels.megakernel.trace_block`, which launches the hand-written CUDA
path-regeneration megakernel (`csrc/megakernel.cu`; with `regen=False` the
lockstep megakernel `csrc/mega_lockstep.cu`) for tensors on a CUDA device
and runs its plain PyTorch version (`kernels/megakernel_ref.py`) for tensors
on the CPU. `render_mega_sharded` interleaves the lanes over several
devices. The wavefront engine is `render_radiance` →
`integrator.trace_paths_c`, whose camera rays, bounce halves and fold are
the CUDA kernels of `csrc/wavefront.cu` (`kernels/wavefront.py`) around the
intersector `csrc/intersect_prims.cu` (`intersect.intersect_c` /
`occlude_t_c`, `kernels/intersect_prims.py`), with the random numbers of
`jax.random` (`prng`). Every function takes its device explicitly.

Imports torch and numpy only (never jax, never mcpt_tpu).
"""

__version__ = "0.1.0"

from mcpt_tpu_torch.builtin_scenes import demo_scene
from mcpt_tpu_torch.camera import Camera
from mcpt_tpu_torch.constants import EPSILON, WAVELEN_UM
from mcpt_tpu_torch.kernels.tables import SceneTables
from mcpt_tpu_torch.materials import Material, MaterialType, standard_materials
from mcpt_tpu_torch.render import render_mega, render_mega_sharded, render_radiance
from mcpt_tpu_torch.scene import Scene, ScenePack, Sphere, TriangleMesh

__all__ = [
    "EPSILON",
    "WAVELEN_UM",
    "Camera",
    "Material",
    "MaterialType",
    "Scene",
    "ScenePack",
    "SceneTables",
    "Sphere",
    "TriangleMesh",
    "demo_scene",
    "render_mega",
    "render_mega_sharded",
    "render_radiance",
    "standard_materials",
]
