"""Launch wrapper of the wavefront intersectors (counterpart of
`mcpt_tpu/kernels/intersect_pallas.py` `intersect_prims_pallas_c`,
`intersect_tris_pallas_mm` and `intersect_tris_pallas`).

`intersect_prims_c` and `intersect_tris` take the plain PyTorch version
(`intersect_prims_ref`) for tensors on the CPU and launch the CUDA kernel
`csrc/intersect_prims.cu` for tensors on a CUDA device; there is no fallback
between the two. One kernel serves K2 (at most 1024 triangle rows, one
shared-memory tile), K3's range and K4 (triangles only). A bare table is
swept (tile by tile above 1024 rows); a table given with its BVH
(`walk=`, `kernels/tables.py::walk_tables`) is walked, with the same
answers bit for bit (`intersect_prims_ref.intersect_walk_ref` is the walk's
plain version, and the source of its work tally). The occlusion sweep has a
fan form (`fan=S`: B origins, S·B directions, ray k·B + i from origin i),
which the card sweeps one origin a thread; every other route expands the
origins first (`fan_origins`).
"""

import collections
import ctypes

import torch

from mcpt_tpu_torch.constants import BVH_STACK, spill_entries
from mcpt_tpu_torch.kernels import build as _build
from mcpt_tpu_torch.kernels.intersect_prims_ref import fan_origins, intersect_prims_ref

SOURCE = _build.CSRC / "intersect_prims.cu"
MODES = ("nearest", "occlusion", "tris")  # csrc/intersect_prims.cu `Mode`
# csrc/intersect_prims.cu `Form`
FORMS = ("", " tiled", " walk", " fan", " fan tiled", " deep walk")
MAX_SPHERES = 4096  # csrc/intersect_prims.cu kMaxSph


def build(verbose: bool = False):
    """Compile csrc/intersect_prims.cu if no library for this source
    exists; with `verbose`, print each kernel's registers and spills."""
    return _build.build(SOURCE, verbose)


def _bind(lib):
    fn = lib.mcpt_intersect_prims
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int


def load_library():
    """Build (if needed) and load the kernel library once per process."""
    return _build.load(SOURCE, _bind)


def mode_name(mode: int, form: int) -> str:
    """The launch-count key of a launch the C side reports."""
    return MODES[mode] + FORMS[form]


def _launch(tri, sph, sph_base, oc, dc, occlusion, walk=None, fan=0):
    """One launch: the sweep over `tri` (with `fan`, its fan form), or with
    `walk` the walk over its tables (`tri` is then unused: the leaf rows are
    the table; a fan's origins are expanded for it)."""
    dev = tri.device
    b = dc[0].shape[0]
    bvh, depth = None, 0
    if walk is not None:
        bvh, tri, depth = walk.bvh.contiguous(), walk.leaf, int(walk.depth)
        if fan:
            oc, fan = fan_origins(oc, fan), 0
    # raw pointers of tensors autograd may be following: the kernel's
    # outputs carry no gradient
    tri = tri.detach().contiguous()
    sph = sph.detach().contiguous()
    rays = [x.detach().contiguous() for x in (*oc, *dc)]
    named = [("tri", tri), ("sph", sph)] + ([("bvh", bvh)] if walk is not None else [])
    for name, x in (*named, *zip(("o0", "o1", "o2", "d0", "d1", "d2"), rays)):
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {dev}, got {x.dtype} on {x.device}")
    if tri.ndim != 2 or tri.shape[1] != 16 or sph.ndim != 2 or sph.shape[1] != 4:
        raise ValueError(f"tri {tuple(tri.shape)} must be (T, 16), sph {tuple(sph.shape)} (S, 4)")
    if walk is not None and (bvh.ndim != 2 or bvh.shape[1] != 16):
        raise ValueError(f"bvh {tuple(bvh.shape)} must be (R, 16)")
    n_o = b // fan if fan else b
    if any(x.shape != (n_o,) for x in rays[:3]) or any(x.shape != (b,) for x in rays[3:]):
        raise ValueError("the six ray components must be (B,) tensors (origins (B / fan,))")
    if sph.shape[0] > MAX_SPHERES:
        raise ValueError(f"{sph.shape[0]} spheres > {MAX_SPHERES}")
    t = torch.empty(b, dtype=torch.float32, device=dev)
    if occlusion:
        prim = u = v = None
        outs = (t.data_ptr(), 0, 0, 0)
    else:
        prim = torch.empty(b, dtype=torch.int32, device=dev)
        u = torch.empty_like(t)
        v = torch.empty_like(t)
        outs = (t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr())
    lib = load_library()
    ray_ptrs = (ctypes.c_void_p * 6)(*(x.data_ptr() for x in rays))
    out_ptrs = (ctypes.c_void_p * 4)(*outs)
    # a tree deeper than the kernel's local stack: the walk's stack past its
    # shared-memory tier in device memory, 3 x spill_entries(depth) ints a ray
    stack = (torch.empty(3 * spill_entries(depth) * b, dtype=torch.int32, device=dev)
             if walk is not None and depth > BVH_STACK else None)
    launched = (ctypes.c_int * 2)(-1, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.mcpt_intersect_prims(
            ctypes.cast(ray_ptrs, ctypes.c_void_p), tri.data_ptr(), tri.shape[0],
            None if bvh is None else bvh.data_ptr(), 0 if bvh is None else bvh.shape[0], depth,
            None if stack is None else stack.data_ptr(), sph.data_ptr(), sph.shape[0],
            int(sph_base), b, int(bool(occlusion)), fan,
            ctypes.cast(out_ptrs, ctypes.c_void_p), stream, ctypes.cast(launched, ctypes.c_void_p),
        )
    if status != 0:
        raise RuntimeError(f"intersect_prims launch failed: cudaError {status}")
    if launched[0] >= 0:
        name = mode_name(launched[0], launched[1])
        intersect_prims_c.launches += 1
        intersect_prims_c.by_mode[name] += 1
        intersect_prims_c.rays_by_mode[name] += b
        intersect_prims_c.last_mode = name
    return t, prim, u, v


def _run(tri, sph, sph_base, oc, dc, occlusion, walk=None, fan=None):
    if fan is not None:
        if not occlusion:
            raise ValueError("fan= is a form of the occlusion query")
        if int(fan) < 1 or dc[0].shape[0] != int(fan) * oc[0].shape[0]:
            raise ValueError(f"fan={fan}: need (B,) origins and (fan·B,) directions, got "
                             f"{oc[0].shape[0]} and {dc[0].shape[0]}")
    dev = tri.device
    if dev.type == "cpu":
        return intersect_prims_ref(tri, sph, sph_base, oc, dc, occlusion=occlusion, fan=fan)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(tri, sph, sph_base, oc, dc, occlusion, walk=walk, fan=int(fan or 0))


def intersect_prims_c(tri_sc, sph_geom, sph_base, oc, dc, occlusion=False, walk=None, fan=None):
    """Nearest hit over all primitives (triangles, then spheres) of the
    rays (oc, dc), 3-tuples of (B,) float32 tensors: `tri_sc` (T8, 16) rows
    (any T8: above 1024 the kernel tiles the table, K3's range), `sph_geom`
    (S, 4) [c, r], `sph_base` the prim id of sphere 0. Returns (t, prim, u,
    v) as `intersect_prims_pallas_c` does; occlusion=True returns t and
    three Nones. `walk`, the table's `kernels/tables.py::WalkTables`, has
    the kernel walk the BVH instead of sweeping the table (the same answers;
    on the CPU the plain sweep runs either way). With occlusion=True,
    `fan=S` takes B origins `oc` and S·B directions `dc`, ray k·B + i from
    origin i (the same answers as the origins expanded, bit for bit). Each
    kernel launch adds one to `intersect_prims_c.launches` and to
    `intersect_prims_c.by_mode[<mode the C side reports>]`, and its rays to
    `intersect_prims_c.rays_by_mode[<mode>]`."""
    return _run(tri_sc, sph_geom, sph_base, oc, dc, occlusion, walk, fan)


def intersect_tris(tri_rows, o, d):
    """Nearest triangle hit of (B, 3) rays against `tri_rows` (T, 16), the
    transposed (16, T) table of `intersect_tris_pallas` (K4). Returns (t,
    prim int32 (-1 miss), u, v)."""
    no_sph = tri_rows.new_empty((0, 4))
    # one transposing copy each gives three contiguous component planes
    return _run(tri_rows, no_sph, 0, tuple(o.t().contiguous()), tuple(d.t().contiguous()), False)


# launches of the kernel, in all and by the mode the C side reports, and
# their rays by mode
intersect_prims_c.launches = 0
intersect_prims_c.by_mode = collections.Counter()
intersect_prims_c.rays_by_mode = collections.Counter()
intersect_prims_c.last_mode = None
