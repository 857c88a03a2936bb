"""Launch wrapper of the two megakernels (counterpart of
`mcpt_tpu/kernels/megakernel.py:2961-3101` `trace_mega_block`).

`trace_block` takes the plain PyTorch versions (`megakernel_ref`) for tensors
on the CPU and launches a CUDA kernel for tensors on a CUDA device; there is
no fallback between the two. `regen=True` is the path-regeneration kernel
(`csrc/megakernel.cu`, `mega_regen<S, ENV, BVH>`), `regen=False` the lockstep
spp × depth kernel (`csrc/mega_lockstep.cu`, `mega_lockstep<S, BVH>`). Each
source is compiled with nvcc at first use (`kernels/build.py`) as a shared
library with a plain C interface and loaded with ctypes.
"""

import collections
import ctypes
import re

import torch

from mcpt_tpu_torch.constants import BVH_STACK
from mcpt_tpu_torch.kernels import build as _build
from mcpt_tpu_torch.kernels.megakernel_ref import (
    MAX_BOUNCES_LIMIT,
    trace_block_lockstep_ref,
    trace_block_ref,
)
from mcpt_tpu_torch.kernels.tables import EXTRA, TABLE_COLS

SOURCE = _build.CSRC / "megakernel.cu"
LOCKSTEP_SOURCE = _build.CSRC / "mega_lockstep.cu"
# light samples a vertex (csrc/mega_common.cuh kMaxDir): the generic instances
# take any count in groups, and the draws' use-site keys 16 + 4·si + 0..3 stay
# below 2^31
MAX_DIR = 1 << 28
# each source, its C entry and how many template flags (after S) that entry
# reports it launched
_KERNELS = {
    True: (SOURCE, "mcpt_mega_trace", 2),
    False: (LOCKSTEP_SOURCE, "mcpt_mega_lockstep", 1),
}


def instance_name(s: int, *flags: int, deep: bool = False) -> str:
    """The template instance as the C++ source writes it: `mega_regen<S,
    ENV, BVH>` for two flags, `mega_lockstep<S, BVH>` for one; with `deep`
    the instance for a tree of more than BVH_STACK levels, which drops the
    BVH flag: `mega_regen_deep<S, ENV>`, `mega_lockstep_deep<S>`."""
    kernel = "mega_regen" if len(flags) == 2 else "mega_lockstep"
    if deep:
        kernel, flags = kernel + "_deep", flags[:-1]
    return f"{kernel}<{', '.join([str(s), *(('false', 'true')[f] for f in flags)])}>"


def ptxas_summary(log: str) -> list:
    """One line per kernel instance from nvcc's `-Xptxas -v` output: its
    template arguments, registers and spill bytes."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '[^']*(mega_regen|mega_lockstep)(_deep)?ILi(n?\d+)E"
                      r"((?:Lb\dE)*)", line)
        if m:  # the mangled name writes a negative S as n<digits>
            flags = [int(f) for f in re.findall(r"Lb(\d)E", m[4])]
            if m[2]:  # a deep instance drops its BVH flag, which is true
                flags.append(1)
            if len(flags) != (2 if m[1] == "mega_regen" else 1):
                continue
            name = instance_name(int(m[3].replace("n", "-")), *flags, deep=bool(m[2]))
            spill = ""
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def build(verbose: bool = False, regen: bool = True):
    """Compile one kernel source (the regen kernel's, or with regen=False
    the lockstep kernel's) if no library for it exists; with `verbose`,
    print each instance's registers and spills."""
    return _build.build(_KERNELS[regen][0], verbose, ptxas_summary)


def load_library(regen: bool = True):
    """Build (if needed) and load one kernel library once per process."""
    source, entry, _ = _KERNELS[regen]

    def bind(lib):
        for name, n_args in ((entry, 8), (entry + "_info", 6)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * n_args
            fn.restype = ctypes.c_int

    return _build.load(source, bind)


def _check_tables(tables):
    dev = tables.device
    for name in (*TABLE_COLS, *EXTRA):
        t = getattr(tables, name)
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"table {name}: need contiguous float32 on {dev}")
        if name in TABLE_COLS and (t.ndim != 2 or t.shape[1] != TABLE_COLS[name]):
            raise ValueError(f"table {name}: shape {tuple(t.shape)}")
    if tables.emeta.shape[0] != tables.emt.shape[0] or tables.par.shape[0] != 1:
        raise ValueError("emeta rows must equal emt rows and par must be (1, 8)")


def deep(tables) -> bool:
    """Whether the tables' tree takes the kernels' deep instances (more than
    BVH_STACK levels: their walks keep their stacks in device memory)."""
    return tables.use_bvh and tables.bvh_depth > BVH_STACK


def kernel_args(tables, cam, seed, lane_offset, spp, n_lanes, max_bounces, rad, rays,
                lane_stride=1, stack=None):
    """The C interface's argument list for one launch (see the comment on
    `mcpt_mega_trace` in csrc/megakernel.cu; the lockstep entry takes the
    same), pointers from `data_ptr()`; each ctypes array stays alive through
    the cast that points at it. `stack`: the deep instances' walk stacks
    (`walk_stack`), or None."""
    n_dir = tables.n_dir_sample if tables.n_emitters else 0
    ptrs = (ctypes.c_void_p * 12)(
        *(getattr(tables, k).data_ptr() for k in (*TABLE_COLS, *EXTRA)),
        None if stack is None else stack.data_ptr(),
    )
    rows = (ctypes.c_int * 6)(
        *(getattr(tables, k).shape[0] for k in ("tri", "occ", "sph", "mat", "emt", "lcum"))
    )
    om = [v for r in cam["om"] for v in r]
    fpar = (ctypes.c_float * 17)(
        cam["xscale"], cam["yscale"], *om, *cam["pos"], cam["focal"],
        cam["aperture"], (1.0 / n_dir) if n_dir else 0.0,
    )
    ipar = (ctypes.c_int * 18)(
        int(seed), int(lane_offset), int(n_lanes), int(spp), cam["width"],
        cam["height"], int(max_bounces), n_dir, int(tables.enable_shadow),
        int(tables.any_textured), int(tables.n_sph_emitters), int(cam["use_dof"]),
        tables.env.shape[0], tables.env.shape[1], int(tables.use_env),
        int(tables.use_bvh), int(lane_stride), int(tables.bvh_depth),
    )
    return [
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(rows, ctypes.c_void_p),
        ctypes.cast(fpar, ctypes.c_void_p), ctypes.cast(ipar, ctypes.c_void_p),
        rad.data_ptr(), rays.data_ptr(),
    ]


def walk_stack(tables, n_lanes):
    """The deep instances' walk stacks for `n_lanes` lanes (int32, 3 x
    bvh_depth entries a lane: 12 bytes a level), or None for a shallow
    tree."""
    if not deep(tables):
        return None
    return torch.empty(3 * tables.bvh_depth * max(n_lanes, 1), dtype=torch.int32,
                       device=tables.device)


def trace_block(tables, cam, seed, lane_offset, spp, n_lanes, max_bounces=8, *, regen=True,
                lane_stride=1):
    """One kernel launch over lanes lane_offset + i·lane_stride, i < n_lanes,
    of the camera `cam` (`megakernel_ref.cam_static`): the regen kernel, or
    with regen=False the lockstep kernel (no env maps). Lanes past the image
    (3·W·H) are traced as JAX traces the sharded render's pad lanes. Returns
    (mean radiance, ray count), two float32 (n_lanes,) tensors on the
    tables' device. Each launch adds one to `trace_block.launches` and to
    the count, in `trace_block.by_instance`, of the template instance the C
    side reports it launched; `trace_block.last_instance` names that
    instance."""
    if not 1 <= max_bounces <= MAX_BOUNCES_LIMIT:
        raise ValueError(f"max_bounces must be in [1, {MAX_BOUNCES_LIMIT}]")
    if spp < 1 or n_lanes < 0 or lane_stride < 1:
        raise ValueError(f"spp {spp}, n_lanes {n_lanes}, lane_stride {lane_stride}")
    if lane_offset < 0 or lane_offset + max(n_lanes - 1, 0) * lane_stride >= 2**31:
        raise ValueError("lanes outside int32's range")
    if not regen and tables.use_env:
        raise ValueError("env-map scenes require the regen megakernel")
    _check_tables(tables)
    dev = tables.device
    if dev.type == "cpu":
        ref = trace_block_ref if regen else trace_block_lockstep_ref
        return ref(tables, cam, seed, lane_offset, spp, n_lanes, max_bounces,
                   lane_stride=lane_stride)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_dir = tables.n_dir_sample if tables.n_emitters else 0
    if n_dir > MAX_DIR:
        raise ValueError(f"n_dir_sample {n_dir} > {MAX_DIR}")
    lib = load_library(regen)
    _, entry, n_flags = _KERNELS[regen]
    rad = torch.empty(n_lanes, dtype=torch.float32, device=dev)
    rays = torch.empty(n_lanes, dtype=torch.float32, device=dev)
    stack = walk_stack(tables, n_lanes)
    args = kernel_args(
        tables, cam, seed, lane_offset, spp, n_lanes, max_bounces, rad, rays, lane_stride, stack
    )
    launched = (ctypes.c_int * 4)(0, 0, 0, 0)  # S stays 0 if nothing launched
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = getattr(lib, entry)(*args, stream, ctypes.cast(launched, ctypes.c_void_p))
    if status != 0:
        raise RuntimeError(f"megakernel launch failed: cudaError {status}")
    if launched[0]:
        trace_block.last_instance = instance_name(*launched[: 1 + n_flags],
                                                  deep=bool(launched[1 + n_flags]))
        trace_block.launches += 1
        trace_block.by_instance[trace_block.last_instance] += 1
    return rad, rays


def instance_info(tables, cam, max_bounces=8, *, regen=True) -> dict:
    """What the card makes of the instance that `trace_block` launches for
    these CUDA tables (the regen kernel's, or with regen=False the lockstep
    kernel's): its name, resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the tables' shared
    memory), threads a block, registers and local bytes a thread, and
    shared-memory bytes a block. Launches nothing."""
    if tables.device.type != "cuda":
        raise ValueError(f"instance_info needs CUDA tables, not {tables.device}")
    _check_tables(tables)
    lib = load_library(regen)
    _, entry, n_flags = _KERNELS[regen]
    out = torch.empty(1, dtype=torch.float32, device=tables.device)
    args = kernel_args(tables, cam, 0, 0, 1, 1, max_bounces, out, out)[:4]
    launched = (ctypes.c_int * 4)(0, 0, 0, 0)
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(tables.device):
        status = getattr(lib, entry + "_info")(
            *args, ctypes.cast(launched, ctypes.c_void_p), ctypes.cast(info, ctypes.c_void_p))
    if status != 0:
        raise RuntimeError(f"megakernel query failed: cudaError {status}")
    keys = ("blocks_per_sm", "threads", "registers", "local_bytes", "smem_bytes")
    name = instance_name(*launched[: 1 + n_flags], deep=bool(launched[1 + n_flags]))
    return {"instance": name, **dict(zip(keys, info))}


# launches of the kernels, in all and by template instance
trace_block.launches = 0
trace_block.by_instance = collections.Counter()
trace_block.last_instance = None
