"""Launch wrapper of the path-regeneration megakernel (counterpart of
`mcpt_tpu/kernels/megakernel.py:2961-3101` `trace_mega_block`).

`trace_block` takes the plain PyTorch version (`megakernel_ref`) for tensors
on the CPU and launches the CUDA kernel `csrc/megakernel.cu` for tensors on a
CUDA device; there is no fallback between the two. The kernel is compiled
with nvcc at first use (`kernels/build.py`) as a shared library with a plain
C interface and loaded with ctypes.
"""

import collections
import ctypes
import re

import torch

from mcpt_tpu_torch.kernels import build as _build
from mcpt_tpu_torch.kernels.megakernel_ref import (
    MAX_BOUNCES_LIMIT,
    trace_block_ref,
)
from mcpt_tpu_torch.kernels.tables import EXTRA, TABLE_COLS

SOURCE = _build.CSRC / "megakernel.cu"
MAX_DIR = 32  # csrc/megakernel.cu kMaxDir


def ptxas_summary(log: str) -> list:
    """One line per kernel instance from nvcc's `-Xptxas -v` output: its
    template arguments, registers and spill bytes."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '[^']*mega_regenILi(n?\d+)ELb(\d)ELb(\d)E", line)
        if m:  # the mangled name writes a negative S as n<digits>
            name = instance_name(int(m[1].replace("n", "-")), int(m[2]), int(m[3]))
            spill = ""
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def build(verbose: bool = False):
    """Compile csrc/megakernel.cu if no library for this source exists;
    with `verbose`, print each instance's registers and spills."""
    return _build.build(SOURCE, verbose, ptxas_summary)


def _bind(lib):
    fn = lib.mcpt_mega_trace
    fn.argtypes = [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int


def load_library():
    """Build (if needed) and load the kernel library once per process."""
    return _build.load(SOURCE, _bind)


def _check_tables(tables):
    dev = tables.device
    for name in (*TABLE_COLS, *EXTRA):
        t = getattr(tables, name)
        dtype = torch.int32 if name == "prims" else torch.float32
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"table {name}: need contiguous {dtype} on {dev}")
        if name in TABLE_COLS and (t.ndim != 2 or t.shape[1] != TABLE_COLS[name]):
            raise ValueError(f"table {name}: shape {tuple(t.shape)}")
    if tables.emeta.shape[0] != tables.emt.shape[0] or tables.par.shape[0] != 1:
        raise ValueError("emeta rows must equal emt rows and par must be (1, 8)")


def kernel_args(tables, cam, seed, lane_offset, spp, n_lanes, max_bounces, rad, rays):
    """The C interface's argument list for one launch (see the comment on
    `mcpt_mega_trace` in csrc/megakernel.cu), pointers from `data_ptr()`;
    each ctypes array stays alive through the cast that points at it."""
    n_dir = tables.n_dir_sample if tables.n_emitters else 0
    ptrs = (ctypes.c_void_p * 11)(
        *(getattr(tables, k).data_ptr() for k in (*TABLE_COLS, *EXTRA))
    )
    rows = (ctypes.c_int * 6)(
        *(getattr(tables, k).shape[0] for k in ("tri", "occ", "sph", "mat", "emt", "lcum"))
    )
    om = [v for r in cam["om"] for v in r]
    fpar = (ctypes.c_float * 17)(
        cam["xscale"], cam["yscale"], *om, *cam["pos"], cam["focal"],
        cam["aperture"], (1.0 / n_dir) if n_dir else 0.0,
    )
    ipar = (ctypes.c_int * 16)(
        int(seed), int(lane_offset), int(n_lanes), int(spp), cam["width"],
        cam["height"], int(max_bounces), n_dir, int(tables.enable_shadow),
        int(tables.any_textured), int(tables.n_sph_emitters), int(cam["use_dof"]),
        tables.env.shape[0], tables.env.shape[1], int(tables.use_env),
        int(tables.use_bvh),
    )
    return [
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(rows, ctypes.c_void_p),
        ctypes.cast(fpar, ctypes.c_void_p), ctypes.cast(ipar, ctypes.c_void_p),
        rad.data_ptr(), rays.data_ptr(),
    ]


def instance_name(s: int, env: int, bvh: int) -> str:
    """`mega_regen<S, ENV, BVH>` as the C++ source writes the instance."""
    flag = ("false", "true")
    return f"mega_regen<{s}, {flag[env]}, {flag[bvh]}>"


def trace_block(tables, cam, seed, lane_offset, spp, n_lanes, max_bounces=8):
    """One kernel launch over lanes [lane_offset, lane_offset + n_lanes) of
    the camera `cam` (`megakernel_ref.cam_static`). Returns (mean radiance,
    ray count), two float32 (n_lanes,) tensors on the tables' device.
    Each launch adds one to `trace_block.launches` and to the count, in
    `trace_block.by_instance`, of the template instance the C side reports
    it launched; `trace_block.last_instance` names that instance."""
    if not 1 <= max_bounces <= MAX_BOUNCES_LIMIT:
        raise ValueError(f"max_bounces must be in [1, {MAX_BOUNCES_LIMIT}]")
    if spp < 1 or n_lanes < 0:
        raise ValueError(f"spp {spp}, n_lanes {n_lanes}")
    _check_tables(tables)
    dev = tables.device
    if dev.type == "cpu":
        return trace_block_ref(
            tables, cam, seed, lane_offset, spp, n_lanes, max_bounces
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_dir = tables.n_dir_sample if tables.n_emitters else 0
    if n_dir > MAX_DIR:
        raise ValueError(f"n_dir_sample {n_dir} > {MAX_DIR}")
    if lane_offset + n_lanes > 3 * cam["width"] * cam["height"] or lane_offset < 0:
        raise ValueError("lanes outside the image")
    lib = load_library()
    rad = torch.empty(n_lanes, dtype=torch.float32, device=dev)
    rays = torch.empty(n_lanes, dtype=torch.float32, device=dev)
    args = kernel_args(
        tables, cam, seed, lane_offset, spp, n_lanes, max_bounces, rad, rays
    )
    launched = (ctypes.c_int * 3)(0, 0, 0)  # S stays 0 if nothing launched
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.mcpt_mega_trace(*args, stream, ctypes.cast(launched, ctypes.c_void_p))
    if status != 0:
        raise RuntimeError(f"megakernel launch failed: cudaError {status}")
    if launched[0]:
        trace_block.last_instance = instance_name(*launched)
        trace_block.launches += 1
        trace_block.by_instance[trace_block.last_instance] += 1
    return rad, rays


# launches of the kernel, in all and by template instance
trace_block.launches = 0
trace_block.by_instance = collections.Counter()
trace_block.last_instance = None
