"""ctypes bindings of the native OBJ parser and BVH builder
(`mcpt_native.cpp`, a copy of `mcpt_tpu/native/mcpt_native.cpp`; the
counterpart of `mcpt_tpu/native/native.py`).

The library is built with g++ at first use into
`mcpt_tpu_torch/_build/<hash of the source and flags>/libmcpt_native.so`.
Where g++ is missing or the build fails, every entry point returns None and
the callers take the numpy versions (`io/obj.py`, `bvh.py`), as in JAX. The
two are host code: the SAH tree and the OBJ arrays are bitwise those of the
numpy versions on the inputs the tests hold them to, and they are what the
JAX package's compile builds.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from mcpt_tpu_torch.bvh import FlatBVH, build_bvh

SOURCE = Path(__file__).resolve().parent / "mcpt_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

# the library keeps the sizes of its last query between the two calls of a
# load or a build, so each pair runs under the lock
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}" / "libmcpt_native.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=240)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    """The bound library, built at first use; None without one. Call under
    `_lock`."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    out = library_path()
    if not out.exists() and not _build(out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    lib.obj_load.restype = ctypes.c_long
    lib.obj_load.argtypes = [ctypes.c_char_p]
    lib.obj_fill.restype = None
    lib.obj_fill.argtypes = [ctypes.c_void_p] * 3
    lib.bvh_build.restype = ctypes.c_long
    lib.bvh_build.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.bvh_prim_count.restype = ctypes.c_long
    lib.bvh_prim_count.argtypes = []
    lib.bvh_fill.restype = None
    lib.bvh_fill.argtypes = [ctypes.c_void_p] * 6
    _lib = lib
    return _lib


def native_available() -> bool:
    with _lock:
        return _load() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def obj_load_native(path):
    """`io.obj.load_obj`'s dict; None without the library."""
    with _lock:
        lib = _load()
        if lib is None:
            return None
        n = lib.obj_load(str(path).encode())
        if n < 0:
            raise FileNotFoundError(path)
        positions = np.empty((n, 3, 3), np.float32)
        texcoords = np.empty((n, 3, 2), np.float32)
        normals = np.empty((n, 3, 3), np.float32)
        lib.obj_fill(_ptr(positions), _ptr(texcoords), _ptr(normals))
    return {"positions": positions, "texcoords": texcoords, "normals": normals}


def bvh_build_native(aabb_min, aabb_max, leaf_size=4, method="sah", sah_bins=16):
    """`bvh.build_bvh`'s FlatBVH; None without the library."""
    mn = np.ascontiguousarray(aabb_min, np.float32)
    mx = np.ascontiguousarray(aabb_max, np.float32)
    n = mn.shape[0]
    with _lock:
        lib = _load()
        if lib is None:
            return None
        if n == 0:
            return build_bvh(mn, mx, leaf_size=leaf_size, method=method)
        nn = lib.bvh_build(_ptr(mn), _ptr(mx), n, leaf_size, 1 if method == "sah" else 0,
                           sah_bins)
        p = lib.bvh_prim_count()
        node_min = np.empty((nn, 3), np.float32)
        node_max = np.empty((nn, 3), np.float32)
        node_miss = np.empty(nn, np.int32)
        leaf_start = np.empty(nn, np.int32)
        leaf_count = np.empty(nn, np.int32)
        prim_ids = np.empty(p, np.int32)
        lib.bvh_fill(_ptr(node_min), _ptr(node_max), _ptr(node_miss), _ptr(leaf_start),
                     _ptr(leaf_count), _ptr(prim_ids))
    return FlatBVH(node_min=node_min, node_max=node_max, node_miss=node_miss,
                   leaf_start=leaf_start, leaf_count=leaf_count, prim_ids=prim_ids)
