"""Build a CUDA source of `csrc/` into a shared library with a plain C
interface, to be loaded with ctypes.

Each library is compiled with nvcc for sm_90a at first use into
`mcpt_tpu_torch/_build/<hash of source, headers and flags>/`, with `-fmad=false` and
no fast math so that every float32 expression rounds as its plain PyTorch
version's does. A process loads each library once (`load`).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "--split-compile=0", "-shared", "-Xcompiler", "-fPIC",
)
_lock = threading.Lock()
_loaded = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: Path) -> Path:
    """Where the library of `source` (as it is now) is, or will be, built:
    named by a hash of the source, of every header in `csrc/` (so a change
    to a header it includes rebuilds it) and of the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{source.stem}.so"


def ptxas_lines(log: str) -> list:
    """One line per kernel from nvcc's `-Xptxas -v` output: its mangled
    name, registers and spill bytes."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"entry function '([^']*)'", line)
        if m:
            name, spill = m[1], ""
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def build(source: Path, verbose: bool = False, summary=ptxas_lines) -> Path:
    """Compile `source` if no library for it exists; with `verbose`, print
    `summary(ptxas log)`. Raises CalledProcessError (with nvcc's output)
    when the build fails."""
    out = library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise subprocess.CalledProcessError(res.returncode, cmd, res.stdout, res.stderr)
        if verbose:
            print("\n".join(summary(res.stderr + res.stdout)) or res.stderr.strip())
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(source: Path, bind):
    """Build (if needed) and load `source`'s library once per process;
    `bind(lib)` sets the argument and result types of its functions."""
    with _lock:
        if source not in _loaded:
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _loaded[source] = lib
    return _loaded[source]
