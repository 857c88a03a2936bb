"""Compare two trees' CUDA kernels instruction by instruction.

`python3 sass_diff.py --parent DIR [--sources megakernel.cu,...]` builds each
source of `mcpt_tpu_torch/csrc/` from this tree and from DIR (another tree
holding `mcpt_tpu_torch/`, for example the parent commit unpacked with `git
archive <commit> | tar -x -C _checkout/parent`) with the port's nvcc flags,
disassembles both libraries (`cuobjdump -sass`) and prints, for each kernel,
whether its instructions are the same and both trees' ptxas lines. It is the
check that a source edit leaves a kernel's code where it was (ROADMAP
standing item c). Needs nvcc and cuobjdump; runs no kernel.
"""

import argparse
import concurrent.futures as cf
import re
import subprocess
import tempfile
import time
from pathlib import Path

from mcpt_tpu_torch.kernels import build

ROOT = Path(__file__).resolve().parent
SOURCES = ("megakernel.cu", "mega_lockstep.cu", "intersect_prims.cu")
# the anonymous namespace's name in a mangled kernel name depends on the path
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def compile_source(tree: Path, source: str, out: Path) -> str:
    """Build `source` of `tree` into the library `out`; nvcc's ptxas log."""
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
           str(tree / "mcpt_tpu_torch" / "csrc" / source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise subprocess.CalledProcessError(res.returncode, cmd, res.stdout, res.stderr)
    return res.stderr + res.stdout


def kernels_sass(lib: Path) -> dict:
    """{kernel name: its SASS lines, addresses dropped}."""
    tool = Path(build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    got, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = ANON.sub("ANON", m.group(1))
            got[name] = []
        elif name and line.strip().startswith("/*"):
            got[name].append(" ".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split()))
    return got


def ptxas(log: str) -> dict:
    lines = (k.split(":", 1) for k in build.ptxas_lines(log))
    return {ANON.sub("ANON", name): rest.strip() for name, rest in lines}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="a tree holding mcpt_tpu_torch/")
    ap.add_argument("--sources", default=",".join(SOURCES),
                    help="comma-separated files of mcpt_tpu_torch/csrc/")
    args = ap.parse_args(argv)
    t0 = time.monotonic()
    trees = {"parent": Path(args.parent), "new": ROOT}
    sources = args.sources.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(t, s) for t in trees for s in sources]
        libs = {job: Path(tmp) / f"{job[0]}_{job[1]}.so" for job in jobs}
        with cf.ThreadPoolExecutor(len(jobs)) as ex:
            logs = dict(zip(jobs, ex.map(lambda j: compile_source(trees[j[0]], j[1], libs[j]),
                                         jobs)))
        print(f"[sass] built {len(jobs)} libraries in {time.monotonic() - t0:.1f} s", flush=True)
        for src in sources:
            old, new = kernels_sass(libs[("parent", src)]), kernels_sass(libs[("new", src)])
            p_old, p_new = ptxas(logs[("parent", src)]), ptxas(logs[("new", src)])
            for name in sorted(set(old) | set(new)):
                short = re.sub(r"^_ZN\d+ANON\d+", "", name)
                if name not in old or name not in new:
                    print(f"[sass] {src} {short}: only in {'new' if name in new else 'parent'}")
                    continue
                a, b = old[name], new[name]
                apart = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
                same = "SAME" if a == b else f"DIFF ({apart} of {len(a)} lines)"
                line_new = "=" if p_new.get(name) == p_old.get(name) else p_new.get(name, "?")
                print(f"[sass] {src} {short}: {same}; ptxas parent: {p_old.get(name, '?')}; "
                      f"new: {line_new}")
    print(f"[sass] {time.monotonic() - t0:.1f} s")


if __name__ == "__main__":
    main()
