"""The lane programs of the backward kernel `shade_pre_bwd` as CUDA C++:
writes `csrc/wavefront_bwd_lanes.cuh`, which `csrc/wavefront_bwd.cu`
includes, from the traced reverse modes of `wavefront_ref.vertex_program`
and `sample_program` (`lane_ad.cuda_body`), the same ops in the same order
as their plain versions replay them.

    python -m mcpt_tpu_torch.kernels.wavefront_lanes   # rewrites the header

The header is committed, so that the kernel builds from the sources alone;
tests/test_torch_train_kernels.py checks that it is what this module writes
for the plain forward as it stands.
"""

from pathlib import Path

from mcpt_tpu_torch.kernels import lane_ad
from mcpt_tpu_torch.kernels import wavefront_ref as ref

HEADER = Path(__file__).resolve().parent.parent / "csrc" / "wavefront_bwd_lanes.cuh"

PRELUDE = """\
// Generated by `python -m mcpt_tpu_torch.kernels.wavefront_lanes` from the
// plain forward of kernels/wavefront_ref.py (vertex_math, sample_math) and
// its reverse (kernels/lane_ad.py); do not edit. One lane's, or one (light
// sample, lane)'s, straight-line float32 code: the forward it recomputes, then
// the adjoint of every op, last op first.

#pragma once

// torch's CUDA clamp, clamp_min and maximum: a NaN comes back as it is
__device__ __forceinline__ float ad_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float ad_clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float ad_maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
// torch.remainder of int64: the sign of the divisor
__device__ __forceinline__ long long ad_rem(long long a, long long b) {
  const long long r = a % b;
  return r != 0 && ((r < 0) != (b < 0)) ? r + b : r;
}
// torch.take: element i of the flattened table
__device__ __forceinline__ float ad_take(const float* table, long long i) {
  return __ldg(table + i);
}
"""


def _struct(name, fields):
    body = "".join(f"  {lane_ad.CTYPE[k]} {n};\n" for n, k in fields)
    return f"struct {name} {{\n{body}}};\n"


def _kinds(prog, names):
    return [(n, prog.tape.inputs[n].kind) for n in names]


def _names(prog, inputs, seeds):
    """C++ names of a program's free values: inputs by `inputs(name)`,
    seeds by `seeds(name)`, parameters as members of P."""
    out = {}
    for n, v in prog.tape.inputs.items():
        out[v.id] = seeds(n[2:]) if n.startswith("g_") else inputs(n)
    out.update({v.id: f"P.{n}" for n, v in prog.tape.params.items()})
    out["env"] = "P.env"
    return out


def _val(names, v, spill):
    return names.get(v.id) or spill.get(v.id) or f"v{v.id}"


# a zero the compiler cannot fold: shade_pre_bwd_kernel traps on a block that
# is not one-dimensional, where the slots would run out of bounds
OPAQUE_ZERO = "threadIdx.y"


def vertex_function(use_env: bool, ray: bool) -> str:
    prog = ref.vertex_program(use_env, ray)
    shared = (*ref.SHARED_FLOATS, "is_reflect")
    seeds = ref.shared_seeds()
    names = _names(prog, lambda n: f"in.{n}",
                   lambda n: f"gs.{n[3:]}" if n.startswith("sh_") else f"g.{n}")
    out_names = ("o0", "o1", "o2", "d0", "d1", "d2", *(f"m{k}" for k in range(13)))
    adj = [prog.adj[n] for n in out_names if n in prog.adj]
    fwd, back = prog.split(adj + [prog.outs["sh_" + n] for n in shared])
    spill, n_slots = lane_ad.spill_slots(
        [fwd, {prog.outs["sh_" + n].id for n in shared}, back, {v.id for v in adj}])
    lines = lane_ad.slot_arrays(n_slots, OPAQUE_ZERO)
    lines += lane_ad.cuda_body(fwd, names, spill)
    lines.append("Shared sh;")
    lines += [f"sh.{n} = {_val(names, prog.outs['sh_' + n], spill)};" for n in shared]
    lines.append("SharedAdj gs = {};")
    lines.append("samples(sh, gs);  // each light sample, forward and back, summed in order")
    lines += lane_ad.cuda_body(back, names, spill)
    lines += [f"out.{n} = {_val(names, prog.adj[n], spill) if n in prog.adj else '0.0f'};"
              for n in out_names]
    assert set(seeds) <= set(ref.SHARED_FLOATS)
    body = "".join(f"  {x}\n" for x in lines)
    return (f"// vertex_math's reverse: {'with' if use_env else 'without'} an env map, "
            f"{'with' if ray else 'without'} the next ray's seeds\n"
            f"template <class Samples>\n__device__ __forceinline__ void "
            f"vertex_env{int(use_env)}_ray{int(ray)}(const VtxIn& in, const VtxPar& P, "
            f"const VtxSeed& g, Samples&& samples, VtxAdj& out) {{\n{body}}}\n")


def sample_function(spheres: bool) -> str:
    prog = ref.sample_program(spheres)
    shared = set(ref.SHARED_FLOATS) | {"is_reflect"}
    names = _names(prog, lambda n: f"sh.{n}" if n in shared else f"in.{n}",
                   lambda n: f"g_{n}")
    names[prog.tape.params["s"].id] = "s"
    out_names = (*ref.shared_seeds(), *(f"e{k}" for k in range(17)))
    adj = [prog.adj[n] for n in out_names if n in prog.adj]
    fwd, back = prog.split(adj)
    spill, n_slots = lane_ad.spill_slots([fwd + back, {v.id for v in adj}])
    lines = lane_ad.slot_arrays(n_slots, OPAQUE_ZERO)
    lines += lane_ad.cuda_body(fwd + back, names, spill)
    lines += [f"{'ge' if n[0] == 'e' and n[1:].isdigit() else 'gs'}.{n} = "
              f"{_val(names, prog.adj[n], spill) if n in prog.adj else '0.0f'};"
              for n in out_names]
    body = "".join(f"  {x}\n" for x in lines)
    return (f"// sample_math's reverse for one (sample, lane), "
            f"{'with' if spheres else 'without'} emissive spheres\n"
            f"__device__ __forceinline__ void sample_sph{int(spheres)}(const Shared& sh, "
            f"const SmpIn& in, long long s, float g_contrib, SharedAdj& gs, SmpAdj& ge) {{\n"
            f"{body}}}\n")


def header() -> str:
    """The text of csrc/wavefront_bwd_lanes.cuh."""
    vp = ref.vertex_program(True, True)
    sp = ref.sample_program(True)
    seeds = ref.shared_seeds()
    parts = [PRELUDE,
             _struct("VtxIn", _kinds(vp, (*ref.VERTEX_FLOATS, *ref.VERTEX_FLAGS, "chan"))),
             "struct VtxPar {\n  float rr_rate, inv_rr, bg0, bg1, bg2;\n"
             "  long long env_h, env_w;\n  const float* env;\n};\n",
             _struct("VtxSeed", [(n, "f") for n in (*ref.RAY_OUT, *ref.LEAF_OUT)]),
             _struct("Shared", [(n, "f") for n in ref.SHARED_FLOATS] + [("is_reflect", "b")]),
             _struct("SharedAdj", [(n, "f") for n in seeds]),
             _struct("VtxAdj", [(n, "f") for n in ("o0", "o1", "o2", "d0", "d1", "d2",
                                                    *(f"m{k}" for k in range(13)))]),
             _struct("SmpIn", _kinds(sp, (*ref.SAMPLE_FLOATS, "chan"))),
             _struct("SmpAdj", [(f"e{k}", "f") for k in range(17)])]
    adds = "".join(f"  acc.{n} = acc.{n} + a.{n};\n" for n in seeds)
    parts.append("// acc += a, field by field (a light sample's adjoints into the vertex's sum)\n"
                 "__device__ __forceinline__ void add_shared(SharedAdj& acc, "
                 f"const SharedAdj& a) {{\n{adds}}}\n")
    parts += [vertex_function(e, r) for e in (False, True) for r in (False, True)]
    parts += [sample_function(s) for s in (False, True)]
    return "\n".join(parts)


def main():
    HEADER.write_text(header())
    print(f"wrote {HEADER}")


if __name__ == "__main__":
    main()
