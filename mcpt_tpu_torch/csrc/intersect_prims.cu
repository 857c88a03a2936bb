// Nearest-hit and occlusion queries of a ray batch for Hopper (sm_90a).
//
// Replaces three Pallas kernels of mcpt_tpu/kernels/intersect_pallas.py, the
// wavefront engine's intersectors:
//   K2 `_kernel_sc` (launched by `intersect_prims_pallas_c`): nearest
//      (t, prim, u, v), or the occlusion t alone, of B rays against at most
//      1024 triangle rows held as SMEM scalars, then the spheres;
//   K3 `_kernel_mm` (launched by `intersect_tris_pallas_mm`): the same query
//      over triangles only with the Woop transform as MXU matmuls, for tables
//      of 1024 < T <= 4096 rows, the spheres added after it by XLA;
//   K4 `_kernel` (launched by `intersect_tris_pallas`): the triangles-only
//      nearest hit.
// On Hopper all three are one kernel: the MXU form and the SMEM budget were
// TPU constraints, not the function's.
//
// What it computes, per ray: its six components come from six contiguous
// float32 arrays (the wavefront's component form: no (B, 3) rows, no
// transposes); it is tested against the triangle rows with
// `_tri_candidate`'s arithmetic (the Woop transform through the
// EPSILON-guarded determinant, inclusive barycentric bounds, t >= 0, and the
// row's `valid` flag; pad rows have nr2 = 0 and fail the determinant guard),
// then every sphere with `_sph_candidate`'s q-form roots. The nearest hit is
// the first minimum in table order (ties go to the lower primitive) and
// triangles beat spheres. Sphere ids start at `sph_base` (the JAX pack's
// 128-padded triangle count, so ids index its shading tables). The float32
// expressions are the JAX ones in the JAX order; build with -fmad=false and
// without fast math so each product and sum rounds where the reference's
// does.
//
// Modes, chosen here from the arguments and reported back to the caller:
//   nearest   (occlusion = 0, n_sph > 0): t, prim (int32, -1 on a miss), u, v
//   occlusion (occlusion = 1): t only (the sweep keeps no winner; the walk
//             keeps the winner's row, for the tie rule)
//   tris      (occlusion = 0, n_sph = 0): K4, triangles only
// and three forms, also chosen from the arguments and reported:
//
// The sweep (a bare table; `intersect_sweep`): the triangle table is staged
// through dynamic shared memory in tiles of at most kTile = 1024 rows (64 KB,
// above the 48 KB default: the launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize and reports any refusal). A
// table of at most kTile rows is one tile (K2's range); a longer one is swept
// tile by tile ("tiled") with __syncthreads() between tiles, every ray tested
// against every row in order (a candidate wins only with a strictly smaller
// t). What bounds it on this card: its instruction stream. Each (ray,
// triangle) pair is 47 counted float32 operations and each (ray, sphere)
// pair about 25, on rows that every thread of a warp reads from the same
// shared-memory address (a broadcast); bytes are 24 per ray in and at most 16
// out. Under -fmad=false, which bitwise equality with the plain version
// needs, every product and sum issues alone, the IEEE division adds its
// reciprocal, Newton steps and check, and the winner's selects and the
// compares come on top, so a pair issues some 70 instructions at one warp
// instruction a clock per scheduler. The design cuts the instructions that
// are not the pair's own arithmetic: a thread holds kRays rays, reads each
// row once as four 16-byte broadcast loads and tests it against all of
// them, so the row's loads and the loop's own work are shared by kRays
// pairs, which give the scheduler independent chains.
//
// The fan form of the occlusion sweep (`fan` > 0): n / fan origins, and ray
// k * (n / fan) + i starts at origin i, the layout in which the wavefront's
// next-event estimation sends a vertex's fan of shadow rays. A thread holds
// one origin and takes its fan kRays directions at a time; per row it
// computes the terms that depend on the origin alone (o . w_k - c_k for k =
// 0, 1, 2: 18 of the pair's 47 operations; l = o - c and cq for a sphere)
// once for those rays. They are the generic form's expressions on the same inputs, so
// the answers are the same bit for bit.
//
// The walk (a table with its BVH, kernels/tables.py `walk_tables`; K3's
// range on Hopper): all pairs is a TPU form (the MXU and the SMEM budget),
// and past a thousand rows the sweep is bound by its own instruction stream.
// The walk changes the work instead: each thread walks the pack's child-pair
// rows near-first with a stack of kStack entries (local memory; a deeper
// tree's walk, intersect_walk_deep, keeps its top kTier entries in shared
// memory and the rest in device memory, deep_stack.cuh), descends
// rows until it holds a leaf (while-while: the warp then tests leaves
// together), and tests the leaf's tri_sc rows, read in leaf order through the
// read-only path, as the sweep tests them. An entry is taken while its entry
// t - EPSILON <= the best t so far, so the winner's boxes are always entered
// (the child boxes are inflated, tables.py `bvh_tables`); nearest keeps the
// lowest t with equal t to the lower tri_sc row (float kWalkId of a leaf
// row), which is the sweep's first minimum, bit for bit; occlusion keeps the
// same winner (equal t differ there only in the sign of a zero, the t of a
// ray whose origin lies on two triangles' planes) and returns its t. The
// megakernels' `nearest_bvh` (mega_common.cuh) is the same walk over the
// same rows; it is not shared, so that no megakernel instance's register
// allocation moves. Bound: the rows and leaf rows a ray loads (L1 and L2
// hits) and the SIMT divergence between walks; the operations are ~26 a box
// test and ~47 a triangle test, the plain walk's tally (intersect_prims_ref.py
// `intersect_walk_ref`).
//
// The spheres sit in shared memory and are tested after the triangles in
// every form.

#include <cuda_runtime.h>

#include "deep_stack.cuh"

namespace {

constexpr float kEps = 1e-4f;
constexpr float kTMax = 3e37f;
constexpr int kCols = 16;      // tri_sc row: w00..w22, c0..c2, nr2, valid, pad
constexpr int kTile = 1024;    // triangle rows per shared-memory tile
constexpr int kMaxSph = 4096;  // spheres held in shared memory
constexpr int kThreads = 256;
// rays a sweep thread holds (the fan form: directions a pass); 4 beat 2
// and 8 in every mode on the H100 (PERF.md)
constexpr int kRays = 4;
// entries of a walk's per-thread stack (constants.py BVH_STACK): a walk
// pushes at most one entry per tree level; deeper trees take
// intersect_walk_deep, whose stack goes past its shared-memory tier into device
// memory
constexpr int kStack = 32;
constexpr int kWalkId = 15;  // a walk leaf row's index in tri_sc (int bits)
// resident blocks a SM that the deep walk is held to (48 registers, as the
// walk of the one-tier stack had): uncapped, its two-tier stack took 56-62
// registers, 4 blocks, and the walk of a tree whose stack stays in the
// tier ran 3% slower cold than the one-tier walk (PERF.md)
constexpr int kDeepBlocks = 5;

enum Mode { kNearest = 0, kOcclusion = 1, kTris = 2 };
enum Form { kSweep = 0, kTiled = 1, kWalk = 2, kFan = 3, kFanTiled = 4, kDeepWalk = 5 };

struct Rays {
  const float *o0, *o1, *o2, *d0, *d1, *d2;
};

struct Out {
  float* t;
  int* prim;
  float* u;
  float* v;
};

// _tri_candidate (intersect_pallas.py:262-298), in its order: t, or kTMax
// when the row is missed; u and v its barycentrics. Pad rows have nr2 = 0
// and fail the determinant guard.
__device__ __forceinline__ float tri_candidate(const float* w, float o0, float o1, float o2,
                                               float d0, float d1, float d2, float& u, float& v) {
  const float dp2 = d0 * w[6] + d1 * w[7] + d2 * w[8];
  const float op2 = o0 * w[6] + o1 * w[7] + o2 * w[8] - w[11];
  const float det = -(dp2 * w[12]);
  const bool okd = fabsf(det) >= kEps;
  const float det_g = okd ? det : 1.f;
  const float t = op2 * w[12] / det_g;
  const float dp0 = d0 * w[0] + d1 * w[1] + d2 * w[2];
  const float op0 = o0 * w[0] + o1 * w[1] + o2 * w[2] - w[9];
  u = op0 + t * dp0;
  const float dp1 = d0 * w[3] + d1 * w[4] + d2 * w[5];
  const float op1 = o0 * w[3] + o1 * w[4] + o2 * w[5] - w[10];
  v = op1 + t * dp1;
  const bool ok = okd && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f && t >= 0.f &&
                  w[13] > 0.5f;
  return ok ? t : kTMax;
}

// _sph_candidate (intersect_pallas.py:301-323) with the per-ray invariants
// of `_kernel_sc`, over the spheres in shared memory: a sphere wins only with
// a strictly smaller t.
template <bool OCC>
__device__ __forceinline__ void spheres(const float* s_sph, int n_sph, int sph_base, float o0,
                                        float o1, float o2, float d0, float d1, float d2,
                                        float& t_best, int& prim, float& u_best, float& v_best) {
  const float a = d0 * d0 + d1 * d1 + d2 * d2;
  const bool a_ok = a > 1e-12f;
  const float a_safe = fmaxf(a, 1e-12f);
  for (int s = 0; s < n_sph; ++s) {
    const float* c = s_sph + s * 4;
    const float l0 = o0 - c[0];
    const float l1 = o1 - c[1];
    const float l2 = o2 - c[2];
    const float bq = 2.f * (d0 * l0 + d1 * l1 + d2 * l2);
    const float cq = l0 * l0 + l1 * l1 + l2 * l2 - c[3] * c[3];
    const float disc = bq * bq - 4.f * a_safe * cq;
    bool ok = disc >= 0.f && a_ok && c[3] > 0.f;
    const float sq = sqrtf(fmaxf(disc, 0.f));
    const float q = bq > 0.f ? -0.5f * (bq + sq) : -0.5f * (bq - sq);
    const float qs = fabsf(q) > 1e-10f ? q : 1.f;
    const float x0 = q / a_safe;
    const float x1 = cq / qs;
    const float lo = fminf(x0, x1);
    const float hi = fmaxf(x0, x1);
    const float t = lo < 0.f ? hi : lo;
    ok = ok && t >= 0.f;
    const float tc = ok ? t : kTMax;
    if (tc < t_best) {
      t_best = tc;
      if (!OCC) {
        prim = sph_base + s;
        u_best = 0.f;
        v_best = 0.f;
      }
    }
  }
}

// The sweep's form of the same two tests, split at the terms that depend on
// the ray's origin alone, which a fan of rays from one origin shares. The
// expressions are the ones above on the same inputs, so the bits are the
// same; the walk keeps the forms above, so that its generated code stays
// as it is.
struct OriginTerms {
  float op0, op1, op2;  // op_k = o . w_k - c_k
};

__device__ __forceinline__ OriginTerms origin_terms(const float* w, float o0, float o1, float o2) {
  return {o0 * w[0] + o1 * w[1] + o2 * w[2] - w[9], o0 * w[3] + o1 * w[4] + o2 * w[5] - w[10],
          o0 * w[6] + o1 * w[7] + o2 * w[8] - w[11]};
}

// tri_candidate given the origin's terms.
__device__ __forceinline__ float tri_candidate_at(const float* w, const OriginTerms& op, float d0,
                                                  float d1, float d2, float& u, float& v) {
  const float dp2 = d0 * w[6] + d1 * w[7] + d2 * w[8];
  const float det = -(dp2 * w[12]);
  const bool okd = fabsf(det) >= kEps;
  const float det_g = okd ? det : 1.f;
  const float t = op.op2 * w[12] / det_g;
  const float dp0 = d0 * w[0] + d1 * w[1] + d2 * w[2];
  u = op.op0 + t * dp0;
  const float dp1 = d0 * w[3] + d1 * w[4] + d2 * w[5];
  v = op.op1 + t * dp1;
  const bool ok = okd && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f && t >= 0.f &&
                  w[13] > 0.5f;
  return ok ? t : kTMax;
}

struct SphTerms {
  float l0, l1, l2, cq;  // l = o - c, cq = l . l - r^2
};

__device__ __forceinline__ SphTerms sph_terms(const float* c, float o0, float o1, float o2) {
  const float l0 = o0 - c[0];
  const float l1 = o1 - c[1];
  const float l2 = o2 - c[2];
  return {l0, l1, l2, l0 * l0 + l1 * l1 + l2 * l2 - c[3] * c[3]};
}

// One sphere of `spheres` given the origin's terms and the ray's invariants
// a_ok, a_safe: t, or kTMax when the sphere is missed.
__device__ __forceinline__ float sph_candidate_at(const float* c, const SphTerms& l, float d0,
                                                  float d1, float d2, bool a_ok, float a_safe) {
  const float bq = 2.f * (d0 * l.l0 + d1 * l.l1 + d2 * l.l2);
  const float disc = bq * bq - 4.f * a_safe * l.cq;
  bool ok = disc >= 0.f && a_ok && c[3] > 0.f;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float q = bq > 0.f ? -0.5f * (bq + sq) : -0.5f * (bq - sq);
  const float qs = fabsf(q) > 1e-10f ? q : 1.f;
  const float x0 = q / a_safe;
  const float x1 = l.cq / qs;
  const float lo = fminf(x0, x1);
  const float hi = fmaxf(x0, x1);
  const float t = lo < 0.f ? hi : lo;
  ok = ok && t >= 0.f;
  return ok ? t : kTMax;
}

template <bool OCC>
__device__ __forceinline__ void store(const Out& out, int i, float t, int prim, float u, float v) {
  out.t[i] = t;
  if (!OCC) {
    out.prim[i] = prim;
    out.u[i] = u;
    out.v[i] = v;
  }
}

// A triangle row of shared memory into registers, as four 16-byte loads
// (every thread of a warp reads the same row: a broadcast).
__device__ __forceinline__ void load_tri(const float* s_tri, int j, float* w) {
  const float4* q = reinterpret_cast<const float4*>(s_tri) + j * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 a = q[k];
    w[4 * k] = a.x;
    w[4 * k + 1] = a.y;
    w[4 * k + 2] = a.z;
    w[4 * k + 3] = a.w;
  }
}

// The sweep: R = kRays rays a thread, each table row read once for all R.
// Without FAN, `n` rays; thread t of block b holds rays b * blockDim * R + k
// * blockDim + t (k < R, coalesced). With FAN, `n` origins and fan * n rays,
// ray k * n + i from origin i: thread i holds origin i and takes its fan
// R rays a pass, computing the origin's terms once per row and pass.
template <bool OCC, bool FAN>
__global__ void __launch_bounds__(kThreads)
    intersect_sweep(Rays r, const float* __restrict__ tri, int n_tri,
                    const float* __restrict__ sph, int n_sph, int sph_base, int n, int fan,
                    Out out) {
  constexpr int R = kRays;
  extern __shared__ __align__(16) float sweep_smem[];
  const int tile = n_tri < kTile ? n_tri : kTile;
  float* s_tri = sweep_smem;
  float* s_sph = sweep_smem + tile * kCols;
  for (int k = threadIdx.x; k < n_sph * 4; k += blockDim.x) s_sph[k] = sph[k];
  __syncthreads();

  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x * (FAN ? 1 : R) +
                          threadIdx.x;
  float fo0 = 0.f, fo1 = 0.f, fo2 = 0.f;  // FAN: the thread's origin
  if (FAN && first < n) {
    fo0 = r.o0[first];
    fo1 = r.o1[first];
    fo2 = r.o2[first];
  }
  const int passes = FAN ? (fan + R - 1) / R : 1;
  for (int p = 0; p < passes; ++p) {
    // ray k of this pass, and whether it is one of the n (FAN: fan * n)
    auto ray = [&](int k) {
      return FAN ? static_cast<long long>(p * R + k) * n + first
                 : first + static_cast<long long>(k) * blockDim.x;
    };
    auto live = [&](int k) { return FAN ? first < n && p * R + k < fan : ray(k) < n; };
    float o0[R], o1[R], o2[R], d0[R], d1[R], d2[R];
    float t_best[R], u_best[R], v_best[R];
    int prim[R];
    bool any = false;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const bool lk = live(k);
      const long long i = ray(k);
      any = any || lk;
      o0[k] = FAN ? fo0 : (lk ? r.o0[i] : 0.f);
      o1[k] = FAN ? fo1 : (lk ? r.o1[i] : 0.f);
      o2[k] = FAN ? fo2 : (lk ? r.o2[i] : 0.f);
      d0[k] = lk ? r.d0[i] : 0.f;
      d1[k] = lk ? r.d1[i] : 0.f;
      d2[k] = lk ? r.d2[i] : 0.f;
      t_best[k] = kTMax;
      u_best[k] = 0.f;
      v_best[k] = 0.f;
      prim[k] = -1;
    }

    for (int base = 0; base < n_tri; base += tile) {
      const int rows = n_tri - base < tile ? n_tri - base : tile;
      __syncthreads();  // the previous tile is consumed
      for (int k = threadIdx.x; k < rows * kCols; k += blockDim.x) {
        s_tri[k] = tri[static_cast<size_t>(base) * kCols + k];
      }
      __syncthreads();
      if (!any) continue;
      for (int j = 0; j < rows; ++j) {
        float w[16];
        load_tri(s_tri, j, w);
        OriginTerms shared{};
        if (FAN) shared = origin_terms(w, fo0, fo1, fo2);
#pragma unroll
        for (int k = 0; k < R; ++k) {
          float u, v;
          const float tc = tri_candidate_at(
              w, FAN ? shared : origin_terms(w, o0[k], o1[k], o2[k]), d0[k], d1[k], d2[k], u, v);
          if (tc < t_best[k]) {
            t_best[k] = tc;
            if (!OCC) {
              prim[k] = base + j;
              u_best[k] = u;
              v_best[k] = v;
            }
          }
        }
      }
    }
    if (!any) continue;

    bool a_ok[R];
    float a_safe[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float a = d0[k] * d0[k] + d1[k] * d1[k] + d2[k] * d2[k];
      a_ok[k] = a > 1e-12f;
      a_safe[k] = fmaxf(a, 1e-12f);
    }
    for (int s = 0; s < n_sph; ++s) {
      const float4 c4 = reinterpret_cast<const float4*>(s_sph)[s];
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
      SphTerms shared{};
      if (FAN) shared = sph_terms(c, fo0, fo1, fo2);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float tc = sph_candidate_at(c, FAN ? shared : sph_terms(c, o0[k], o1[k], o2[k]),
                                          d0[k], d1[k], d2[k], a_ok[k], a_safe[k]);
        if (tc < t_best[k]) {
          t_best[k] = tc;
          if (!OCC) {
            prim[k] = sph_base + s;
            u_best[k] = 0.f;
            v_best[k] = 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (!live(k)) continue;
      const long long i = ray(k);
      out.t[i] = t_best[k];
      if (!OCC) {
        out.prim[i] = prim[k];
        out.u[i] = u_best[k];
        out.v[i] = v_best[k];
      }
    }
  }
}

// One child-pair row of the walk table (tables.py `bvh_tables`): the boxes
// of children 0 and 1 (min3 max3 each), then per child its link and count
// (count > 0: a leaf of `count` leaf rows from `link`; count 0: interior with
// row `link` >= 1, or empty if link is 0), read as four float4 loads through
// the read-only path.
struct NodeRow {
  float box[12];
  int link0, cnt0, link1, cnt1;
};

__device__ __forceinline__ NodeRow load_row(const float* bvh, int row) {
  const float4* q = reinterpret_cast<const float4*>(bvh) + row * 4;
  NodeRow r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 a = __ldg(q + k);
    r.box[4 * k] = a.x;
    r.box[4 * k + 1] = a.y;
    r.box[4 * k + 2] = a.z;
    r.box[4 * k + 3] = a.w;
  }
  const float4 e = __ldg(q + 3);
  r.link0 = __float_as_int(e.x);
  r.cnt0 = __float_as_int(e.y);
  r.link1 = __float_as_int(e.z);
  r.cnt1 = __float_as_int(e.w);
  return r;
}

// Entry and exit t of the ray (o, 1/d) through box bx (min bx[0..2], max
// bx[3..5]); fminf / fmaxf drop the NaN of 0 * inf (a zero direction
// component with the origin on a box plane).
__device__ __forceinline__ void slab(const float* bx, float o0, float o1, float o2, float i0,
                                     float i1, float i2, float& tmin, float& tmax) {
  const float a0 = (bx[0] - o0) * i0, b0 = (bx[3] - o0) * i0;
  const float a1 = (bx[1] - o1) * i1, b1 = (bx[4] - o1) * i1;
  const float a2 = (bx[2] - o2) * i2, b2 = (bx[5] - o2) * i2;
  tmin = fmaxf(fmaxf(fminf(a0, b0), fminf(a1, b1)), fminf(a2, b2));
  tmax = fminf(fminf(fmaxf(a0, b0), fmaxf(a1, b1)), fmaxf(a2, b2));
}

__device__ __forceinline__ bool passes(float tmin, float tmax) {
  return tmin - kEps <= tmax && tmax >= -kEps;
}

// The walk's stack: an entry is a link, a count and its entry t, pushed at
// most once a tree level. LocalStack views kStack entries in three
// per-thread arrays (local memory) that intersect_walk declares (held in one
// struct, they cost its nearest mode 3 registers); DeepStack, for a tree of
// more than kStack levels (intersect_walk_deep), keeps the top kTier entries
// in shared memory and the rest in device memory (deep_stack.cuh).
struct LocalStack {
  int *link_, *cnt_;
  float* t_;
  __device__ __forceinline__ void push(int sp, int link, int cnt, float t) {
    link_[sp] = link;
    cnt_[sp] = cnt;
    t_[sp] = t;
  }
  __device__ __forceinline__ float t(int sp) const { return t_[sp]; }
  __device__ __forceinline__ int link(int sp) const { return link_[sp]; }
  __device__ __forceinline__ int cnt(int sp) const { return cnt_[sp]; }
};

using DeepStack = TierStack<kThreads>;

// Ray i's walk, with the spheres in shared memory.
template <bool OCC, class Stack>
__device__ __forceinline__ void walk_ray(Rays r, const float* __restrict__ bvh,
                                         const float* __restrict__ leaf, int n_sph, int sph_base,
                                         int i, Out out, Stack& st) {
  extern __shared__ float smem[];
  const float o0 = r.o0[i], o1 = r.o1[i], o2 = r.o2[i];
  const float d0 = r.d0[i], d1 = r.d1[i], d2 = r.d2[i];
  const float i0 = 1.f / d0, i1 = 1.f / d1, i2 = 1.f / d2;
  float t_best = kTMax, u_best = 0.f, v_best = 0.f;
  int prim = -1;
  int sp = 0;
  int link = 0, cnt = 0;  // the item to visit: a row (cnt 0) or a leaf; link -1: none
  auto pop = [&] {  // the next entry still in reach
    link = -1;
    while (sp > 0) {
      --sp;
      if (st.t(sp) - kEps <= t_best) {
        link = st.link(sp);
        cnt = st.cnt(sp);
        return;
      }
    }
  };
  while (link >= 0) {
    while (link >= 0 && cnt == 0) {
      const NodeRow nr = load_row(bvh, link);
      float t0, x0, t1, x1;
      slab(nr.box, o0, o1, o2, i0, i1, i2, t0, x0);
      slab(nr.box + 6, o0, o1, o2, i0, i1, i2, t1, x1);
      const bool swap = t1 < t0;  // child 1 is entered first: it is child a
      const float ta = swap ? t1 : t0, tb = swap ? t0 : t1;
      const int la = swap ? nr.link1 : nr.link0, lb = swap ? nr.link0 : nr.link1;
      const int ca = swap ? nr.cnt1 : nr.cnt0, cb = swap ? nr.cnt0 : nr.cnt1;
      const bool ea = (ca > 0 || la > 0) && passes(ta, swap ? x1 : x0) && ta - kEps <= t_best;
      const bool eb = (cb > 0 || lb > 0) && passes(tb, swap ? x0 : x1) && tb - kEps <= t_best;
      if (ea) {
        if (eb) {
          st.push(sp, lb, cb, tb);
          ++sp;
        }
        link = la;
        cnt = ca;
      } else if (eb) {
        link = lb;
        cnt = cb;
      } else {
        pop();
      }
    }
    if (link < 0) break;
    for (int j = 0; j < cnt; ++j) {
      const float4* q = reinterpret_cast<const float4*>(leaf) + (link + j) * 4;
      float w[16];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 a = __ldg(q + k);
        w[4 * k] = a.x;
        w[4 * k + 1] = a.y;
        w[4 * k + 2] = a.z;
        w[4 * k + 3] = a.w;
      }
      float u, v;
      const float tc = tri_candidate(w, o0, o1, o2, d0, d1, d2, u, v);
      // both modes: equal t (+0 against -0 too) goes to the lower row
      if (tc < t_best || (tc == t_best && tc < kTMax)) {
        const int id = __float_as_int(w[kWalkId]);
        if (tc < t_best || id < prim) {
          t_best = tc;
          prim = id;
          u_best = u;
          v_best = v;
        }
      }
    }
    pop();
  }
  spheres<OCC>(smem, n_sph, sph_base, o0, o1, o2, d0, d1, d2, t_best, prim, u_best, v_best);
  store<OCC>(out, i, t_best, prim, u_best, v_best);
}

template <bool OCC>
__global__ void __launch_bounds__(kThreads)
    intersect_walk(Rays r, const float* __restrict__ bvh, const float* __restrict__ leaf,
                   const float* __restrict__ sph, int n_sph, int sph_base, int n, Out out) {
  extern __shared__ float smem[];
  for (int k = threadIdx.x; k < n_sph * 4; k += blockDim.x) smem[k] = sph[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int stack_link[kStack], stack_cnt[kStack];
  float stack_t[kStack];
  LocalStack st{stack_link, stack_cnt, stack_t};
  walk_ray<OCC>(r, bvh, leaf, n_sph, sph_base, i, out, st);
}

template <bool OCC>
__global__ void __launch_bounds__(kThreads, kDeepBlocks)
    intersect_walk_deep(Rays r, const float* __restrict__ bvh, const float* __restrict__ leaf,
                        const float* __restrict__ sph, int n_sph, int sph_base, int n, Out out,
                        int* __restrict__ stack, int depth) {
  extern __shared__ float smem[];
  for (int k = threadIdx.x; k < n_sph * 4; k += blockDim.x) smem[k] = sph[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // the block's stack tiers follow the spheres in shared memory
  DeepStack st(reinterpret_cast<int*>(smem + n_sph * 4), {stack + i, n, spill_entries(depth)});
  walk_ray<OCC>(r, bvh, leaf, n_sph, sph_base, i, out, st);
}

// Allow `smem` bytes of dynamic shared memory for `kernel` where that is
// above the 48 KB default; the refusal, if any.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// One launch of the sweep; `n` rays, or with FAN `n` origins.
template <bool OCC, bool FAN>
cudaError_t launch_sweep(const Rays& r, const float* tri, int n_tri, const float* sph, int n_sph,
                         int sph_base, int n, int fan, const Out& out, cudaStream_t stream) {
  const int tile = n_tri < kTile ? n_tri : kTile;
  const size_t smem = (static_cast<size_t>(tile) * kCols + static_cast<size_t>(n_sph) * 4) *
                      sizeof(float);
  cudaError_t e = allow_smem(intersect_sweep<OCC, FAN>, smem);
  if (e != cudaSuccess) return e;
  const long long threads = FAN ? n : (static_cast<long long>(n) + kRays - 1) / kRays;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  intersect_sweep<OCC, FAN><<<blocks, kThreads, smem, stream>>>(r, tri, n_tri, sph, n_sph,
                                                                sph_base, n, fan, out);
  return cudaGetLastError();
}

template <bool OCC>
cudaError_t launch_walk(const Rays& r, const float* bvh, const float* leaf, const float* sph,
                        int n_sph, int sph_base, int n, const Out& out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_sph) * 4 * sizeof(float);
  cudaError_t e = allow_smem(intersect_walk<OCC>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (n + kThreads - 1) / kThreads;
  intersect_walk<OCC><<<blocks, kThreads, smem, stream>>>(r, bvh, leaf, sph, n_sph, sph_base, n,
                                                          out);
  return cudaGetLastError();
}

template <bool OCC>
cudaError_t launch_walk_deep(const Rays& r, const float* bvh, const float* leaf, const float* sph,
                             int n_sph, int sph_base, int n, const Out& out, int* stack,
                             int depth, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_sph) * 4 * sizeof(float) + tier_bytes(kThreads);
  cudaError_t e = allow_smem(intersect_walk_deep<OCC>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (n + kThreads - 1) / kThreads;
  intersect_walk_deep<OCC><<<blocks, kThreads, smem, stream>>>(r, bvh, leaf, sph, n_sph, sph_base,
                                                               n, out, stack, depth);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes by kernels/intersect_prims.py).
//   rays:   6 device pointers to float32 arrays: o0, o1, o2 and d0, d1, d2,
//           (n,) each; with a fan of S the origins are (n / S,), ray k * n /
//           S + i from origin i
//   tri:    float32 (n_tri, 16) rows in tri_sc's layout; with a walk, the
//           leaf rows (tables.py `walk_tables`: tri_sc rows in leaf order,
//           float kWalkId the row's index in tri_sc as int bits)
//   bvh:    null for the sweep, or float32 (n_rows >= 1, 16) child-pair rows
//           of a tree of `depth` levels
//   stack:  with a tree of more than kStack levels, int32 scratch of
//           3 x spill_entries(depth) x n entries for what the walks' stacks
//           hold past their shared-memory tier (deep_stack.cuh; else unused)
//   sph:    float32 (n_sph, 4) rows: center, radius (n_sph = 0: triangles only)
//   fan:    0, or S >= 1 for the fan form of the occlusion sweep (n a
//           multiple of S; refused with a walk or in the other modes)
//   out:    4 device pointers: t float32, prim int32, u float32, v float32
//           (only t is written, and only t need be given, with occlusion)
//   launched: 2 ints written back: the mode run (0 nearest, 1 occlusion,
//           2 triangles only; -1 if nothing was launched) and the form (0
//           the sweep in one shared-memory tile, 1 tiled, 2 the walk, 3 the
//           fan in one tile, 4 the fan tiled, 5 the walk of a deep tree)
// Returns 0 or the cudaError_t of a refused launch.
extern "C" int mcpt_intersect_prims(const void* const* rays, const void* tri, int n_tri,
                                    const void* bvh, int n_rows, int depth, void* stack,
                                    const void* sph,
                                    int n_sph, int sph_base, int n, int occlusion, int fan,
                                    void* const* out, void* stream, int* launched) {
  launched[0] = -1;
  launched[1] = 0;
  if (n <= 0) return 0;
  if (n_tri < 0 || n_sph < 0 || n_sph > kMaxSph || n_tri + n_sph <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bvh != nullptr &&
      (n_rows < 1 || n_tri < 1 || depth < 1 || (depth > kStack && stack == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fan < 0 || (fan > 0 && (!occlusion || bvh != nullptr || n % fan != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rays r{static_cast<const float*>(rays[0]), static_cast<const float*>(rays[1]),
               static_cast<const float*>(rays[2]), static_cast<const float*>(rays[3]),
               static_cast<const float*>(rays[4]), static_cast<const float*>(rays[5])};
  const Out o{static_cast<float*>(out[0]), static_cast<int*>(out[1]),
              static_cast<float*>(out[2]), static_cast<float*>(out[3])};
  const float* t = static_cast<const float*>(tri);
  const float* s = static_cast<const float*>(sph);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launched[0] = occlusion ? kOcclusion : (n_sph == 0 ? kTris : kNearest);
  cudaError_t e;
  if (bvh != nullptr && depth > kStack) {
    launched[1] = kDeepWalk;
    const float* b = static_cast<const float*>(bvh);
    int* k = static_cast<int*>(stack);
    e = occlusion ? launch_walk_deep<true>(r, b, t, s, n_sph, sph_base, n, o, k, depth, st)
                  : launch_walk_deep<false>(r, b, t, s, n_sph, sph_base, n, o, k, depth, st);
  } else if (bvh != nullptr) {
    launched[1] = kWalk;
    const float* b = static_cast<const float*>(bvh);
    e = occlusion ? launch_walk<true>(r, b, t, s, n_sph, sph_base, n, o, st)
                  : launch_walk<false>(r, b, t, s, n_sph, sph_base, n, o, st);
  } else if (fan > 0) {
    launched[1] = n_tri > kTile ? kFanTiled : kFan;
    e = launch_sweep<true, true>(r, t, n_tri, s, n_sph, sph_base, n / fan, fan, o, st);
  } else {
    launched[1] = n_tri > kTile ? kTiled : kSweep;
    e = occlusion ? launch_sweep<true, false>(r, t, n_tri, s, n_sph, sph_base, n, 0, o, st)
                  : launch_sweep<false, false>(r, t, n_tri, s, n_sph, sph_base, n, 0, o, st);
  }
  return static_cast<int>(e);
}
