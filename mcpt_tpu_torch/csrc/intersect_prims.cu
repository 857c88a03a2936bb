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
// What it computes: one thread per ray. The thread reads its ray's six
// components from six contiguous float32 arrays (the wavefront's component
// form: no (B, 3) rows, no transposes), tests every triangle row in table
// order with `_tri_candidate`'s arithmetic (the Woop transform through the
// EPSILON-guarded determinant, inclusive barycentric bounds, t >= 0, and the
// row's `valid` flag; pad rows have nr2 = 0 and fail the determinant guard),
// then every sphere with `_sph_candidate`'s q-form roots. A candidate wins
// only with a strictly smaller t, so ties go to the lower primitive and
// triangles beat spheres. Sphere ids start at `sph_base` (the JAX pack's
// 128-padded triangle count, so ids index its shading tables). The float32
// expressions are the JAX ones in the JAX order; build with -fmad=false and
// without fast math so each product and sum rounds where the reference's
// does.
//
// Modes, chosen here from the arguments and reported back to the caller:
//   nearest   (occlusion = 0, n_sph > 0): t, prim (int32, -1 on a miss), u, v
//   occlusion (occlusion = 1): t only, with no winner bookkeeping
//   tris      (occlusion = 0, n_sph = 0): K4, triangles only
// The triangle table is staged through dynamic shared memory in tiles of at
// most kTile = 1024 rows (64 KB, above the 48 KB default: the launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize and reports any refusal). A
// table of at most kTile rows is one tile; a longer one (K3's range) is walked
// tile by tile with __syncthreads() between tiles, every thread still testing
// every row in order. The spheres sit in shared memory after the tile.
//
// What bounds it on this card: operations. Each (ray, triangle) pair is about
// 47 float32 operations and each (ray, sphere) pair about 25, on data that
// every thread of a warp reads from the same shared-memory address (a
// broadcast); bytes are 24 per ray in and at most 16 out. The design keeps
// the pair loop free of global loads and divergence other than the winner
// update. Packing rows for fewer shared-memory loads, or testing rays in
// warps against register-cached rows, is later work.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-4f;
constexpr float kTMax = 3e37f;
constexpr int kCols = 16;      // tri_sc row: w00..w22, c0..c2, nr2, valid, pad
constexpr int kTile = 1024;    // triangle rows per shared-memory tile
constexpr int kMaxSph = 4096;  // spheres held in shared memory
constexpr int kThreads = 256;

enum Mode { kNearest = 0, kOcclusion = 1, kTris = 2 };

struct Rays {
  const float *o0, *o1, *o2, *d0, *d1, *d2;
};

struct Out {
  float* t;
  int* prim;
  float* u;
  float* v;
};

template <bool OCC>
__global__ void __launch_bounds__(kThreads)
    intersect_prims(Rays r, const float* __restrict__ tri, int n_tri, const float* __restrict__ sph,
                    int n_sph, int sph_base, int n, Out out) {
  extern __shared__ float smem[];
  const int tile = n_tri < kTile ? n_tri : kTile;
  float* s_tri = smem;
  float* s_sph = smem + tile * kCols;
  for (int k = threadIdx.x; k < n_sph * 4; k += blockDim.x) s_sph[k] = sph[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float o0 = live ? r.o0[i] : 0.f, o1 = live ? r.o1[i] : 0.f, o2 = live ? r.o2[i] : 0.f;
  const float d0 = live ? r.d0[i] : 0.f, d1 = live ? r.d1[i] : 0.f, d2 = live ? r.d2[i] : 0.f;
  float t_best = kTMax, u_best = 0.f, v_best = 0.f;
  int prim = -1;

  for (int base = 0; base < n_tri; base += tile) {
    const int rows = n_tri - base < tile ? n_tri - base : tile;
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < rows * kCols; k += blockDim.x) {
      s_tri[k] = tri[static_cast<size_t>(base) * kCols + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < rows; ++j) {
      const float* w = s_tri + j * kCols;
      // _tri_candidate (intersect_pallas.py:262-298), in its order
      const float dp2 = d0 * w[6] + d1 * w[7] + d2 * w[8];
      const float op2 = o0 * w[6] + o1 * w[7] + o2 * w[8] - w[11];
      const float det = -(dp2 * w[12]);
      const bool okd = fabsf(det) >= kEps;
      const float det_g = okd ? det : 1.f;
      const float t = op2 * w[12] / det_g;
      const float dp0 = d0 * w[0] + d1 * w[1] + d2 * w[2];
      const float op0 = o0 * w[0] + o1 * w[1] + o2 * w[2] - w[9];
      const float u = op0 + t * dp0;
      const float dp1 = d0 * w[3] + d1 * w[4] + d2 * w[5];
      const float op1 = o0 * w[3] + o1 * w[4] + o2 * w[5] - w[10];
      const float v = op1 + t * dp1;
      const bool ok = okd && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f && t >= 0.f &&
                      w[13] > 0.5f;
      const float tc = ok ? t : kTMax;
      if (tc < t_best) {
        t_best = tc;
        if (!OCC) {
          prim = base + j;
          u_best = u;
          v_best = v;
        }
      }
    }
  }
  if (!live) return;

  // _sph_candidate (intersect_pallas.py:301-323) with the per-ray
  // invariants of `_kernel_sc`
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
  out.t[i] = t_best;
  if (!OCC) {
    out.prim[i] = prim;
    out.u[i] = u_best;
    out.v[i] = v_best;
  }
}

template <bool OCC>
cudaError_t launch(const Rays& r, const float* tri, int n_tri, const float* sph, int n_sph,
                   int sph_base, int n, const Out& out, cudaStream_t stream) {
  const int tile = n_tri < kTile ? n_tri : kTile;
  const size_t smem = (static_cast<size_t>(tile) * kCols + static_cast<size_t>(n_sph) * 4) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        intersect_prims<OCC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  intersect_prims<OCC><<<blocks, kThreads, smem, stream>>>(r, tri, n_tri, sph, n_sph, sph_base, n,
                                                           out);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes by kernels/intersect_prims.py).
//   rays:   6 device pointers to float32 (n,) arrays: o0, o1, o2, d0, d1, d2
//   tri:    float32 (n_tri, 16) rows in tri_sc's layout
//   sph:    float32 (n_sph, 4) rows: center, radius (n_sph = 0: triangles only)
//   out:    4 device pointers: t float32, prim int32, u float32, v float32
//           (only t is written, and only t need be given, with occlusion)
//   launched: 2 ints written back: the mode run (0 nearest, 1 occlusion,
//           2 triangles only; -1 if nothing was launched) and 1 if the
//           triangle table took more than one shared-memory tile
// Returns 0 or the cudaError_t of a refused launch.
extern "C" int mcpt_intersect_prims(const void* const* rays, const void* tri, int n_tri,
                                    const void* sph, int n_sph, int sph_base, int n,
                                    int occlusion, void* const* out, void* stream,
                                    int* launched) {
  launched[0] = -1;
  launched[1] = 0;
  if (n <= 0) return 0;
  if (n_tri < 0 || n_sph < 0 || n_sph > kMaxSph || n_tri + n_sph <= 0) {
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
  launched[1] = n_tri > kTile;
  cudaError_t e = occlusion ? launch<true>(r, t, n_tri, s, n_sph, sph_base, n, o, st)
                            : launch<false>(r, t, n_tri, s, n_sph, sph_base, n, o, st);
  return static_cast<int>(e);
}
