// The wavefront's backward kernels: the reverse modes of shade_pre,
// shade_post and fold (csrc/wavefront.cu), which the training path's
// torch.autograd.Functions launch (kernels/wavefront.py). One thread per lane.
//
// They replace no Pallas kernel: JAX's train step is jax.value_and_grad under
// jit (mcpt_tpu/diff.py:136), and XLA compiles the bounce's backward as it
// compiles its forward, which wavefront.cu ports. Gradients reach what
// autograd of the plain forward reaches: a lane's o and d (through p = o +
// t·d, t detached), its material row and its light samples' emitter rows,
// and through those mat_fat and emt_fat.
//
// shade_pre_bwd recomputes the lane's vertex from the bounce's inputs (ray,
// hit, draws), then runs each light sample forward and back, summing their
// adjoints of the vertex's values in sample order, then the vertex back: the
// straight-line code of csrc/wavefront_bwd_lanes.cuh, generated from the
// plain forward (kernels/wavefront_lanes.py), which kernels/wavefront_ref.py
// replays op for op as the plain version. It writes a lane's row adjoints,
// not the tables': kernels/megakernel_ref.py fold_rows sums them per row in a
// fixed order, so a step's gradients are the same bits run after run (no
// float atomics). shade_post_bwd and fold_bwd are written out by hand, in the
// order of their plain versions (wavefront_ref.shade_post_bwd, fold_bwd).
//
// What bounds them on this card: bytes, each input read and each output
// written once. shade_pre_bwd only just: about 2,100 float operations a lane
// for the vertex and 1,070 a light sample against about 200 bytes of inputs
// and row adjoints a lane and 76 a sample (at 4 samples, 0.029 ms of bytes
// against 0.019 of operations for 196,608 lanes); shade_post_bwd and
// fold_bwd are a lane's records and adjoints. Built, as the forward, with -fmad=false and no fast
// math: each kernel equals its plain version bit for bit on the card.

#include "mega_common.cuh"
#include "wf_lights.cuh"
#include "wf_random.cuh"
#include "wavefront_bwd_lanes.cuh"

namespace {

constexpr int kBwdThreads = 128;
constexpr int kTsCols = 11, kSsCols = 5, kMatCols = 13, kEmtCols = 17;
constexpr float kClampDirectF = 15.0f, kClampIndirectF = 5.0f;

struct PreBwdArgs {
  const float *o[3], *d[3], *t, *u, *v, *lam;
  const int* prim;
  const bool* alive;
  const long long *chan, *key;
  const float *tri_shade, *sph_shade, *mat, *emt, *intra, *mesh_area, *lcum, *env;
  const int* emt_mesh;
  // output gradients: the next ray (null at the last bounce), the leaf terms,
  // the light samples' contributions (S·B)
  const float *g_ray[6], *g_leaf[4], *g_contrib;
  float *g_o[3], *g_d[3], *g_mat;  // g_mat (B, 13): the lane's material row
  long long* mat_row;
  float* g_emt;  // (S·B, 17): each sample's emitter row
  long long* emt_row;
  int b, depth, n_tris, n_ts, n_sph, n_mat, n_emt, n_lcum, s, n_sph_emitters;
  float total_area;
  VtxPar P;
};

template <bool ENV, bool RAY>
__global__ void __launch_bounds__(kBwdThreads) shade_pre_bwd_kernel(PreBwdArgs A) {
  // the lanes' value slots (wavefront_bwd_lanes.cuh) sit at threadIdx.y, a
  // zero the compiler cannot fold, and are in bounds only in a 1-D block
  if (blockDim.y != 1 || blockDim.z != 1) __trap();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.b) return;
  const Key kd = fold_in(load_key(A.key), static_cast<uint32_t>(A.depth));
  const Key k_vtx = fold_in(kd, 0u), k_light = fold_in(kd, 1u);

  // the vertex's inputs: wavefront_ref.vertex_inputs
  VtxIn in;
  in.o0 = A.o[0][i];
  in.o1 = A.o[1][i];
  in.o2 = A.o[2][i];
  in.d0 = A.d[0][i];
  in.d1 = A.d[1][i];
  in.d2 = A.d[2][i];
  in.t = A.t[i];
  in.u = A.u[i];
  in.v = A.v[i];
  in.lam = A.lam[i];
  in.chan = A.chan[i];
  in.alive = A.alive[i];
  const int prim = A.prim[i];
  in.happened = prim >= 0;
  in.is_tri = in.happened && prim < A.n_tris;
  float ts[kTsCols], ss[kSsCols];
  row_or_zero(A.tri_shade, in.is_tri ? prim : -1, A.n_ts, kTsCols, ts);
  row_or_zero(A.sph_shade, in.happened && !in.is_tri ? prim - A.n_tris : -1, A.n_sph, kSsCols,
              ss);
  in.ts0 = ts[0];
  in.ts1 = ts[1];
  in.ts2 = ts[2];
  in.ts3 = ts[3];
  in.ts4 = ts[4];
  in.ts5 = ts[5];
  in.ts6 = ts[6];
  in.ts7 = ts[7];
  in.ts8 = ts[8];
  in.ts9 = ts[9];
  in.ts10 = ts[10];
  in.ss0 = ss[0];
  in.ss1 = ss[1];
  in.ss2 = ss[2];
  in.ss3 = ss[3];
  in.ss4 = ss[4];
  const long long mat = in.happened ? static_cast<long long>(in.is_tri ? ts[9] : ss[3]) : 0;
  const bool emissive = in.happened && (in.is_tri ? ts[10] : ss[4]) > 0.5f;
  in.is_b = A.depth == 0 && emissive;
  // megakernel_ref.mat_rows: the id clamped into the table, ok if it names a row
  const float mat_id = static_cast<float>(mat);
  const long long row = min(max(static_cast<long long>(mat_id), 0LL),
                            static_cast<long long>(A.n_mat - 1));
  in.mat_ok = mat_id == static_cast<float>(row);
  const float* m = A.mat + row * kMatCols;
  in.m0 = m[0];
  in.m1 = m[1];
  in.m2 = m[2];
  in.m3 = m[3];
  in.m4 = m[4];
  in.m5 = m[5];
  in.m6 = m[6];
  in.m7 = m[7];
  in.m8 = m[8];
  in.m9 = m[9];
  in.m10 = m[10];
  in.m11 = m[11];
  in.m12 = m[12];
  in.xi0 = uniform_at(k_vtx, 4u * static_cast<uint32_t>(i));
  in.xi1 = uniform_at(k_vtx, 4u * static_cast<uint32_t>(i) + 1u);
  in.xi2 = uniform_at(k_vtx, 4u * static_cast<uint32_t>(i) + 2u);
  in.xi3 = uniform_at(k_vtx, 4u * static_cast<uint32_t>(i) + 3u);

  VtxSeed g;
  g.p_new0 = RAY ? A.g_ray[0][i] : 0.0f;
  g.p_new1 = RAY ? A.g_ray[1][i] : 0.0f;
  g.p_new2 = RAY ? A.g_ray[2][i] : 0.0f;
  g.wi0 = RAY ? A.g_ray[3][i] : 0.0f;
  g.wi1 = RAY ? A.g_ray[4][i] : 0.0f;
  g.wi2 = RAY ? A.g_ray[5][i] : 0.0f;
  g.fac = A.g_leaf[0][i];
  g.leaf_pre = A.g_leaf[1][i];
  g.env_c = A.g_leaf[2][i];
  g.w = A.g_leaf[3][i];

  // light sample k of lane i (row k·B + i): forward and back, its adjoints
  // of the vertex's values summed from k = 0 up
  auto samples = [&](const Shared& sh, SharedAdj& acc) {
    for (int k = 0; k < A.s; ++k) {
      const size_t r = static_cast<size_t>(k) * A.b + i;
      float lu[4];
      for (int c = 0; c < 4; ++c) lu[c] = uniform_at(k_light, 4u * static_cast<uint32_t>(r) + c);
      SmpIn smp;
      const int sel = light_pick(A, lu, smp.mesh_area);
      const float* e = A.emt + sel * kEmtCols;
      smp.e0 = e[0];
      smp.e1 = e[1];
      smp.e2 = e[2];
      smp.e3 = e[3];
      smp.e4 = e[4];
      smp.e5 = e[5];
      smp.e6 = e[6];
      smp.e7 = e[7];
      smp.e8 = e[8];
      smp.e9 = e[9];
      smp.e10 = e[10];
      smp.e11 = e[11];
      smp.e12 = e[12];
      smp.e13 = e[13];
      smp.e14 = e[14];
      smp.e15 = e[15];
      smp.e16 = e[16];
      smp.lu2 = lu[2];
      smp.lu3 = lu[3];
      smp.chan = in.chan;
      SharedAdj a;
      SmpAdj ge;
      if (A.n_sph_emitters) {
        sample_sph1(sh, smp, A.s, A.g_contrib[r], a, ge);
      } else {
        sample_sph0(sh, smp, A.s, A.g_contrib[r], a, ge);
      }
      add_shared(acc, a);
      float* ge_row = A.g_emt + r * kEmtCols;
      const float ge_v[kEmtCols] = {ge.e0,  ge.e1,  ge.e2,  ge.e3,  ge.e4,  ge.e5,
                                    ge.e6,  ge.e7,  ge.e8,  ge.e9,  ge.e10, ge.e11,
                                    ge.e12, ge.e13, ge.e14, ge.e15, ge.e16};
      for (int c = 0; c < kEmtCols; ++c) ge_row[c] = ge_v[c];
      A.emt_row[r] = sel;
    }
  };

  VtxAdj out;
  if constexpr (ENV) {
    if constexpr (RAY) {
      vertex_env1_ray1(in, A.P, g, samples, out);
    } else {
      vertex_env1_ray0(in, A.P, g, samples, out);
    }
  } else {
    if constexpr (RAY) {
      vertex_env0_ray1(in, A.P, g, samples, out);
    } else {
      vertex_env0_ray0(in, A.P, g, samples, out);
    }
  }
  A.g_o[0][i] = out.o0;
  A.g_o[1][i] = out.o1;
  A.g_o[2][i] = out.o2;
  A.g_d[0][i] = out.d0;
  A.g_d[1][i] = out.d1;
  A.g_d[2][i] = out.d2;
  const float gm[kMatCols] = {out.m0, out.m1, out.m2, out.m3,  out.m4,  out.m5, out.m6,
                              out.m7, out.m8, out.m9, out.m10, out.m11, out.m12};
  float* gm_row = A.g_mat + static_cast<size_t>(i) * kMatCols;
  for (int c = 0; c < kMatCols; ++c) gm_row[c] = gm[c];
  A.mat_row[i] = row;
}

// ---- shade_post_bwd (wavefront_ref.shade_post_bwd) --------------------------

struct PostBwdArgs {
  const float *sh_t, *thr, *contrib, *fac, *g_l_dir, *g_w, *g_leaf;
  const bool *at_vertex, *rr_kill;
  float *g_contrib, *g_fac, *g_leaf_pre, *g_env_c, *g_w_out;
  int b, s;
};

__global__ void __launch_bounds__(kBwdThreads) shade_post_bwd_kernel(PostBwdArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.b) return;
  float total = 0.0f;
  for (int k = 0; k < A.s; ++k) {
    const size_t r = static_cast<size_t>(k) * A.b + i;
    float c = A.contrib[r];
    if (A.sh_t != nullptr && !(A.sh_t[r] >= A.thr[r])) c = 0.0f;
    total = k == 0 ? c : total + c;
  }
  const float fac = A.fac[i];
  const float l_dir = fac * total;
  const bool at_vertex = A.at_vertex[i], rr_kill = A.rr_kill[i];
  const float g_leaf = A.g_leaf[i];
  const float gv = at_vertex ? g_leaf : 0.0f;  // the vertex's leaf
  A.g_leaf_pre[i] = at_vertex ? 0.0f : g_leaf;
  A.g_env_c[i] = rr_kill ? 0.0f : gv;
  const bool inside = l_dir >= 0.0f && l_dir <= kClampDirectF;
  const float g_l = (A.g_l_dir[i] + (rr_kill ? gv : 0.0f)) + (inside && !rr_kill ? gv : 0.0f);
  A.g_fac[i] = g_l * total;
  const float g_total = g_l * fac;
  for (int k = 0; k < A.s; ++k) {
    const size_t r = static_cast<size_t>(k) * A.b + i;
    A.g_contrib[r] = A.sh_t != nullptr && !(A.sh_t[r] >= A.thr[r]) ? 0.0f : g_total;
  }
  A.g_w_out[i] = A.g_w[i];
}

// ---- fold_bwd (wavefront_ref.fold_bwd) ---------------------------------------

struct FoldBwdArgs {
  const float *l_dir, *w, *leaf, *g;
  const bool* terminal;
  float *g_l_dir, *g_w, *g_leaf;
  int b, depth;
};

// The forward scan first, each depth's incoming radiance L_{d+1} parked in
// g_w's slot d, then autograd's reverse from depth 0 through every depth.
__global__ void __launch_bounds__(kBwdThreads) fold_bwd_kernel(FoldBwdArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.b) return;
  float radiance = 0.0f;
  for (int k = A.depth - 1; k >= 0; --k) {
    const size_t q = static_cast<size_t>(k) * A.b + i;
    A.g_w[q] = radiance;
    radiance = A.terminal[q] ? A.leaf[q]
                             : ad_clamp(A.l_dir[q], 0.0f, kClampDirectF) +
                                   ad_clamp(A.w[q] * radiance, 0.0f, kClampIndirectF);
  }
  float g = A.g[i];
  for (int k = 0; k < A.depth; ++k) {
    const size_t q = static_cast<size_t>(k) * A.b + i;
    const bool term = A.terminal[q];
    A.g_leaf[q] = term ? g : 0.0f;
    const float gn = term ? 0.0f : g;
    const float l = A.l_dir[q];
    A.g_l_dir[q] = l >= 0.0f && l <= kClampDirectF ? gn : 0.0f;
    const float nxt = A.g_w[q], w = A.w[q];
    const float z = w * nxt;
    const float gz = z >= 0.0f && z <= kClampIndirectF ? gn : 0.0f;
    A.g_w[q] = gz * nxt;
    g = gz * w;
  }
}

inline int blocks_of(int n) { return (n + kBwdThreads - 1) / kBwdThreads; }

inline int bwd_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// The C entries: in/out arrays of device pointers, int and float parameters
// (see kernels/wavefront.py), the stream. Each returns 0 or the launch's
// cudaError, or -1 when it refuses its parameters; with no lanes it launches
// nothing.
extern "C" {

int mcpt_wf_shade_pre_bwd(const void* const* in, void* const* out, const int* ip,
                          const float* fp, void* stream) {
  PreBwdArgs A;
  for (int k = 0; k < 3; ++k) {
    A.o[k] = static_cast<const float*>(in[k]);
    A.d[k] = static_cast<const float*>(in[3 + k]);
  }
  A.t = static_cast<const float*>(in[6]);
  A.prim = static_cast<const int*>(in[7]);
  A.u = static_cast<const float*>(in[8]);
  A.v = static_cast<const float*>(in[9]);
  A.alive = static_cast<const bool*>(in[10]);
  A.lam = static_cast<const float*>(in[11]);
  A.chan = static_cast<const long long*>(in[12]);
  A.key = static_cast<const long long*>(in[13]);
  A.tri_shade = static_cast<const float*>(in[14]);
  A.sph_shade = static_cast<const float*>(in[15]);
  A.mat = static_cast<const float*>(in[16]);
  A.emt = static_cast<const float*>(in[17]);
  A.emt_mesh = static_cast<const int*>(in[18]);
  A.intra = static_cast<const float*>(in[19]);
  A.mesh_area = static_cast<const float*>(in[20]);
  A.lcum = static_cast<const float*>(in[21]);
  A.env = static_cast<const float*>(in[22]);
  for (int k = 0; k < 6; ++k) A.g_ray[k] = static_cast<const float*>(in[23 + k]);
  for (int k = 0; k < 4; ++k) A.g_leaf[k] = static_cast<const float*>(in[29 + k]);
  A.g_contrib = static_cast<const float*>(in[33]);
  for (int k = 0; k < 3; ++k) {
    A.g_o[k] = static_cast<float*>(out[k]);
    A.g_d[k] = static_cast<float*>(out[3 + k]);
  }
  A.g_mat = static_cast<float*>(out[6]);
  A.mat_row = static_cast<long long*>(out[7]);
  A.g_emt = static_cast<float*>(out[8]);
  A.emt_row = static_cast<long long*>(out[9]);
  A.b = ip[0];
  A.depth = ip[1];
  A.n_tris = ip[2];
  A.n_ts = ip[3];
  A.n_sph = ip[4];
  A.n_mat = ip[5];
  A.n_emt = ip[6];
  A.n_lcum = ip[7];
  A.s = ip[8];
  A.n_sph_emitters = ip[9];
  const int use_env = ip[10];
  A.P.env_h = ip[11];
  A.P.env_w = ip[12];
  A.total_area = fp[0];
  A.P.rr_rate = fp[1];
  A.P.inv_rr = fp[2];
  A.P.bg0 = fp[3];
  A.P.bg1 = fp[4];
  A.P.bg2 = fp[5];
  A.P.env = A.env;
  const bool ray = A.g_ray[0] != nullptr;
  if (A.b < 0 || A.depth < 0 || A.s < 0 || A.n_mat < 1 ||
      (A.s > 0 && (A.n_emt < 1 || A.n_lcum < 1 || A.g_contrib == nullptr)) ||
      A.P.env_h < 1 || A.P.env_w < 1) {
    return -1;
  }
  for (int k = 0; k < 6; ++k) {
    if ((A.g_ray[k] != nullptr) != ray) return -1;
  }
  for (int k = 0; k < 4; ++k) {
    if (A.g_leaf[k] == nullptr) return -1;
  }
  if (A.b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = blocks_of(A.b);
  if (use_env) {
    if (ray) {
      shade_pre_bwd_kernel<true, true><<<n, kBwdThreads, 0, st>>>(A);
    } else {
      shade_pre_bwd_kernel<true, false><<<n, kBwdThreads, 0, st>>>(A);
    }
  } else if (ray) {
    shade_pre_bwd_kernel<false, true><<<n, kBwdThreads, 0, st>>>(A);
  } else {
    shade_pre_bwd_kernel<false, false><<<n, kBwdThreads, 0, st>>>(A);
  }
  return bwd_status();
}

int mcpt_wf_shade_post_bwd(const void* const* in, void* const* out, const int* ip,
                           const float* fp, void* stream) {
  (void)fp;
  PostBwdArgs A;
  A.sh_t = static_cast<const float*>(in[0]);
  A.thr = static_cast<const float*>(in[1]);
  A.contrib = static_cast<const float*>(in[2]);
  A.fac = static_cast<const float*>(in[3]);
  A.at_vertex = static_cast<const bool*>(in[4]);
  A.rr_kill = static_cast<const bool*>(in[5]);
  A.g_l_dir = static_cast<const float*>(in[6]);
  A.g_w = static_cast<const float*>(in[7]);
  A.g_leaf = static_cast<const float*>(in[8]);
  A.g_contrib = static_cast<float*>(out[0]);
  A.g_fac = static_cast<float*>(out[1]);
  A.g_leaf_pre = static_cast<float*>(out[2]);
  A.g_env_c = static_cast<float*>(out[3]);
  A.g_w_out = static_cast<float*>(out[4]);
  A.b = ip[0];
  A.s = ip[1];
  if (A.b < 0 || A.s < 0) return -1;
  if (A.b == 0) return 0;
  shade_post_bwd_kernel<<<blocks_of(A.b), kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return bwd_status();
}

int mcpt_wf_fold_bwd(const void* const* in, void* const* out, const int* ip, const float* fp,
                     void* stream) {
  (void)fp;
  FoldBwdArgs A;
  A.l_dir = static_cast<const float*>(in[0]);
  A.w = static_cast<const float*>(in[1]);
  A.leaf = static_cast<const float*>(in[2]);
  A.terminal = static_cast<const bool*>(in[3]);
  A.g = static_cast<const float*>(in[4]);
  A.g_l_dir = static_cast<float*>(out[0]);
  A.g_w = static_cast<float*>(out[1]);
  A.g_leaf = static_cast<float*>(out[2]);
  A.b = ip[0];
  A.depth = ip[1];
  if (A.b < 0 || A.depth < 0) return -1;
  if (A.b == 0) return 0;
  fold_bwd_kernel<<<blocks_of(A.b), kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return bwd_status();
}

}  // extern "C"
