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
// hit, draws) through wf_vertex.cuh's pieces, keeping only the values that
// cross their boundaries, then runs each light sample forward and back,
// summing their adjoints of the vertex's values in sample order, then the
// vertex back through the hand-written reverses of its pieces (wf_vertex.cuh
// `*_bwd`); kernels/wavefront_ref.py shade_pre_bwd, over
// kernels/vertex_ref.py, is its plain version, the same operations in the
// same order. It writes a lane's row adjoints, not the tables':
// kernels/megakernel_ref.py fold_rows sums them per row in a fixed order, so
// a step's gradients are the same bits run after run (no float atomics).
// shade_post_bwd and fold_bwd follow their plain versions
// (wavefront_ref.shade_post_bwd, fold_bwd) in the same way.
//
// What bounds them on this card: shade_pre_bwd's integer hashing (the
// threefry draws) and float arithmetic against its bytes (chip_smoke.py
// counts each and says which bounds); shade_post_bwd and fold_bwd, bytes (a
// lane's records and adjoints). Built, as the forward, with -fmad=false and
// no fast math: each kernel equals its plain version bit for bit on the
// card.

#include "mega_common.cuh"
#include "wf_vertex.cuh"

namespace {

constexpr int kBwdThreads = 128;
// shade_pre_bwd's block and its cap of 4 blocks a SM (128 registers):
// measured 8% faster than uncapped (145 registers, no spills) and than 5
// blocks (96 registers), and as fast as 256 threads capped at 2 (mega_ab.py,
// the tile's depth-0 shape and the train step's, H100); the cap spills 96
// bytes a thread
constexpr int kPreBwdThreads = 128, kPreBwdBlocks = 4;
constexpr int kMatCols = 13;
constexpr float kClampDirectF = 15.0f, kClampIndirectF = 5.0f;

struct PreBwdArgs {
  VtxArgs V;
  // output gradients: the next ray (null at the last bounce), the leaf terms,
  // the light samples' contributions (S·B)
  const float *g_ray[6], *g_leaf[4], *g_contrib;
  float *g_o[3], *g_d[3], *g_mat;  // g_mat (B, 13): the lane's material row
  long long* mat_row;
  float* g_emt;  // (S·B, 17): each sample's emitter row
  long long* emt_row;
};

// One thread a lane, any block shape; every value in registers. The lane
// recomputes what its light samples read of its vertex (vertex_base) and
// runs each sample k from 0 up forward and back, adding its adjoints of
// the vertex's p_dl, n, wo, ior, roughness and reflectance to the lane's
// sums in sample order; then it recomputes its whole vertex (vertex_base
// again, vertex_rest: the loop holds only what the samples read, not what
// the vertex's reverse reads) and runs it back, piece by piece, last first: the leaves and the
// indirect weight, the next ray's env term, pdf and BSDF, reflect or
// refract, fac and kr, the microfacet normal, the offset points, the
// depth-0 emitter leaf, the env leaf of a miss, the surface. In the order of
// its plain version, wavefront_ref.shade_pre_bwd.
__global__ void __launch_bounds__(kPreBwdThreads, kPreBwdBlocks)
    shade_pre_bwd_kernel(PreBwdArgs P) {
  const VtxArgs& A = P.V;
  const int i = lane_index();
  if (i >= A.b) return;
  const BounceKeys keys = bounce_keys(A.key, A.depth);
  const V3 zero = mk(0.0f, 0.0f, 0.0f);

  // the light samples, forward and back
  V3 a_pdl = zero, a_n = zero, a_wo = zero;
  float a_ior = 0.0f, a_alpha = 0.0f, a_refl = 0.0f;
  const Vtx vs = vertex_base(A, i);
  for (int k = 0; k < A.s; ++k) {
    const Vtx& v = vs;
    const V3 n = v.S.n;
    const float mtype = v.m.mtype, alpha = v.m.rough;
    const size_t r = static_cast<size_t>(k) * A.b + i;
    const uint32_t base = 4u * static_cast<uint32_t>(r);
    const Key kl = keys.light;
    const float lu2 = uniform_at(kl, base + 2u), lu3 = uniform_at(kl, base + 3u);
    const Light L = light_sample(A, uniform_at(kl, base), uniform_at(kl, base + 1u), lu2, lu3,
                                 v.chan);
    const V3 delta = sub(L.p, v.p_dl);
    const float dd = dot(delta, delta);
    const float cl = t_clamp_min(dd, 1e-20f);
    const float inv_dist = 1.0f / sqrtf(cl);
    const V3 ws = scale(delta, inv_dist);
    const float dn = dot(ws, n), dl = dot(ws, L.n);
    const float q = inv_dist * inv_dist;
    // its contribution ((((emit·ev)·(ws·n))·(−ws·ln))·q)/pdf/s, backward;
    // eval_bsdf_bwd gives ev, which the seeds before it do not read
    const float g_a4 = qdiv(qdiv(P.g_contrib[r], static_cast<float>(A.s)), L.pdf);
    const float g_a3 = g_a4 * q;
    const float g_a2 = g_a3 * -dl;
    const float g_a1 = g_a2 * dn;
    const BsdfAdj e = eval_bsdf_bwd(mtype, v.ior, alpha, v.refl, ws, v.wo, n, !v.inner,
                                    g_a1 * L.emit);
    const float ev = e.f;
    const float a1 = L.emit * ev;
    const float a2 = a1 * dn;
    const float a3 = a2 * -dl;
    const float g_q = g_a4 * a3;
    const float g_dl = -(g_a3 * a2);
    const float g_dn = g_a2 * a1;
    const float g_emit = g_a1 * ev;
    const V3 g_ws = mk(e.wi.x + (g_dn * n.x + g_dl * L.n.x), e.wi.y + (g_dn * n.y + g_dl * L.n.y),
                       e.wi.z + (g_dn * n.z + g_dl * L.n.z));
    const V3 g_n = mk(e.n.x + g_dn * ws.x, e.n.y + g_dn * ws.y, e.n.z + g_dn * ws.z);
    const float g_inv = dot(g_ws, delta) + twice(g_q, inv_dist);
    const float g_dd = mask(dd >= 1e-20f, dsqrt(-g_inv * (inv_dist * inv_dist), cl));
    const V3 g_lp = mk(g_ws.x * inv_dist + twice(g_dd, delta.x),
                       g_ws.y * inv_dist + twice(g_dd, delta.y),
                       g_ws.z * inv_dist + twice(g_dd, delta.z));
    float g_row[kEmtCols];
    light_point_bwd(A, A.emt + L.sel * kEmtCols, lu2, lu3, v.chan, g_lp, scale(ws, g_dl), g_emit,
                    g_row);
    float* out = P.g_emt + r * kEmtCols;
#pragma unroll
    for (int c = 0; c < kEmtCols; ++c) out[c] = g_row[c];
    P.emt_row[r] = L.sel;
    a_pdl = sub(a_pdl, g_lp);
    a_n = add(a_n, g_n);
    a_wo = add(a_wo, e.wo);
    a_ior = a_ior + e.ior;
    a_alpha = a_alpha + e.alpha;
    a_refl = a_refl + e.refl;
  }

  const Vtx v = vertex_rest(A, vertex_base(A, i), i, keys.vtx);
  const Surf& S = v.S;
  const V3 n = S.n;
  const float mtype = v.m.mtype, alpha = v.m.rough;

  // the leaves and the indirect weight
  const float g_w = P.g_leaf[3][i], g_leaf = P.g_leaf[1][i], g_fac = P.g_leaf[0][i];
  const float g_env_ind = mask(v.env_ind >= 0.0f && v.env_ind <= kClampIndirectF, P.g_leaf[2][i]);
  const float g_t = g_env_ind * A.inv_rr;
  float g_ev = g_t * v.env_wi + mask(v.dirac, g_w * A.inv_rr);
  const float g_wr = mask(v.pv_ok, v.dirac ? 0.0f : g_w) * A.inv_rr;
  const float g_num = qdiv(g_wr, v.pvs);
  g_ev = g_ev + g_num * v.awon;
  const float g_awon = g_num * v.ev;
  const float g_pv = mask(v.pv_ok, -g_wr * qdiv(v.wr, v.pvs));
  // the next ray's direction: its env term, pdf, BSDF, reflect or refract
  const bool ray = P.g_ray[0] != nullptr;
  V3 g_wi = ray ? mk(P.g_ray[3][i], P.g_ray[4][i], P.g_ray[5][i]) : zero;
  if (A.use_env) g_wi = add(g_wi, env_bwd(A.T, v.wi, v.chan, g_t * v.ev));
  const BsdfAdj b1 = pdf_bwd(mtype, v.ior, alpha, v.wi, v.wo, n, v.branch, g_pv);
  const BsdfAdj b2 = eval_bsdf_bwd(mtype, v.ior, alpha, v.refl, v.wi, v.wo, n, v.branch, g_ev);
  g_wi = add(add(g_wi, b1.wi), b2.wi);
  V3 g_wo3 = zero, g_mfn = zero, g_d3 = zero, g_mfn3 = zero, g_d4, g_mfn4, g_n5;
  float gi3 = 0.0f, gi4, ga5;
  if (v.branch) {
    reflect_bwd(v.wo, v.mfn, g_wi, g_wo3, g_mfn);
  } else {
    refract_bwd(v.ior, v.d, v.mfn, g_wi, gi3, g_d3, g_mfn3);
  }
  // fac, then kr and the microfacet normal
  fresnel_bwd(mtype, v.ior, v.d, v.mfn, v.inner ? -g_fac : g_fac, gi4, g_d4, g_mfn4);
  sample_mfn_bwd(mtype, alpha, n, v.xi0, v.xi1, add(add(g_mfn, g_mfn3), g_mfn4), g_n5, ga5);
  // the next ray's origin p + n·(off_scale·sign) and the fan's p + n·off_scale
  const V3 g_pn = ray ? mk(P.g_ray[0][i], P.g_ray[1][i], P.g_ray[2][i]) : zero;
  const float os = v.off_scale * v.sign;
  const float g_off = dot(g_pn, n) * v.sign + dot(a_pdl, n);
  const float g_mx = mask(kRelEps * v.mx >= kEps, g_off) * kRelEps;
  const float m12 = t_maximum(v.a1, v.a2);
  const float h0 = v.a0 == m12 ? g_mx * 0.5f : g_mx;
  const float g_m12 = v.a0 > m12 ? 0.0f : h0;
  const float h1 = v.a1 == v.a2 ? g_m12 * 0.5f : g_m12;
  const V3 g_a = mk(v.a0 < m12 ? 0.0f : h0, v.a1 < v.a2 ? 0.0f : h1, v.a1 > v.a2 ? 0.0f : h1);
  const V3 g_p = mk((g_pn.x + a_pdl.x) + g_a.x * sgn(S.p.x),
                    (g_pn.y + a_pdl.y) + g_a.y * sgn(S.p.y),
                    (g_pn.z + a_pdl.z) + g_a.z * sgn(S.p.z));
  // the depth-0 emitter leaf clamp(emit·|wo·n|, 0, 1)
  const float bl = v.m.emit * v.awon;
  const float g_bl = mask(v.alive && S.happened && bl >= 0.0f && bl <= 1.0f, g_leaf);
  const float g_emit = g_bl * v.awon;
  const float g_won = (g_awon + g_bl * v.m.emit) * sgn(v.won);
  // the next ray's origin and the fan's, the samples', pdf's, eval's,
  // sample_mfn's and the emitter leaf's adjoints of n, in that order
  const V3 g_nr = mk(a_n.x + (g_pn.x * os + a_pdl.x * v.off_scale),
                     a_n.y + (g_pn.y * os + a_pdl.y * v.off_scale),
                     a_n.z + (g_pn.z * os + a_pdl.z * v.off_scale));
  const V3 g_n = mk((((g_nr.x + b1.n.x) + b2.n.x) + g_n5.x) + g_won * v.wo.x,
                    (((g_nr.y + b1.n.y) + b2.n.y) + g_n5.y) + g_won * v.wo.y,
                    (((g_nr.z + b1.n.z) + b2.n.z) + g_n5.z) + g_won * v.wo.z);
  const V3 g_wo = mk((((a_wo.x + b1.wo.x) + b2.wo.x) + g_wo3.x) + g_won * n.x,
                     (((a_wo.y + b1.wo.y) + b2.wo.y) + g_wo3.y) + g_won * n.y,
                     (((a_wo.z + b1.wo.z) + b2.wo.z) + g_wo3.z) + g_won * n.z);
  const float g_ior = (((a_ior + b1.ior) + b2.ior) + gi3) + gi4;
  const float g_alpha = ((a_alpha + b1.alpha) + b2.alpha) + ga5;
  const float g_refl = v.m.textured > 0.5f ? 0.0f : a_refl + b2.refl;
  // the ray: wo = -d, the env leaf of a miss, the surface
  V3 g_d = sub(add(g_d3, g_d4), g_wo);
  if (A.use_env) g_d = add(g_d, env_bwd(A.T, v.d, v.chan, mask(v.alive && !S.happened, g_leaf)));
  V3 g_o, g_dp;
  surface_bwd(S, v.o, v.d, g_p, g_n, g_o, g_dp);
  g_d = add(g_d, g_dp);
  P.g_o[0][i] = g_o.x;
  P.g_o[1][i] = g_o.y;
  P.g_o[2][i] = g_o.z;
  P.g_d[0][i] = g_d.x;
  P.g_d[1][i] = g_d.y;
  P.g_d[2][i] = g_d.z;
  // the material row (mat_fields: ior_a, ior_b, rough, refl and emit at chan)
  float* gm = P.g_mat + static_cast<size_t>(i) * kMatCols;
  const bool ok = v.ok;
  gm[0] = 0.0f;
  gm[1] = mask(ok, g_ior);
  gm[2] = mask(ok, qdiv(g_ior, v.lam * v.lam));
  gm[3] = mask(ok, g_alpha);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gm[4 + c] = mask(ok && v.chan == c, g_refl);
    gm[7 + c] = mask(ok && v.chan == c, g_emit);
  }
  gm[10] = 0.0f;
  gm[11] = 0.0f;
  gm[12] = 0.0f;
  P.mat_row[i] = v.row;
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
                             : t_clamp(A.l_dir[q], 0.0f, kClampDirectF) +
                                   t_clamp(A.w[q] * radiance, 0.0f, kClampIndirectF);
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
  PreBwdArgs P;
  if (!unpack_vtx(in, ip, fp, P.V)) return -1;
  for (int k = 0; k < 6; ++k) P.g_ray[k] = static_cast<const float*>(in[24 + k]);
  for (int k = 0; k < 4; ++k) P.g_leaf[k] = static_cast<const float*>(in[30 + k]);
  P.g_contrib = static_cast<const float*>(in[34]);
  for (int k = 0; k < 3; ++k) {
    P.g_o[k] = static_cast<float*>(out[k]);
    P.g_d[k] = static_cast<float*>(out[3 + k]);
  }
  P.g_mat = static_cast<float*>(out[6]);
  P.mat_row = static_cast<long long*>(out[7]);
  P.g_emt = static_cast<float*>(out[8]);
  P.emt_row = static_cast<long long*>(out[9]);
  if (P.V.s > 0 && P.g_contrib == nullptr) return -1;
  for (int k = 0; k < 6; ++k) {
    if ((P.g_ray[k] != nullptr) != (P.g_ray[0] != nullptr)) return -1;
  }
  for (int k = 0; k < 4; ++k) {
    if (P.g_leaf[k] == nullptr) return -1;
  }
  if (P.V.b == 0) return 0;
  const int blocks = (P.V.b + kPreBwdThreads - 1) / kPreBwdThreads;
  shade_pre_bwd_kernel<<<blocks, kPreBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
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
