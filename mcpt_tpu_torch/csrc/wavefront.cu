// The wavefront engine's kernels: the camera rays, the two shading halves of
// a bounce around the intersector (csrc/intersect_prims.cu), and the reverse
// clamp fold. One thread per lane.
//
// They replace no Pallas kernel: they are what XLA compiles under `jit` of
// mcpt_tpu's wavefront, `camera.py:55-107` (`generate_rays_c`) and
// `integrator.py:172-365` (`trace_paths_c`: the bounce body `:200-308` with
// `direct_lighting_c` `:91-165`, the reverse fold `:347-360`), which the port
// ran as some 5,000 eager torch ops a bounce. A bounce on the card is
// shade_pre, the intersector's occlusion fan and nearest query, shade_post:
// four launches.
//
// What bounds them on this card is bytes: a lane's state is read and written
// once a half, about 0.2-0.4 KB a lane a bounce (at 4 light samples: ray,
// hit, flags and channel in; next ray, fan origin, 4 shadow directions,
// thresholds and contributions, the NEE weight, leaf terms and the indirect
// weight out; the post half reads those back with the fan's t and the next
// hit, and writes the depth's records), against a few thousand float
// operations of shading. So each half reads a lane's state once, keeps the
// shading in registers, and derives the bounce's keys on the device from the
// path key's words (threefry2x32 of prng.py, in uint32): no key op, and no
// other op, runs on the host a bounce. Every lane runs every bounce, dead ones
// too, as in JAX, so the records match lane for lane; the fold reads a lane's
// records only up to its first terminal depth.
//
// Each kernel equals its plain version (kernels/wavefront_ref.py) bit for bit
// on the card: built with -fmad=false and without fast math, the same float32
// operations in the same order, torch's NaN rules where its clamp and
// maximum meet a NaN, and the BSDF, the material gather and the env lookup
// of mega_common.cuh (the device versions of what bsdf.py and envmap.py call).

#include "mega_common.cuh"
#include "wf_lights.cuh"
#include "wf_random.cuh"

namespace {

constexpr int kWfThreads = 256;
constexpr int kShadeCols = 11, kSphShadeCols = 5, kEmtCols = 17;

// torch.clamp, torch.clamp_min and torch.maximum on CUDA: a NaN input comes
// back as it is.
__device__ __forceinline__ float t_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float t_clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float t_maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// ---- camera_rays (camera.py generate_rays_c) --------------------------------

struct CamArgs {
  const long long* ids;
  const long long* key;
  float* out[6];  // o0 o1 o2 d0 d1 d2
  int n, per, width, height, dof;
  float aspect, scale, om[9], pos[3], focal, aperture;
};

__global__ void __launch_bounds__(kWfThreads) camera_rays_kernel(CamArgs A) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= A.n) return;
  const int pi = l / A.per;
  const long long id = A.ids[pi];
  const long long w = A.width;
  long long q = id / w, r = id - q * w;  // floor division, as torch's
  if (r != 0 && (r < 0) != (w < 0)) {
    r += w;
    q -= 1;
  }
  const float fi = static_cast<float>(r), fj = static_cast<float>(q);
  const Key k = load_key(A.key);
  const uint32_t base = 4u * static_cast<uint32_t>(pi);
  const float u0 = uniform_at(k, base), u1 = uniform_at(k, base + 1u);
  const float x = (1.0f - 2.0f * (fi + u0) / static_cast<float>(A.width)) * A.aspect * A.scale;
  const float y = (1.0f - 2.0f * (fj + u1) / static_cast<float>(A.height)) * A.scale;
  float o[3], dir[3];
  if (A.dof) {
    const float u2 = uniform_at(k, base + 2u), u3 = uniform_at(k, base + 3u);
    const float rr = A.aperture * sqrtf(u2);
    const float theta = kTwoPi * u3;
    const float dx = rr * cosf(theta), dy = rr * sinf(theta);
    const float zero = 0.0f;
    for (int c = 0; c < 3; ++c) {
      o[c] = A.pos[c] + (A.om[3 * c] * dx + A.om[3 * c + 1] * dy + A.om[3 * c + 2] * zero);
    }
    dir[0] = x * A.focal - dx;
    dir[1] = y * A.focal - dy;
    dir[2] = 1.0f * A.focal;
  } else {
    for (int c = 0; c < 3; ++c) o[c] = A.pos[c];
    dir[0] = x;
    dir[1] = y;
    dir[2] = 1.0f;
  }
  const float inv = 1.0f / sqrtf(dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2]);
  const float dn[3] = {dir[0] * inv, dir[1] * inv, dir[2] * inv};
  for (int c = 0; c < 3; ++c) {
    A.out[c][l] = o[c];
    A.out[3 + c][l] = A.om[3 * c] * dn[0] + A.om[3 * c + 1] * dn[1] + A.om[3 * c + 2] * dn[2];
  }
}

// ---- shade_pre (integrator.py _bounce up to the ray queries) ---------------

struct PreArgs {
  const float *o[3], *d[3], *t, *u, *v, *lam;
  const int* prim;
  const bool* alive;
  const long long *chan, *key;
  const float *tri_shade, *sph_shade, *emt, *intra, *mesh_area, *lcum;
  const int* emt_mesh;
  Tables T;  // the material table and the env map
  float *p_new[3], *wi[3], *p_dl[3], *ws[3], *thr, *contrib, *fac, *leaf_pre, *env_c, *w;
  bool *at_vertex, *rr_kill;
  int b, depth, n_tris, n_ts, n_sph, n_emt, n_lcum, s, n_sph_emitters, use_env;
  float total_area, rr_rate, inv_rr, bg[3];
};

// The env map along dir at the lane's channel, or the background's channel.
__device__ __forceinline__ float env_chan(const PreArgs& A, V3 dir, int chan) {
  return A.use_env ? env_lookup(A.T, dir, chan) : pick3(chan, A.bg[0], A.bg[1], A.bg[2]);
}

// lights.py sample_light_c of one lane from its draws lu: the two-stage pick
// (wf_lights.cuh light_pick), then the point, its normal, the emission at
// `chan` and the pdf.
__device__ void light_sample(const PreArgs& A, const float* lu, int chan, V3& lp, V3& ln,
                             float& emit, float& lpdf) {
  float mesh_area;
  const int sel = light_pick(A, lu, mesh_area);
  const float* row = A.emt + sel * kEmtCols;
  const float x = sqrtf(lu[2]), y = lu[3];
  const float wx = x * (1.0f - y), wy = x * y;
  lp = mk(row[0] + row[3] * wx + row[6] * wy, row[1] + row[4] * wx + row[7] * wy,
          row[2] + row[5] * wx + row[8] * wy);
  ln = mk(row[9], row[10], row[11]);
  if (A.n_sph_emitters && row[16] > 0.5f) {  // a uniform point on an emissive sphere
    const float ys = 1.0f - 2.0f * lu[2];
    const float sq = sqrtf(t_clamp_min(1.0f - ys * ys, 0.0f));
    const float ph = kTwoPi * lu[3];
    const V3 dv = mk(sq * cosf(ph), ys, sq * sinf(ph));
    lp = mk(row[0] + row[3] * dv.x, row[1] + row[3] * dv.y, row[2] + row[3] * dv.z);
    ln = dv;
  }
  emit = pick3(chan, row[12], row[13], row[14]);
  lpdf = 1.0f / t_clamp_min(mesh_area, 1e-20f);
}

__global__ void __launch_bounds__(kWfThreads) shade_pre_kernel(PreArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.b) return;
  const Key kd = fold_in(load_key(A.key), static_cast<uint32_t>(A.depth));
  const Key k_vtx = fold_in(kd, 0u), k_light = fold_in(kd, 1u);
  const V3 o = mk(A.o[0][i], A.o[1][i], A.o[2][i]);
  const V3 d = mk(A.d[0][i], A.d[1][i], A.d[2][i]);
  const int chan = static_cast<int>(A.chan[i]);
  const float lam = A.lam[i];

  // the surface at the nearest hit (intersect.py surface_at_c)
  const int prim = A.prim[i];
  const bool happened = prim >= 0;
  const bool is_tri = happened && prim < A.n_tris;
  const float t_eff = happened ? A.t[i] : 0.0f;
  const V3 p = mk(o.x + d.x * t_eff, o.y + d.y * t_eff, o.z + d.z * t_eff);
  float ts[kShadeCols], ss[kSphShadeCols];
  row_or_zero(A.tri_shade, is_tri ? prim : -1, A.n_ts, kShadeCols, ts);
  row_or_zero(A.sph_shade, happened && !is_tri ? prim - A.n_tris : -1, A.n_sph, kSphShadeCols,
              ss);
  const float hu = A.u[i], hv = A.v[i];
  const float w0 = 1.0f - hu - hv;
  const V3 ns = mk(p.x - ss[0], p.y - ss[1], p.z - ss[2]);
  const float ninv = 1.0f / t_clamp_min(sqrtf(ns.x * ns.x + ns.y * ns.y + ns.z * ns.z), 1e-20f);
  const V3 n = is_tri ? mk(ts[0], ts[1], ts[2]) : mk(ns.x * ninv, ns.y * ninv, ns.z * ninv);
  const float uvx = is_tri ? w0 * ts[3] + hu * ts[5] + hv * ts[7] : 0.0f;
  const float uvy = is_tri ? w0 * ts[4] + hu * ts[6] + hv * ts[8] : 0.0f;
  const long long mat = happened ? static_cast<long long>(is_tri ? ts[9] : ss[3]) : 0;
  const bool emissive = happened && (is_tri ? ts[10] : ss[4]) > 0.5f;

  const V3 wo = neg(d);
  const float env_leaf = env_chan(A, d, chan);  // miss: env/background (Scene.cpp:88-95)
  const Mat m = gather_mat(A.T, static_cast<float>(mat), chan);
  // depth-0 emitter hit (Scene.cpp:102-107)
  const float b_leaf = t_clamp(m.emit * fabsf(dot(wo, n)), 0.0f, 1.0f);
  const bool is_b = A.depth == 0 && happened && emissive;
  const bool alive = A.alive[i];
  const bool at_vertex = alive && happened && !is_b;

  // microfacet normal + Fresnel split (Scene.cpp:109-110)
  float xi[4];
  for (int c = 0; c < 4; ++c) xi[c] = uniform_at(k_vtx, 4u * static_cast<uint32_t>(i) + c);
  const V3 mfn = sample_mfn(m, n, xi[0], xi[1]);
  const float ior = m.ior_a + m.ior_b / (lam * lam);
  const float kr = fresnel(m, ior, d, mfn);

  // NEE from the scale-relative ε-offset point (Scene.cpp:113-119): per light
  // sample k (row k·B + i) its shadow ray and its contribution if visible
  const float off_scale = t_clamp_min(
      kRelEps * t_maximum(fabsf(p.x), t_maximum(fabsf(p.y), fabsf(p.z))), kEps);
  const V3 p_dl = mk(p.x + n.x * off_scale, p.y + n.y * off_scale, p.z + n.z * off_scale);
  const bool inner = dot(wo, n) < 0.0f;
  const float refl = m.textured > 0.5f ? chessboard(uvx, uvy) : m.refl;
  for (int k = 0; k < A.s; ++k) {
    const int r = k * A.b + i;
    float lu[4];
    for (int c = 0; c < 4; ++c) lu[c] = uniform_at(k_light, 4u * static_cast<uint32_t>(r) + c);
    V3 lp, ln;
    float emit, lpdf;
    light_sample(A, lu, chan, lp, ln, emit, lpdf);
    const V3 delta = sub(lp, p_dl);
    const float dist = sqrtf(t_clamp_min(dot(delta, delta), 1e-20f));
    const float inv_dist = 1.0f / dist;
    const V3 wsv = scale(delta, inv_dist);
    const float ev = eval_bsdf(m, ior, refl, wsv, wo, n, !inner);
    A.ws[0][r] = wsv.x;
    A.ws[1][r] = wsv.y;
    A.ws[2][r] = wsv.z;
    A.thr[r] = dist - t_clamp_min(kRelEps * dist, kEps);
    A.contrib[r] = emit * ev * dot(wsv, n) * -dot(wsv, ln) * (inv_dist * inv_dist) / lpdf /
                   static_cast<float>(A.s);
  }

  // Russian roulette + stochastic reflect/refract (Scene.cpp:121-159)
  const bool rr_kill = xi[2] >= A.rr_rate;
  const bool branch_reflect = xi[3] < kr;
  const float sign_reflect = dot(wo, mfn) < 0.0f ? -1.0f : 1.0f;
  const float os = off_scale * (branch_reflect ? sign_reflect : -sign_reflect);
  const V3 p_new = mk(p.x + n.x * os, p.y + n.y * os, p.z + n.z * os);
  const V3 wi = branch_reflect ? reflect(wo, mfn) : refract(ior, d, mfn);
  const float ev = eval_bsdf(m, ior, refl, wi, wo, n, branch_reflect);
  const float pv = pdf(m, ior, wi, wo, n, branch_reflect);
  // indirect weight (Scene.cpp:135-144,162-171), the reference's |wo·n|
  const float w_rough = fabsf(pv) > 1e-10f ? ev * fabsf(dot(wo, n)) / pv * A.inv_rr : 0.0f;
  const float env_ind = env_chan(A, wi, chan) * ev * A.inv_rr;

  A.p_new[0][i] = p_new.x;
  A.p_new[1][i] = p_new.y;
  A.p_new[2][i] = p_new.z;
  A.wi[0][i] = wi.x;
  A.wi[1][i] = wi.y;
  A.wi[2][i] = wi.z;
  A.p_dl[0][i] = p_dl.x;
  A.p_dl[1][i] = p_dl.y;
  A.p_dl[2][i] = p_dl.z;
  A.fac[i] = inner ? 1.0f - kr : kr;
  A.leaf_pre[i] = !alive ? 0.0f : (!happened ? env_leaf : b_leaf);
  A.env_c[i] = t_clamp(env_ind, 0.0f, kClampIndirect);
  A.w[i] = m.dirac > 0.5f ? ev * A.inv_rr : w_rough;
  A.at_vertex[i] = at_vertex;
  A.rr_kill[i] = rr_kill;
}

// ---- shade_post (the rest of the bounce body) -------------------------------

struct PostArgs {
  const float *sh_t, *thr, *contrib, *fac, *leaf_pre, *env_c, *w, *emissive;
  const bool *at_vertex, *rr_kill;
  const int* nxt_prim;
  float *l_dir, *w_rec, *leaf;
  bool *terminal, *alive;
  unsigned long long* rays;
  int b, s, n_emissive;
};

__global__ void __launch_bounds__(kWfThreads) shade_post_kernel(PostArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < A.b;
  bool at_vertex = false;
  if (in) {
    // visibility: no hit strictly closer than the light sample; the S-sum
    // from k = 0 up
    float total = 0.0f;
    for (int k = 0; k < A.s; ++k) {
      const int r = k * A.b + i;
      float c = A.contrib[r];
      if (A.sh_t != nullptr && !(A.sh_t[r] >= A.thr[r])) c = 0.0f;
      total = k == 0 ? c : total + c;
    }
    const float l_dir = A.fac[i] * total;
    const int np = A.nxt_prim[i];
    const bool nxt_emissive = np >= 0 && np < A.n_emissive && A.emissive[np] > 0.5f;
    at_vertex = A.at_vertex[i];
    const bool rr_kill = A.rr_kill[i];
    const bool cont = at_vertex && !rr_kill && np >= 0 && !nxt_emissive;
    // a roulette kill keeps the raw l_dir (Scene.cpp:129,156)
    const float vertex_leaf = rr_kill ? l_dir : t_clamp(l_dir, 0.0f, kClampDirect) + A.env_c[i];
    A.l_dir[i] = l_dir;
    A.w_rec[i] = A.w[i];
    A.leaf[i] = at_vertex ? vertex_leaf : A.leaf_pre[i];
    A.terminal[i] = !cont;
    A.alive[i] = cont;
  }
  // the bounce's rays: 1 + S a vertex, summed a block, one atomic a block
  const int vertices = __syncthreads_count(in && at_vertex);
  if (threadIdx.x == 0 && vertices > 0) {
    atomicAdd(A.rays, static_cast<unsigned long long>(vertices) *
                          static_cast<unsigned long long>(1 + A.s));
  }
}

// ---- fold (the reverse clamp scan) ------------------------------------------

struct FoldArgs {
  const float *l_dir, *w, *leaf;
  const bool* terminal;
  float* out;
  int b, depth;
};

// A terminal record replaces whatever the depths after it folded to, so the
// lane's value needs only its records up to its first terminal depth f: the
// thread finds f reading the flags forward, starts from leaf_f (0 where no
// depth is terminal) and folds the l_dir and w of the depths before f,
// bitwise the full reverse scan.
__global__ void __launch_bounds__(kWfThreads) fold_kernel(FoldArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.b) return;
  int f = 0;
  while (f < A.depth && !A.terminal[static_cast<size_t>(f) * A.b + i]) ++f;
  float radiance = f < A.depth ? A.leaf[static_cast<size_t>(f) * A.b + i] : 0.0f;
  for (int dd = f - 1; dd >= 0; --dd) {
    const size_t q = static_cast<size_t>(dd) * A.b + i;
    radiance = t_clamp(A.l_dir[q], 0.0f, kClampDirect) +
               t_clamp(A.w[q] * radiance, 0.0f, kClampIndirect);
  }
  A.out[i] = radiance;
}

inline int wf_blocks(int n) { return (n + kWfThreads - 1) / kWfThreads; }

inline int wf_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// The C entries: in/out arrays of device pointers, int and float parameters
// (see kernels/wavefront.py), the stream. Each returns 0 or the launch's
// cudaError, or -1 when it refuses its parameters; with no lanes it launches
// nothing.
extern "C" {

int mcpt_wf_camera(const void* const* in, void* const* out, const int* ip, const float* fp,
                   void* stream) {
  CamArgs A;
  A.ids = static_cast<const long long*>(in[0]);
  A.key = static_cast<const long long*>(in[1]);
  for (int k = 0; k < 6; ++k) A.out[k] = static_cast<float*>(out[k]);
  A.n = ip[0];
  A.per = ip[1];
  A.width = ip[2];
  A.height = ip[3];
  A.dof = ip[4];
  A.aspect = fp[0];
  A.scale = fp[1];
  for (int k = 0; k < 9; ++k) A.om[k] = fp[2 + k];
  for (int k = 0; k < 3; ++k) A.pos[k] = fp[11 + k];
  A.focal = fp[14];
  A.aperture = fp[15];
  if (A.n < 0 || A.per < 1 || A.width < 1 || A.height < 1) return -1;
  if (A.n == 0) return 0;
  camera_rays_kernel<<<wf_blocks(A.n), kWfThreads, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return wf_status();
}

int mcpt_wf_shade_pre(const void* const* in, void* const* out, const int* ip, const float* fp,
                      void* stream) {
  PreArgs A;
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
  const float* mat = static_cast<const float*>(in[16]);
  A.emt = static_cast<const float*>(in[17]);
  A.emt_mesh = static_cast<const int*>(in[18]);
  A.intra = static_cast<const float*>(in[19]);
  A.mesh_area = static_cast<const float*>(in[20]);
  A.lcum = static_cast<const float*>(in[21]);
  const float* env = static_cast<const float*>(in[22]);
  for (int k = 0; k < 3; ++k) {
    A.p_new[k] = static_cast<float*>(out[k]);
    A.wi[k] = static_cast<float*>(out[3 + k]);
    A.p_dl[k] = static_cast<float*>(out[6 + k]);
    A.ws[k] = static_cast<float*>(out[9 + k]);
  }
  A.thr = static_cast<float*>(out[12]);
  A.contrib = static_cast<float*>(out[13]);
  A.fac = static_cast<float*>(out[14]);
  A.leaf_pre = static_cast<float*>(out[15]);
  A.env_c = static_cast<float*>(out[16]);
  A.w = static_cast<float*>(out[17]);
  A.at_vertex = static_cast<bool*>(out[18]);
  A.rr_kill = static_cast<bool*>(out[19]);
  A.b = ip[0];
  A.depth = ip[1];
  A.n_tris = ip[2];
  A.n_ts = ip[3];
  A.n_sph = ip[4];
  const int n_mat = ip[5];
  A.n_emt = ip[6];
  A.n_lcum = ip[7];
  A.s = ip[8];
  A.n_sph_emitters = ip[9];
  A.use_env = ip[10];
  A.total_area = fp[0];
  A.rr_rate = fp[1];
  A.inv_rr = fp[2];
  for (int k = 0; k < 3; ++k) A.bg[k] = fp[3 + k];
  A.T = Tables{};
  A.T.mat = mat;
  A.T.n_mat = n_mat;
  A.T.env = env;
  A.T.env_h = ip[11];
  A.T.env_w = ip[12];
  if (A.b < 0 || A.depth < 0 || A.s < 0 || (A.s > 0 && (A.n_emt < 1 || A.n_lcum < 1)) ||
      A.T.env_h < 1 || A.T.env_w < 1) {
    return -1;
  }
  if (A.b == 0) return 0;
  shade_pre_kernel<<<wf_blocks(A.b), kWfThreads, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return wf_status();
}

int mcpt_wf_shade_post(const void* const* in, void* const* out, const int* ip, const float* fp,
                       void* stream) {
  (void)fp;
  PostArgs A;
  A.sh_t = static_cast<const float*>(in[0]);
  A.thr = static_cast<const float*>(in[1]);
  A.contrib = static_cast<const float*>(in[2]);
  A.fac = static_cast<const float*>(in[3]);
  A.leaf_pre = static_cast<const float*>(in[4]);
  A.env_c = static_cast<const float*>(in[5]);
  A.w = static_cast<const float*>(in[6]);
  A.at_vertex = static_cast<const bool*>(in[7]);
  A.rr_kill = static_cast<const bool*>(in[8]);
  A.nxt_prim = static_cast<const int*>(in[9]);
  A.emissive = static_cast<const float*>(in[10]);
  A.l_dir = static_cast<float*>(out[0]);
  A.w_rec = static_cast<float*>(out[1]);
  A.leaf = static_cast<float*>(out[2]);
  A.terminal = static_cast<bool*>(out[3]);
  A.alive = static_cast<bool*>(out[4]);
  A.rays = static_cast<unsigned long long*>(out[5]);
  A.b = ip[0];
  A.s = ip[1];
  A.n_emissive = ip[2];
  if (A.b < 0 || A.s < 0) return -1;
  if (A.b == 0) return 0;
  shade_post_kernel<<<wf_blocks(A.b), kWfThreads, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return wf_status();
}

int mcpt_wf_fold(const void* const* in, void* const* out, const int* ip, const float* fp,
                 void* stream) {
  (void)fp;
  FoldArgs A;
  A.l_dir = static_cast<const float*>(in[0]);
  A.w = static_cast<const float*>(in[1]);
  A.leaf = static_cast<const float*>(in[2]);
  A.terminal = static_cast<const bool*>(in[3]);
  A.out = static_cast<float*>(out[0]);
  A.b = ip[0];
  A.depth = ip[1];
  if (A.b < 0 || A.depth < 0) return -1;
  if (A.b == 0) return 0;
  fold_kernel<<<wf_blocks(A.b), kWfThreads, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return wf_status();
}

}  // extern "C"
