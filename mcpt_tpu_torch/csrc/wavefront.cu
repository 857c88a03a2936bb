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
// What bounds them on this card: a lane's state is read and written once a
// half, about 0.2-0.4 KB a lane a bounce (at 4 light samples: ray, hit,
// flags and channel in; next ray, fan origin, 4 shadow directions,
// thresholds and contributions, the NEE weight, leaf terms and the indirect
// weight out; the post half reads those back with the fan's t and the next
// hit, and writes the depth's records), against a few thousand float
// operations of shading and, in camera_rays and shade_pre, the threefry
// hashes of the draws, which bound those two (about 1,600 integer
// operations a lane at 4 samples). So each half reads a lane's state once,
// keeps the shading in registers, and derives the bounce's keys on the
// device from the path key's words (threefry2x32 of prng.py, in uint32): no
// key op, and no other op, runs on the host a bounce. Every lane runs every
// bounce, dead ones too, as in JAX, so the records match lane for lane; the
// fold reads a lane's records only up to its first terminal depth.
//
// Each kernel equals its plain version (kernels/wavefront_ref.py) bit for bit
// on the card: built with -fmad=false and without fast math, the same float32
// operations in the same order, torch's NaN rules where its clamp and
// maximum meet a NaN, and the BSDF, the material gather and the env lookup
// of mega_common.cuh (the device versions of what bsdf.py and envmap.py call)
// through the vertex's pieces in wf_vertex.cuh, which shade_pre_bwd shares.

#include "mega_common.cuh"
#include "wf_vertex.cuh"

namespace {

constexpr int kWfThreads = 256;
// shade_pre's block: 512 threads measured 7% faster than 256 and 10% than
// 128 (mega_ab.py, the tile's depth-0 shape and the train step's, H100)
constexpr int kPreThreads = 512;

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
  VtxArgs V;
  float *p_new[3], *wi[3], *p_dl[3], *ws[3], *thr, *contrib, *fac, *leaf_pre, *env_c, *w;
  bool *at_vertex, *rr_kill;
};

// One thread a lane: its vertex (wf_vertex.cuh vertex_base, vertex_rest),
// then per light sample k (row k·B + i) its shadow ray and its contribution
// if visible.
__global__ void __launch_bounds__(kPreThreads) shade_pre_kernel(PreArgs P) {
  const VtxArgs& A = P.V;
  const int i = lane_index();
  if (i >= A.b) return;
  const BounceKeys keys = bounce_keys(A.key, A.depth);
  const Vtx v = vertex_rest(A, vertex_base(A, i), i, keys.vtx);
  const Key k_light = keys.light;
  const V3 n = v.S.n;
  for (int k = 0; k < A.s; ++k) {
    const size_t r = static_cast<size_t>(k) * A.b + i;
    const uint32_t base = 4u * static_cast<uint32_t>(r);
    const Light L = light_sample(A, uniform_at(k_light, base), uniform_at(k_light, base + 1u),
                                 uniform_at(k_light, base + 2u), uniform_at(k_light, base + 3u),
                                 v.chan);
    const V3 delta = sub(L.p, v.p_dl);
    const float dist = sqrtf(t_clamp_min(dot(delta, delta), 1e-20f));
    const float inv_dist = 1.0f / dist;
    const V3 wsv = scale(delta, inv_dist);
    const float ev = eval_bsdf(v.m, v.ior, v.refl, wsv, v.wo, n, !v.inner);
    P.ws[0][r] = wsv.x;
    P.ws[1][r] = wsv.y;
    P.ws[2][r] = wsv.z;
    P.thr[r] = dist - t_clamp_min(kRelEps * dist, kEps);
    P.contrib[r] = L.emit * ev * dot(wsv, n) * -dot(wsv, L.n) * (inv_dist * inv_dist) / L.pdf /
                   static_cast<float>(A.s);
  }
  P.p_new[0][i] = v.p_new.x;
  P.p_new[1][i] = v.p_new.y;
  P.p_new[2][i] = v.p_new.z;
  P.wi[0][i] = v.wi.x;
  P.wi[1][i] = v.wi.y;
  P.wi[2][i] = v.wi.z;
  P.p_dl[0][i] = v.p_dl.x;
  P.p_dl[1][i] = v.p_dl.y;
  P.p_dl[2][i] = v.p_dl.z;
  P.fac[i] = v.fac;
  P.leaf_pre[i] = v.leaf_pre;
  P.env_c[i] = t_clamp(v.env_ind, 0.0f, kClampIndirect);
  P.w[i] = v.w;
  P.at_vertex[i] = v.at_vertex;
  P.rr_kill[i] = v.rr_kill;
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
  PreArgs P;
  if (!unpack_vtx(in, ip, fp, P.V)) return -1;
  for (int k = 0; k < 3; ++k) {
    P.p_new[k] = static_cast<float*>(out[k]);
    P.wi[k] = static_cast<float*>(out[3 + k]);
    P.p_dl[k] = static_cast<float*>(out[6 + k]);
    P.ws[k] = static_cast<float*>(out[9 + k]);
  }
  P.thr = static_cast<float*>(out[12]);
  P.contrib = static_cast<float*>(out[13]);
  P.fac = static_cast<float*>(out[14]);
  P.leaf_pre = static_cast<float*>(out[15]);
  P.env_c = static_cast<float*>(out[16]);
  P.w = static_cast<float*>(out[17]);
  P.at_vertex = static_cast<bool*>(out[18]);
  P.rr_kill = static_cast<bool*>(out[19]);
  if (P.V.b == 0) return 0;
  const int blocks = (P.V.b + kPreThreads - 1) / kPreThreads;
  shade_pre_kernel<<<blocks, kPreThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
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
