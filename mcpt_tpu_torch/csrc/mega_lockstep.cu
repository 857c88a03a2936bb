// Lockstep megakernel for Hopper (sm_90a).
//
// Replaces: mcpt_tpu/kernels/megakernel.py::_mega_kernel (K1b), launched there
// by `trace_mega_block(..., regen=False)` once per block of lanes, with the
// brute-force sweeps (`_intersect_tile`, `_occlude_shared_origin`) for scenes
// of at most 1024 triangles and the clustered walks (mcpt_tpu/kernels/
// cluster.py `cluster_query_chunk`, `cluster_occlude_fan`) above that. It
// takes no env map: the JAX kernel refuses one.
//
// Instances: mega_lockstep<S, BVH>, S = 4, -16 or -32 light samples as in
// megakernel.cu; BVH walks the threaded BVH instead of sweeping the tables.
//
// What it computes: one thread per lane (a (pixel, wavelength channel) pair;
// thread idx runs lane lane_offset + idx * lane_stride). The thread runs the
// lane's `spp` samples in order; per sample: the camera ray, then per depth
// the vertex (`shade_vertex`: the regen kernel's vertex block), the bounce and
// its nearest hit, and a record (l_dir, w) while the path goes on. A path
// ends at a camera miss, an emitter seen from the camera, a Russian-roulette
// kill, a bounce ray that misses or reaches an emitter, or at depth
// max_bounces - 1; its last record's value is then folded down through the
// earlier records in reverse, L = clamp15(l_dir) + clamp5(w·L) (Scene.cpp:
// 180-183), which rounds as the JAX kernel's reverse fold does (the regen
// kernel's forward min-affine fold is equal only in exact arithmetic). The
// random numbers are the JAX kernel's: keyed per sample, su = 0x9E3779B9·(s+1)
// + seed, camera draw c from murmur(su + 101 + c) on the pixel, vertex draw
// `use` from murmur(su + depth·0x85EBCA77) + use on the lane. Ray counts: 1
// camera ray per sample, S shadow rays per vertex, 1 bounce ray per RR
// survivor below depth max_bounces - 1 (the bounce at the last depth is
// traced only to tell whether the path ends there, as the JAX kernel does).
//
// What bounds it on this card: as the regen kernel, per-thread divergent
// loops and register pressure, plus the records: up to 2 x 32 floats a
// thread, indexed by depth, so they live in local memory (L1-cached). The
// design is the regen kernel's (tables in shared memory, S = 4 in
// registers); a lane whose path ends stops its depth loop at once, where the
// JAX kernel only skips depths at which a whole 1024-lane chunk is dead.

#include "mega_common.cuh"

namespace {

// The regen kernel keeps its copy of this vertex block inline: factored
// into these functions it took 3 more registers (118, not 115) in
// mega_regen<4, false, false>.

// One path vertex up to its direct light: the material's GGX microfacet
// sample and Fresnel split, the NEE light samples, Russian roulette and the
// reflect/refract branch, the shadow fan and the BSDF-weighted light sum
// (megakernel.py `_vertex_pre`, `_nee_shade`; Scene.cpp:28-36, 121-159).
struct Vertex {
  V3 p, n, wo, mfn;
  float ior, kr, off_scale, refl, l_dir;
  bool rr_kill, branch_reflect;
};

// `draw(use)` is the vertex's uniform at use-site `use` (1-4 the BSDF and
// roulette, 16 + 4·si + 0..3 light sample si): the two kernels key it apart.
template <int S, bool BVH, class Draw>
__device__ __forceinline__ Vertex shade_vertex(const Params& P, const Tables& T, const Hit& hit,
                                               V3 d, const Mat& m, int chan, float lam,
                                               float rr_rate, float total_area, int ns,
                                               Draw draw) {
  constexpr int NS = S > 0 ? S : -S;
  Vertex v;
  v.wo = neg(d);
  v.p = hit.p;
  v.n = hit.n;
  const V3 p = v.p, n = v.n;
  v.ior = m.ior_a + m.ior_b / (lam * lam);
  const float xi0 = draw(1u), xi1 = draw(2u);
  const float xi2 = draw(3u), xi3 = draw(4u);
  v.mfn = sample_mfn(m, n, xi0, xi1);
  v.kr = fresnel(m, v.ior, d, v.mfn);
  v.off_scale = fmaxf(kRelEps * fmaxf(fabsf(p.x), fmaxf(fabsf(p.y), fabsf(p.z))), kEps);
  const V3 p_dl = add(p, scale(n, v.off_scale));
  const bool inner = dot(v.wo, n) < 0.0f;
  v.refl = (P.textured && m.textured > 0.5f) ? chessboard(hit.uvx, hit.uvy) : m.refl;

  // NEE light samples (Scene.cpp:28-36, BVH.cpp:120-135)
  V3 ws[NS], ln[NS];
  float dist[NS], inv_dist[NS], emit_l[NS], mesh_area[NS];
#pragma unroll
  for (int si = 0; si < NS; ++si) {
    if (si >= ns) break;
    const uint32_t b4 = 16u + 4u * static_cast<uint32_t>(si);
    const float v0 = draw(b4), v1 = draw(b4 + 1);
    const float v2 = draw(b4 + 2), v3 = draw(b4 + 3);
    const float target = v0 * total_area;
    float mesh = 0.0f;
    for (int li = 0; li < T.n_lcum; ++li) {
      if (T.lcum[li] < target) mesh = mesh + 1.0f;
    }
    const float sv1 = sqrtf(v1);
    int pick = -1;
    for (int ei = 0; ei < T.n_emt; ++ei) {
      const float* em = T.emeta + ei * kEmeta;
      if (em[0] == mesh) {
        pick = ei;  // the last same-mesh row, unless one fires first
        if (sv1 < em[3]) break;
      }
    }
    float row[kEmt];
#pragma unroll
    for (int c = 0; c < kEmt; ++c) row[c] = pick >= 0 ? T.emt[pick * kEmt + c] : 0.0f;
    mesh_area[si] = 1.0f / fmaxf(row[15], 1e-30f);
    const float xs = sqrtf(v2), ys = v3;
    const float wx = xs * (1.0f - ys), wy = xs * ys;
    V3 lp = mk(row[0] + row[3] * wx + row[6] * wy, row[1] + row[4] * wx + row[7] * wy,
               row[2] + row[5] * wx + row[8] * wy);
    V3 lnrm = mk(row[9], row[10], row[11]);
    if (P.n_sph_emitters && row[16] > 0.5f) {
      // emissive sphere: uniform surface point c + r·dir
      const float ysp = 1.0f - 2.0f * v2;
      const float ssp = sqrtf(fmaxf(1.0f - ysp * ysp, 0.0f));
      const float php = kTwoPi * v3;
      const V3 dv = mk(ssp * cosf(php), ysp, ssp * sinf(php));
      lp = mk(row[0] + row[3] * dv.x, row[1] + row[3] * dv.y, row[2] + row[3] * dv.z);
      lnrm = dv;
    }
    ln[si] = lnrm;
    emit_l[si] = pick3(chan, row[12], row[13], row[14]);
    const V3 delta = sub(lp, p_dl);
    // sqrt-then-divide: dist feeds the fan's t < dist − ε bound
    dist[si] = sqrtf(fmaxf(dot(delta, delta), 1e-20f));
    inv_dist[si] = 1.0f / dist[si];
    ws[si] = scale(delta, inv_dist[si]);
  }

  // Russian roulette and the reflect/refract branch (Scene.cpp:121-159)
  v.rr_kill = xi2 >= rr_rate;
  v.branch_reflect = xi3 < v.kr;

  bool vis[NS];
#pragma unroll
  for (int si = 0; si < NS; ++si) vis[si] = true;
  if (P.enable_shadow && ns > 0) {
    if constexpr (BVH) {
      occlude_fan_bvh<NS>(T, p_dl, ws, dist, ns, vis);
    } else {
      occlude_fan<NS>(T, p_dl, ws, dist, ns, vis);
    }
  }

  float l_dir = 0.0f;
#pragma unroll
  for (int si = 0; si < NS; ++si) {
    if (si >= ns) break;
    if (!vis[si]) continue;
    const float ev = eval_bsdf(m, v.ior, v.refl, ws[si], v.wo, n, !inner);
    const float contrib = emit_l[si] * ev * dot(ws[si], n) * -dot(ws[si], ln[si]) *
                          (inv_dist[si] * inv_dist[si]) * mesh_area[si] * P.inv_n_dir;
    l_dir = l_dir + contrib;
  }
  v.l_dir = (inner ? 1.0f - v.kr : v.kr) * l_dir;
  return v;
}

// A vertex's bounce: the direction wi, the offset origin p_new, the BSDF
// value ev along wi and the path weight w (megakernel.py `_vertex_pre`).
__device__ __forceinline__ void bounce(const Vertex& v, const Mat& m, V3 d, float inv_rr, V3& wi,
                                       V3& p_new, float& ev, float& w) {
  const float sign_reflect = dot(v.wo, v.mfn) < 0.0f ? -1.0f : 1.0f;
  const float sgn = v.branch_reflect ? sign_reflect : -sign_reflect;
  wi = v.branch_reflect ? reflect(v.wo, v.mfn) : refract(v.ior, d, v.mfn);
  p_new = add(v.p, scale(v.n, v.off_scale * sgn));
  ev = eval_bsdf(m, v.ior, v.refl, wi, v.wo, v.n, v.branch_reflect);
  const float pv = pdf(m, v.ior, wi, v.wo, v.n, v.branch_reflect);
  if (m.dirac > 0.5f) {
    w = ev * inv_rr;
  } else {
    w = fabsf(pv) > 1e-10f ? ev * fabsf(dot(v.wo, v.n)) / pv * inv_rr : 0.0f;
  }
}

template <int S, bool BVH>
__global__ void __launch_bounds__(kThreads) mega_lockstep(Params P) {
  extern __shared__ float smem[];
  const Tables T = stage_tables<BVH>(P, smem);

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P.n_lanes) return;
  const int lane = P.lane_offset + idx * P.lane_stride;
  const int pix_i = lane / 3;
  const int chan = lane - pix_i * 3;
  const uint32_t pix = static_cast<uint32_t>(pix_i);
  const float fi = static_cast<float>(pix_i % P.width);
  const float fj = static_cast<float>(pix_i / P.width);
  const float lam = pick3(chan, 0.7f, 0.5461f, 0.4358f);
  const float bg_l = pick3(chan, T.par[0], T.par[1], T.par[2]);
  const float rr_rate = T.par[3], inv_rr = T.par[4], total_area = T.par[5];
  const int ns = S > 0 ? S : P.n_dir;
  const uint32_t pix_mix = pix * 0x9E3779B1u;
  const uint32_t lane_mix = static_cast<uint32_t>(lane) * 0x9E3779B1u;
  const int last = P.max_bounces - 1;

  float rec_l[kMaxDepth], rec_w[kMaxDepth];  // the records below the last one
  float rad = 0.0f;
  uint32_t rays = 0;
  for (int s = 0; s < P.spp; ++s) {
    const uint32_t su =
        0x9E3779B9u * (static_cast<uint32_t>(s) + 1u) + static_cast<uint32_t>(P.seed);
    rays += 1;  // the camera ray
    V3 o, d;
    cam_ray_with(
        P, fi, fj, [&](uint32_t c) { return unit(murmur(pix_mix + murmur(su + 101u + c))); }, o,
        d);
    Hit hit = trace<BVH>(T, o, d, P.textured);
    float acc;  // the value of the path's last record
    int depth = 0;
    for (;; ++depth) {
      // a path reaches depth > 0 only through a hit that is no emitter
      if (!hit.happened) {  // camera miss: the background, unclamped
        acc = bg_l;
        break;
      }
      const Mat m = gather_mat(T, hit.mat, chan);
      if (hit.emissive) {  // the eye sees an emitter directly
        acc = clampf(m.emit * fabsf(dot(neg(d), hit.n)), 0.0f, 1.0f);
        break;
      }
      const uint32_t du = murmur(su + static_cast<uint32_t>(depth) * 0x85EBCA77u);
      const Vertex v =
          shade_vertex<S, BVH>(P, T, hit, d, m, chan, lam, rr_rate, total_area, ns,
                               [&](uint32_t use) { return unit(murmur(lane_mix + du + use)); });
      rays += static_cast<uint32_t>(ns);
      if (v.rr_kill) {  // the raw l_dir
        acc = v.l_dir;
        break;
      }
      V3 wi, p_new;
      float ev, w;
      bounce(v, m, d, inv_rr, wi, p_new, ev, w);
      if (depth < last) rays += 1;  // the bounce ray
      hit = trace<BVH>(T, p_new, wi, P.textured);
      if (!hit.happened || hit.emissive) {  // terminal with the env rule's value
        acc = clampf(v.l_dir, 0.0f, kClampDirect) + clampf(bg_l * ev * inv_rr, 0.0f, kClampIndirect);
        break;
      }
      if (depth == last) {  // a record that goes on, folded onto L = 0
        acc = clampf(v.l_dir, 0.0f, kClampDirect) + clampf(w * 0.0f, 0.0f, kClampIndirect);
        break;
      }
      rec_l[depth] = v.l_dir;
      rec_w[depth] = w;
      d = wi;
    }
    // the reverse clamp fold (Scene.cpp:180-183 nesting)
    for (int k = depth - 1; k >= 0; --k) {
      acc = clampf(rec_l[k], 0.0f, kClampDirect) + clampf(rec_w[k] * acc, 0.0f, kClampIndirect);
    }
    rad = rad + acc;
  }
  P.out_rad[idx] = rad / static_cast<float>(P.spp);
  P.out_rays[idx] = static_cast<float>(rays);
}

template <int S>
cudaError_t dispatch(const Params& P, cudaStream_t stream, int* launched) {
  launched[0] = S;
  launched[1] = P.use_bvh != 0;
  return P.use_bvh ? launch_lanes(mega_lockstep<S, true>, P, stream)
                   : launch_lanes(mega_lockstep<S, false>, P, stream);
}

}  // namespace

// C interface (loaded with ctypes by kernels/megakernel.py): the arguments of
// mcpt_mega_trace in megakernel.cu, with use_env = 0 (an env map is refused).
//   launched: 2 ints out: the instance's S and BVH (set when it launches)
// Returns the cudaError_t of the launch (0 on success). Launches on `stream`
// and does not synchronize.
extern "C" int mcpt_mega_lockstep(const void* const* tables, const int* rows, const float* fpar,
                                  const int* ipar, void* out_rad, void* out_rays, void* stream,
                                  int* launched) {
  const Params P = unpack_params(tables, rows, fpar, ipar, out_rad, out_rays);
  if (P.n_lanes <= 0) return 0;
  if (!params_ok(P) || P.use_env) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = P.n_dir == 4    ? dispatch<4>(P, s, launched)
                  : P.n_dir <= 16 ? dispatch<-16>(P, s, launched)
                                  : dispatch<-32>(P, s, launched);
  return static_cast<int>(e);
}
