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
// megakernel.cu (the generic ones take any count, -S at a time); BVH walks
// the BVH's child-pair rows (mega_common.cuh) instead of sweeping the tables.
//
// What it computes: one thread per lane (a (pixel, wavelength channel) pair;
// thread idx runs lane lane_offset + idx * lane_stride). The thread runs the
// lane's `spp` samples in order, one path vertex per iteration of one loop:
// the nearest hit of the current ray (camera or bounce), then the vertex
// (`shade_vertex`: the regen kernel's vertex block), the bounce, and a record
// (l_dir, w) while the path goes on. A path ends at a camera miss, an emitter
// seen from the camera, a Russian-roulette kill, a bounce ray that misses or
// reaches an emitter, or after the bounce of depth max_bounces - 1; its last
// record's value is then folded down through the
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
// What bounds it on this card: as the regen kernel, the instruction slots
// lost to divergence and register pressure, plus the records: up to 2 x 32
// floats a thread, indexed by depth, so they live in local memory
// (L1-cached). The design is the regen kernel's: one flat loop over path
// vertices with one `trace` call for camera and bounce rays, so that a warp
// no longer waits at each sample for its longest path (the JAX kernel runs a
// 1024-lane chunk for as many depths as its longest path); tables in shared
// memory with 16-byte rows, S = 4 in registers, 4 resident blocks of 128
// per SM (127 registers, the records' 288 bytes of stack, no spills).

#include "mega_common.cuh"

namespace {

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
template <int S, bool BVH, bool DEEP, class Draw>
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

  // NEE (Scene.cpp:28-36, BVH.cpp:120-135): the light samples NS at a time in
  // sample order; per group its draws, its shadow fan, and each visible
  // sample's BSDF-weighted term added to l_dir in order
  float l_dir = 0.0f;
  for (int g0 = 0; g0 < ns; g0 += NS) {
    const int gn = min(NS, ns - g0);
    V3 ws[NS], ln[NS];
    float dist[NS], inv_dist[NS], emit_l[NS], mesh_area[NS];
#pragma unroll
    for (int si = 0; si < NS; ++si) {
      if (si >= gn) break;
      const uint32_t b4 = 16u + 4u * static_cast<uint32_t>(g0 + si);
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

    bool vis[NS];
#pragma unroll
    for (int si = 0; si < NS; ++si) vis[si] = true;
    if (P.enable_shadow) fan_any<NS, BVH, DEEP>(P, T, p_dl, ws, dist, gn, vis);

#pragma unroll
    for (int si = 0; si < NS; ++si) {
      if (si >= gn) break;
      if (!vis[si]) continue;
      const float ev = eval_bsdf(m, v.ior, v.refl, ws[si], v.wo, n, !inner);
      const float contrib = emit_l[si] * ev * dot(ws[si], n) * -dot(ws[si], ln[si]) *
                            (inv_dist[si] * inv_dist[si]) * mesh_area[si] * P.inv_n_dir;
      l_dir = l_dir + contrib;
    }
  }
  v.l_dir = (inner ? 1.0f - v.kr : v.kr) * l_dir;

  // Russian roulette and the reflect/refract branch (Scene.cpp:121-159)
  v.rr_kill = xi2 >= rr_rate;
  v.branch_reflect = xi3 < v.kr;
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

// One thread's lanes: the kernel's body (mega_lockstep below gives it its
// launch bounds).
template <int S, bool BVH, bool DEEP = false>
__device__ __forceinline__ void lockstep_lanes(const Params& P) {
  extern __shared__ __align__(16) float smem[];
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

  // the records (l_dir, w) of the path's vertices 0..depth - 1
  float rec_l[kMaxDepth], rec_w[kMaxDepth];
  float rad = 0.0f;
  uint32_t rays = 0;
  // The lane's path state: sample s, the depth of the vertex that the ray
  // (o, d) looks for, and ev, the BSDF value along it when it is a bounce
  // ray. One iteration is one path vertex.
  int s = -1, depth = 0;
  bool ended = true;  // the last path ended: start sample s + 1
  V3 o, d;
  float ev = 0.0f;
  // sample s's key
  auto sample_key = [&](int sample) {
    return 0x9E3779B9u * (static_cast<uint32_t>(sample) + 1u) + static_cast<uint32_t>(P.seed);
  };
  for (;;) {
    if (ended) {
      if (++s == P.spp) break;
      const uint32_t su = sample_key(s);
      rays += 1;  // the camera ray
      cam_ray_with(
          P, fi, fj, [&](uint32_t c) { return unit(murmur(pix_mix + murmur(su + 101u + c))); },
          o, d);
      depth = 0;
    }
    // the one nearest-hit query, for camera and bounce rays alike
    const Hit hit = trace_any<BVH, DEEP>(P, T, o, d);
    ended = true;
    float acc;  // the value of the path's last record ...
    int below;  // ... and how many records fold onto it
    if (depth > 0 && (!hit.happened || hit.emissive)) {
      // vertex depth - 1's bounce ray missed or reached an emitter: its
      // record ends the path with the env rule's value
      acc = clampf(rec_l[depth - 1], 0.0f, kClampDirect) +
            clampf(bg_l * ev * inv_rr, 0.0f, kClampIndirect);
      below = depth - 1;
    } else if (depth > last) {
      // vertex `last` went on: its record folds onto L = 0
      acc = clampf(rec_l[last], 0.0f, kClampDirect) +
            clampf(rec_w[last] * 0.0f, 0.0f, kClampIndirect);
      below = last;
    } else if (!hit.happened) {  // camera miss: the background, unclamped
      acc = bg_l;
      below = 0;
    } else {
      const Mat m = gather_mat(T, hit.mat, chan);
      if (hit.emissive) {  // the eye sees an emitter directly
        acc = clampf(m.emit * fabsf(dot(neg(d), hit.n)), 0.0f, 1.0f);
        below = 0;
      } else {
        const uint32_t du = murmur(sample_key(s) + static_cast<uint32_t>(depth) * 0x85EBCA77u);
        const Vertex v =
            shade_vertex<S, BVH, DEEP>(P, T, hit, d, m, chan, lam, rr_rate, total_area, ns,
                                 [&](uint32_t use) { return unit(murmur(lane_mix + du + use)); });
        rays += static_cast<uint32_t>(ns);
        if (v.rr_kill) {  // the raw l_dir
          acc = v.l_dir;
          below = depth;
        } else {
          V3 wi, p_new;
          float w;
          bounce(v, m, d, inv_rr, wi, p_new, ev, w);
          // the bounce at the last depth is traced only to tell whether the
          // path ends with the env rule's value
          if (depth < last) rays += 1;  // the bounce ray
          rec_l[depth] = v.l_dir;
          rec_w[depth] = w;
          o = p_new;
          d = wi;
          ++depth;
          ended = false;
        }
      }
    }
    if (ended) {
      // the reverse clamp fold (Scene.cpp:180-183 nesting)
      for (int k = below - 1; k >= 0; --k) {
        acc = clampf(rec_l[k], 0.0f, kClampDirect) +
              clampf(rec_w[k] * acc, 0.0f, kClampIndirect);
      }
      rad = rad + acc;
    }
  }
  P.out_rad[idx] = rad / static_cast<float>(P.spp);
  P.out_rays[idx] = static_cast<float>(rays);
}

// The kernel: capped at kCapBlocks resident blocks per SM where kCapped
// (mega_common.cuh), else at what its registers allow.
template <int S, bool BVH, std::enable_if_t<!kCapped<S, BVH>, int> = 0>
__global__ void __launch_bounds__(kThreads) mega_lockstep(Params P) {
  lockstep_lanes<S, BVH>(P);
}
template <int S, bool BVH, std::enable_if_t<kCapped<S, BVH>, int> = 0>
__global__ void __launch_bounds__(kThreads, kCapBlocks) mega_lockstep(Params P) {
  lockstep_lanes<S, BVH>(P);
}
// The BVH instances for a tree of more than kStack levels (mega_common.cuh
// DeepStack), the S = 4 ones capped at kDeepCapBlocks.
template <int S, std::enable_if_t<S != 4, int> = 0>
__global__ void __launch_bounds__(kThreads) mega_lockstep_deep(Params P) {
  lockstep_lanes<S, true, true>(P);
}
template <int S, std::enable_if_t<S == 4, int> = 0>
__global__ void __launch_bounds__(kThreads, kDeepCapBlocks) mega_lockstep_deep(Params P) {
  lockstep_lanes<S, true, true>(P);
}

// The instance that P takes: S = 4, -16 or -32 by its light-sample count,
// BVH by its flag, a deep one for a tree of more than kStack levels;
// launched[0..2] get its S, BVH and whether it is deep.
Kernel pick_instance(const Params& P, int* launched) {
  const Kernel table[3][2] = {{mega_lockstep<4, false>, mega_lockstep<4, true>},
                              {mega_lockstep<-16, false>, mega_lockstep<-16, true>},
                              {mega_lockstep<-32, false>, mega_lockstep<-32, true>}};
  const Kernel deep_table[3] = {mega_lockstep_deep<4>, mega_lockstep_deep<-16>,
                                mega_lockstep_deep<-32>};
  const int k = s_index(P.n_dir);
  launched[0] = kS[k];
  launched[1] = P.use_bvh != 0;
  launched[2] = deep(P);
  return deep(P) ? deep_table[k] : table[k][P.use_bvh ? 1 : 0];
}

}  // namespace

// C interface (loaded with ctypes by kernels/megakernel.py): the arguments of
// mcpt_mega_trace in megakernel.cu, with use_env = 0 (an env map is refused).
//   launched: 3 ints out: the instance's S, BVH and whether it is deep (set
//           when it launches)
// Returns the cudaError_t of the launch (0 on success). Launches on `stream`
// and does not synchronize.
extern "C" int mcpt_mega_lockstep(const void* const* tables, const int* rows, const float* fpar,
                                  const int* ipar, void* out_rad, void* out_rays, void* stream,
                                  int* launched) {
  const Params P = unpack_params(tables, rows, fpar, ipar, out_rad, out_rays);
  if (P.n_lanes <= 0) return 0;
  if (!params_ok(P) || !stack_ok(P) || P.use_env) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      launch_lanes(pick_instance(P, launched), P, static_cast<cudaStream_t>(stream)));
}

// The instance mcpt_mega_lockstep would launch with these arguments, and
// what the card makes of it (see mcpt_mega_trace_info in megakernel.cu).
extern "C" int mcpt_mega_lockstep_info(const void* const* tables, const int* rows,
                                       const float* fpar, const int* ipar, int* launched,
                                       int* info) {
  const Params P = unpack_params(tables, rows, fpar, ipar, nullptr, nullptr);
  if (!params_ok(P) || P.use_env) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kernel_info(pick_instance(P, launched), P, info));
}
