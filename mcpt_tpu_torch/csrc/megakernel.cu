// Path-regeneration megakernel for Hopper (sm_90a).
//
// Replaces: mcpt_tpu/kernels/megakernel.py::_mega_kernel_regen (the merged
// `_fan_and_nearest` sweep, `_intersect_tile`, `_occlude_shared_origin`,
// `_vertex_pre`, `_nee_shade`), launched there by `trace_mega_block` once per
// block of up to 2^20 lanes; with its env tier (`_env_mip_lookup` plus the
// deferred XLA pass `_primary_env_mean`) and, for scenes over 1024
// triangles, its clustered walks (mcpt_tpu/kernels/cluster.py
// `cluster_fan_and_near`, `cluster_query_chunk`, `cluster_occlude_fan`).
//
// Instances: mega_regen<S, ENV, BVH>. S = 4 is the common light-sample count
// (its fan arrays stay in registers); S = -16 and S = -32 are generic, for
// any count, which they take -S samples at a time in sample order (the
// smaller group keeps the per-sample arrays of the usual counts from
// spilling; 32 is conf.json's count in fixed mode). ENV looks the
// env map up per lane, at full resolution with bilinear filtering, on a
// camera miss and for a surviving bounce's pending env-terminal (the TPU
// kernel's 16x32 nearest-texel mip and deferred primary pass were TPU
// workarounds: it has no per-lane gather). BVH walks a BVH of child-pair rows
// from global memory (mega_common.cuh): near-first with a per-thread stack
// for the next ray's nearest hit, and one walk for a vertex's four shadow
// rays (the generic instances: one a ray); the brute-force sweeps over
// shared-memory tables serve scenes of at most 1024 triangles.
//
// What it computes: one thread per lane (a (pixel, wavelength channel) pair;
// thread idx runs lane lane_offset + idx * lane_stride).
// The thread runs its lane's `spp` samples in order, one path vertex per
// iteration of one loop: the nearest hit over the triangle table and the
// spheres (strict `<` in table order) of the current ray, camera or bounce;
// then either a terminal rule, or the GGX microfacet sample and Fresnel
// split, the S-ray NEE shadow fan over the occluder table, Russian roulette
// and the bounce, with the forward min-affine fold of the firefly clamps.
// It writes the same two planes as the TPU kernel: mean radiance rad/spp and
// the ray count. The random numbers are the TPU kernel's
// murmur3 counter hash on the same keys, so the draws match bit for bit.
// The arithmetic is float32 in the JAX expression order: build with
// -fmad=false and without fast math, so every product and sum is rounded
// where the reference rounds it. No double appears here: constants folded
// in double by the host (camera scales, 1/S) arrive as float parameters.
//
// What bounds it on this card: not bytes (the tables are a few KB, the output
// 8 bytes per lane) but instruction slots lost to divergence, and register
// pressure from the per-vertex state (material, four light samples, fold
// prefix). Path lengths differ from lane to lane (roulette, misses,
// emitters), and a warp runs a loop for as long as its longest lane: with
// the depth loop nested in the sample loop, every warp waited at every
// sample for its longest path (at rr 0.7 and 8 bounces about 40% of
// lane-vertex slots did work). The design is the TPU kernel's path
// regeneration carried to SIMT: one flat loop per lane whose iteration is
// one path vertex. A lane whose path ends folds it into its sum and builds
// its next sample's camera ray where the bounce ray would go, and one
// `trace` call serves camera and bounce rays alike, so a warp's lanes stay
// busy until their budgets run out; only that tail idles (a lane whose
// samples are spent waits for its warp). What remains: divergence inside an
// iteration (terminal rules against shading, the BSDF's material branches,
// camera rays built by some lanes only), and 4 resident blocks of 128 per SM
// (123 registers, no spills). Tables are staged once per block into shared
// memory, where a warp's threads read the same address (a broadcast);
// triangle rows land 28 floats apart (kTriSmem) so that a Woop test reads
// its 13 floats as four float4 loads (row_head, mega_common.cuh), as does
// the shadow fan from the 16-float occluder rows. The common S = 4 light-sample count is
// a template instance so the fan's per-sample arrays stay in registers; the
// shadow fan and the light pick stop early once their answer is fixed.
// __launch_bounds__ caps of 5 or 6 blocks per SM (96 or 80 registers) and
// 256-thread blocks were timed against this and not kept for the
// brute-force instances (PERF.md): the caps spill. The BVH instances read
// child-pair node rows, leaf triangle rows and the env map from global
// memory through L1/L2 (a 38k-triangle scene's tables are ~5 MB, a 1024x512
// env map 6.3 MB: both stay in the 50 MB L2), and wait on those loads; their
// S = 4 instances run capped at 6 blocks per SM, whose extra warps hide
// more of the wait than the spills cost (mega_common.cuh kCapBlocks).

#include "mega_common.cuh"

namespace {

// The regen kernel's keys (megakernel.py:2027-2034, 2217-2225): camera draws
// per (pixel, sample), path draws per (lane, sample, depth, use-site).
__device__ __forceinline__ void cam_ray(const Params& P, uint32_t pix, float fi, float fj,
                                        uint32_t s, V3& o, V3& d) {
  const uint32_t base = pix * 0x9E3779B1u + s * 0x0ED5AD4Du +
                        static_cast<uint32_t>(P.seed) * 0x01000193u;
  cam_ray_with(P, fi, fj, [&](uint32_t c) { return unit(murmur(base + 0x51ED2701u + c)); }, o,
               d);
}

__device__ __forceinline__ float path_draw(uint32_t base, uint32_t use) {
  return unit(murmur(base + use * 0x632BE59Bu));
}

// One thread's lanes: the kernel's body (mega_regen below gives it its
// launch bounds).
template <int S, bool ENV, bool BVH, bool DEEP = false>
__device__ __forceinline__ void regen_lanes(const Params& P) {
  constexpr int NS = S > 0 ? S : -S;
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
  const uint32_t lane_key = static_cast<uint32_t>(lane) * 0x9E3779B1u +
                            static_cast<uint32_t>(P.seed) * 0x01000193u;

  float rad = 0.0f;
  uint32_t rays = 0;
  // The lane's path state: sample s, the depth of the vertex that the ray
  // (o, d) looks for, and the min-affine prefix of the nested clamp fold
  // over the vertices before it (identity map first) with the pending
  // env-terminal value. One iteration is one path vertex.
  int s = -1, depth = 0;
  bool ended = true;  // the last path ended: start sample s + 1
  V3 o, d;
  float f_c = kFoldBig, f_b = 0.0f, f_w = 1.0f, pend = 0.0f;
  for (;;) {
    if (ended) {
      if (++s == P.spp) break;
      rays += 1;  // the camera ray
      cam_ray(P, pix, fi, fj, static_cast<uint32_t>(s), o, d);
      depth = 0;
      f_c = kFoldBig;
      f_b = 0.0f;
      f_w = 1.0f;
      pend = 0.0f;
    }
    // the one nearest-hit query, for camera and bounce rays alike
    const Hit hit = trace_any<BVH, DEEP>(P, T, o, d);
    ended = true;
    if (depth > 0 && (!hit.happened || hit.emissive)) {
      // the bounce ray missed or reached an emitter: env-rule terminal
      rad = rad + pend;
      continue;
    }
    if (!hit.happened) {  // camera miss: env or background, unclamped
      rad = rad + (ENV ? env_lookup(T, d, chan) : bg_l);
      continue;
    }
    const V3 wo = neg(d);
    const Mat m = gather_mat(T, hit.mat, chan);
    if (hit.emissive) {  // the eye sees an emitter directly
      rad = rad + clampf(m.emit * fabsf(dot(wo, hit.n)), 0.0f, 1.0f);
      continue;
    }
    const V3 p = hit.p, n = hit.n;
    const uint32_t key = lane_key + static_cast<uint32_t>(s) * 0x0ED5AD4Du +
                         static_cast<uint32_t>(depth) * 0x9E3779B9u;
    const float ior = m.ior_a + m.ior_b / (lam * lam);
    const float xi0 = path_draw(key, 1), xi1 = path_draw(key, 2);
    const float xi2 = path_draw(key, 3), xi3 = path_draw(key, 4);
    const V3 mfn = sample_mfn(m, n, xi0, xi1);
    const float kr = fresnel(m, ior, d, mfn);
    const float off_scale =
        fmaxf(kRelEps * fmaxf(fabsf(p.x), fmaxf(fabsf(p.y), fabsf(p.z))), kEps);
    const V3 p_dl = add(p, scale(n, off_scale));
    const bool inner = dot(wo, n) < 0.0f;
    const float refl =
        (P.textured && m.textured > 0.5f) ? chessboard(hit.uvx, hit.uvy) : m.refl;

    // NEE (Scene.cpp:28-36, BVH.cpp:120-135): the light samples NS at a time
    // in sample order; per group its draws, its shadow fan, and each visible
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
        const float v0 = path_draw(key, b4), v1 = path_draw(key, b4 + 1);
        const float v2 = path_draw(key, b4 + 2), v3 = path_draw(key, b4 + 3);
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
        const float ev = eval_bsdf(m, ior, refl, ws[si], wo, n, !inner);
        const float contrib = emit_l[si] * ev * dot(ws[si], n) * -dot(ws[si], ln[si]) *
                              (inv_dist[si] * inv_dist[si]) * mesh_area[si] * P.inv_n_dir;
        l_dir = l_dir + contrib;
      }
    }
    l_dir = (inner ? 1.0f - kr : kr) * l_dir;

    // Russian roulette and the reflect/refract branch (Scene.cpp:121-159)
    const bool rr_kill = xi2 >= rr_rate;
    const bool branch_reflect = xi3 < kr;
    const float sign_reflect = dot(wo, mfn) < 0.0f ? -1.0f : 1.0f;
    const float sgn = branch_reflect ? sign_reflect : -sign_reflect;
    const bool capped = !rr_kill && depth == P.max_bounces - 1;
    const bool survive = !rr_kill && !capped;
    rays += static_cast<uint32_t>(ns);

    if (!survive) {
      // RR kill: the raw l_dir; bounce cap: clamp15(l_dir); depth-0
      // terminals bypass the fold map
      const float leaf = capped ? clampf(l_dir, 0.0f, kClampDirect) : l_dir;
      rad = rad + (depth == 0 ? leaf : fminf(f_c, f_b + f_w * fmaxf(leaf, 0.0f)));
      continue;
    }

    // survivor: bounce direction and weight, pending env-terminal value,
    // and this vertex's map composed into the prefix
    const V3 wi = branch_reflect ? reflect(wo, mfn) : refract(ior, d, mfn);
    const V3 p_new = add(p, scale(n, off_scale * sgn));
    const float ev = eval_bsdf(m, ior, refl, wi, wo, n, branch_reflect);
    const float pv = pdf(m, ior, wi, wo, n, branch_reflect);
    float w;
    if (m.dirac > 0.5f) {
      w = ev * inv_rr;
    } else {
      w = fabsf(pv) > 1e-10f ? ev * fabsf(dot(wo, n)) / pv * inv_rr : 0.0f;
    }
    // the pending env-terminal: env radiance along wi, fetched here only
    const float env_wi = ENV ? env_lookup(T, wi, chan) : bg_l;
    const float env_ind = env_wi * ev * inv_rr;
    const float a_t = clampf(l_dir, 0.0f, kClampDirect);
    const float new_pend = a_t + clampf(env_ind, 0.0f, kClampIndirect);
    pend = depth == 0 ? new_pend : fminf(f_c, f_b + f_w * new_pend);
    const float c_c = fminf(f_c, f_b + f_w * (a_t + kClampIndirect));
    const float c_b = f_b + f_w * a_t;
    const float c_w = fminf(f_w * w, kFoldWCap);
    f_c = c_c;
    f_b = c_b;
    f_w = c_w;
    rays += 1;  // the bounce ray
    o = p_new;
    d = wi;
    ++depth;
    ended = false;
  }
  P.out_rad[idx] = rad / static_cast<float>(P.spp);
  P.out_rays[idx] = static_cast<float>(rays);
}

// The kernel: capped at kCapBlocks resident blocks per SM where kCapped
// (mega_common.cuh), else at what its registers allow.
template <int S, bool ENV, bool BVH, std::enable_if_t<!kCapped<S, BVH>, int> = 0>
__global__ void __launch_bounds__(kThreads) mega_regen(Params P) {
  regen_lanes<S, ENV, BVH>(P);
}
template <int S, bool ENV, bool BVH, std::enable_if_t<kCapped<S, BVH>, int> = 0>
__global__ void __launch_bounds__(kThreads, kCapBlocks) mega_regen(Params P) {
  regen_lanes<S, ENV, BVH>(P);
}
// The BVH instances for a tree of more than kStack levels (mega_common.cuh
// DeepStack), the S = 4 ones capped at kDeepCapBlocks.
template <int S, bool ENV, std::enable_if_t<S != 4, int> = 0>
__global__ void __launch_bounds__(kThreads) mega_regen_deep(Params P) {
  regen_lanes<S, ENV, true, true>(P);
}
template <int S, bool ENV, std::enable_if_t<S == 4, int> = 0>
__global__ void __launch_bounds__(kThreads, kDeepCapBlocks) mega_regen_deep(Params P) {
  regen_lanes<S, ENV, true, true>(P);
}

// The instance that P takes: S = 4, -16 or -32 by its light-sample count,
// ENV and BVH by its flags, a deep one for a tree of more than kStack levels;
// launched[0..3] get its S, ENV, BVH and whether it is deep.
Kernel pick_instance(const Params& P, int* launched) {
  const Kernel table[3][4] = {
      {mega_regen<4, false, false>, mega_regen<4, false, true>, mega_regen<4, true, false>,
       mega_regen<4, true, true>},
      {mega_regen<-16, false, false>, mega_regen<-16, false, true>,
       mega_regen<-16, true, false>, mega_regen<-16, true, true>},
      {mega_regen<-32, false, false>, mega_regen<-32, false, true>,
       mega_regen<-32, true, false>, mega_regen<-32, true, true>}};
  const Kernel deep_table[3][2] = {{mega_regen_deep<4, false>, mega_regen_deep<4, true>},
                                   {mega_regen_deep<-16, false>, mega_regen_deep<-16, true>},
                                   {mega_regen_deep<-32, false>, mega_regen_deep<-32, true>}};
  const int k = s_index(P.n_dir);
  launched[0] = kS[k];
  launched[1] = P.use_env != 0;
  launched[2] = P.use_bvh != 0;
  launched[3] = deep(P);
  if (deep(P)) return deep_table[k][P.use_env ? 1 : 0];
  return table[k][(P.use_env ? 2 : 0) + (P.use_bvh ? 1 : 0)];
}

}  // namespace

// C interface (loaded with ctypes by kernels/megakernel.py).
//   tables: 12 device pointers (tri, occ, sph, mat, emt, emeta, lcum, par
//           float32 tables; env float32 (env_h, env_w, 3); bvh float32
//           (rows, 16); leaf_tri float32 (L, 28); kernels/tables.py layouts;
//           the deep instances' walk stacks, int32 3 x bvh_depth x n_lanes,
//           or null below kStack levels)
//   rows:   6 ints (tri, occ, sph, mat, emt, lcum)
//   fpar:   17 floats: xscale, yscale, om[9], pos[3], focal, aperture, 1/S
//   ipar:   18 ints: seed, lane_offset, n_lanes, spp, width, height,
//           max_bounces, n_dir, enable_shadow, textured, n_sph_emitters,
//           use_dof, env_h, env_w, use_env, use_bvh, lane_stride, bvh_depth
//   launched: 4 ints out: the instance's S, ENV, BVH and whether it is deep
//           (set when it launches)
// Thread idx runs lane lane_offset + idx * lane_stride. Returns the
// cudaError_t of the launch (0 on success). Launches on `stream` and does not
// synchronize.
extern "C" int mcpt_mega_trace(const void* const* tables, const int* rows, const float* fpar,
                               const int* ipar, void* out_rad, void* out_rays, void* stream,
                               int* launched) {
  const Params P = unpack_params(tables, rows, fpar, ipar, out_rad, out_rays);
  if (P.n_lanes <= 0) return 0;
  if (!params_ok(P) || !stack_ok(P)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_lanes(pick_instance(P, launched), P, static_cast<cudaStream_t>(stream)));
}

// The instance mcpt_mega_trace would launch with these arguments (the same
// first four; launched as there), and what the card makes of it, into
// info[0..4] (mega_common.cuh kernel_info): resident blocks per SM,
// threads a block, registers, local bytes and shared-memory bytes. Launches
// nothing.
extern "C" int mcpt_mega_trace_info(const void* const* tables, const int* rows,
                                    const float* fpar, const int* ipar, int* launched,
                                    int* info) {
  const Params P = unpack_params(tables, rows, fpar, ipar, nullptr, nullptr);
  if (!params_ok(P)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kernel_info(pick_instance(P, launched), P, info));
}
