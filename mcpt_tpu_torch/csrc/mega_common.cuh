// Device code shared by the two megakernels of this directory: the
// path-regeneration kernel (megakernel.cu, `mega_regen`) and the lockstep
// kernel (mega_lockstep.cu, `mega_lockstep`).
//
// The float32 arithmetic follows mcpt_tpu/kernels/megakernel.py expression by
// expression (build with -fmad=false and without fast math): vector math,
// the murmur3 counter hash, the camera (each kernel passes its own draws),
// the brute-force sweeps over shared memory, the BVH walks, the env lookup,
// the materials and the BSDF, the staging of the tables into shared memory,
// and the host side of the C entries. Everything sits in an anonymous
// namespace: each source gets its own copy.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-4f;
constexpr float kOneMinusEps = 0.9999f;
constexpr float kRelEps = 4e-6f;
constexpr float kTMax = 3e37f;
constexpr float kClampDirect = 15.0f;
constexpr float kClampIndirect = 5.0f;
constexpr float kFoldBig = 1e30f;
constexpr float kFoldWCap = 1e30f;
constexpr float kTwoPi = 6.2831855f;  // float32(2π), folded like the host
constexpr float kPi = 3.1415927f;
// light samples a vertex: the generic instances take them NS at a time, and
// their draws' use-site keys 16 + 4·si + 0..3 stay below 2^31
constexpr int kMaxDir = 1 << 28;
constexpr int kMaxDepth = 32;  // max_bounces limit (megakernel_ref.MAX_BOUNCES_LIMIT)
// entries of a BVH walk's per-thread stack (constants.py BVH_STACK): a walk
// pushes at most one entry per tree level; a tree of more levels takes the
// deep instances, whose walks keep their stack in device memory (DeepStack)
constexpr int kStack = 32;

constexpr int kThreads = 128;
// The S = 4 BVH instances run capped at kCapBlocks resident blocks of
// kThreads per SM (__launch_bounds__(kThreads, kCapBlocks): 80 registers and
// a few hundred bytes of spills): their walks wait on L1 and L2, and the
// extra warps hide it (-9% on the --conf launch, PERF.md). The other
// instances are uncapped (the cap spills their shading and slows them).
constexpr int kCapBlocks = 6;
template <int S, bool BVH>
constexpr bool kCapped = BVH && S == 4;
// The deep S = 4 instances run capped at kDeepCapBlocks (128 registers,
// 4-16 bytes spilled): uncapped they took 145-148 registers and 3 blocks a
// SM, and ran 8% slower on a 64-level tree whose stack holds one entry and
// 5-6% on one whose stack reaches 63. The generic deep instances, at
// 247-255 registers, are not capped. K3's two-tier stack (deep_stack.cuh)
// was tried here under the same cap and was slower (PERF.md).
constexpr int kDeepCapBlocks = 4;

// table row widths (kernels/tables.py TABLE_COLS)
constexpr int kTri = 25, kOcc = 16, kSph = 6, kMat = 13, kEmt = 17, kEmeta = 4;
// the triangle table's row stride in shared memory and the leaf-ordered
// triangle table's in global memory (tables.py LEAF_COLS): 16-byte aligned
// rows; in the leaf table, float 25 of a row is its row in `tri` (int bits)
constexpr int kTriSmem = 28;
constexpr int kLeafId = 25;

struct Params {
  const float* tables[8];  // tri, occ, sph, mat, emt, emeta, lcum, par
  const float* env;        // (env_h, env_w, 3) env map
  const float* bvh;        // (rows, 16) child-pair node rows (tables.py EXTRA)
  const float* leaf;       // (L, kTriSmem) triangle rows in leaf order
  int rows[6];             // tri, occ, sph, mat, emt (= emeta), lcum
  float* out_rad;
  float* out_rays;
  int seed, lane_offset, n_lanes, spp, width, height, max_bounces, n_dir;
  int enable_shadow, textured, n_sph_emitters, use_dof;
  int env_h, env_w, use_env, use_bvh;
  int lane_stride;  // thread idx runs lane lane_offset + idx * lane_stride
  float xscale, yscale, om[9], pos[3], focal, aperture, inv_n_dir;
  // a tree of more than kStack levels: the deep instances' walk stacks,
  // 3 x bvh_depth x n_lanes ints (DeepStack)
  int* deep_stack;
  int bvh_depth;
};

struct Tables {
  const float *tri, *occ, *sph, *mat, *emt, *emeta, *lcum, *par;
  int n_tri, n_occ, n_sph, n_mat, n_emt, n_lcum;
  const float *env, *bvh, *leaf;
  int env_h, env_w;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 neg(V3 a) { return mk(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 normalize(V3 a) {
  // correctly rounded 1/sqrt (no rsqrt approximation)
  float inv = 1.0f / sqrtf(fmaxf(dot(a, a), 1e-20f));
  return scale(a, inv);
}
__device__ __forceinline__ float ssqrt(float x) { return sqrtf(fmaxf(x, 1e-12f)); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
__device__ __forceinline__ float pick3(int chan, float r, float g, float b) {
  return chan == 0 ? r : (chan == 1 ? g : b);
}
__device__ __forceinline__ V3 reflect(V3 wo, V3 n) {
  float s = 2.0f * dot(wo, n);
  return sub(scale(n, s), wo);
}

// ---- counter-based RNG (megakernel.py:138-158) ----------------------------

__device__ __forceinline__ uint32_t murmur(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ float unit(uint32_t x) {
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
}

// ---- camera (megakernel.py:2021-2062) -------------------------------------

__device__ __forceinline__ V3 rot(const float* om, V3 v) {
  return mk(om[0] * v.x + om[1] * v.y + om[2] * v.z,
            om[3] * v.x + om[4] * v.y + om[5] * v.z,
            om[6] * v.x + om[7] * v.y + om[8] * v.z);
}

// The camera ray of pixel (fi, fj); u(c) is the sample's draw c: 0 and 1
// place it in the pixel, 2 and 3 on the lens (read only with DoF on).
template <class Draw>
__device__ __forceinline__ void cam_ray_with(const Params& P, float fi, float fj, Draw u, V3& o,
                                             V3& d) {
  float u0 = u(0u);
  float u1 = u(1u);
  float x = (1.0f - 2.0f * (fi + u0) / static_cast<float>(P.width)) * P.xscale;
  float y = (1.0f - 2.0f * (fj + u1) / static_cast<float>(P.height)) * P.yscale;
  V3 dirs;
  if (P.use_dof) {
    float u2 = u(2u);
    float u3 = u(3u);
    float r = P.aperture * sqrtf(u2);
    float theta = kTwoPi * u3;
    float dx = r * cosf(theta);
    float dy = r * sinf(theta);
    V3 lens = rot(P.om, mk(dx, dy, 0.0f));
    o = mk(P.pos[0] + lens.x, P.pos[1] + lens.y, P.pos[2] + lens.z);
    float fd = P.focal;
    dirs = mk(x * fd - dx, y * fd - dy, 1.0f * fd);
  } else {
    o = mk(P.pos[0], P.pos[1], P.pos[2]);
    dirs = mk(x, y, 1.0f);
  }
  d = rot(P.om, normalize(dirs));
}

// ---- brute-force sweeps (megakernel.py:323-863) ----------------------------

struct Hit {
  V3 p, n;
  float uvx, uvy, mat;
  bool happened, emissive;
};

// The running winner of a nearest-hit query.
struct Near {
  float t, n0, n1, n2, uvx, uvy, mat, em;
  int sph;
};

// The leading 16 floats of a table row in shared memory (the Woop or
// shadow-fan transform of a triangle: w[0..12]) into registers w, as four
// float4 loads: the rows start 16 bytes aligned.
__device__ __forceinline__ void row_head(const float* row, float* w) {
  const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 a = q[k];
    w[4 * k] = a.x;
    w[4 * k + 1] = a.y;
    w[4 * k + 2] = a.z;
    w[4 * k + 3] = a.w;
  }
}

// Woop test of ray (o, d) against triangle row w: t, or kTMax on a miss.
// Pad rows carry nr2 = 0 and fail the |det| >= ε term: never skip it.
__device__ __forceinline__ float woop(const float* w, V3 o, V3 d, float& u, float& v) {
  float dp2 = d.x * w[6] + d.y * w[7] + d.z * w[8];
  float op2 = o.x * w[6] + o.y * w[7] + o.z * w[8] - w[11];
  float det = -(dp2 * w[12]);
  float det_g = fabsf(det) >= kEps ? det : 1.0f;
  float t_hit = op2 * w[12] / det_g;
  float dp0 = d.x * w[0] + d.y * w[1] + d.z * w[2];
  float op0 = o.x * w[0] + o.y * w[1] + o.z * w[2] - w[9];
  u = op0 + t_hit * dp0;
  float dp1 = d.x * w[3] + d.y * w[4] + d.z * w[5];
  float op1 = o.x * w[3] + o.y * w[4] + o.z * w[5] - w[10];
  v = op1 + t_hit * dp1;
  float m = fminf(fminf(u, v), fminf(fminf(1.0f - (u + v), t_hit), fabsf(det) - kEps));
  return m >= 0.0f ? t_hit : kTMax;
}

// Take triangle row w (barycentrics u, v) as the winner at t.
__device__ __forceinline__ void take_tri(Near& h, const float* w, float t, float u, float v,
                                         bool textured) {
  h.t = t;
  h.n0 = w[14];
  h.n1 = w[15];
  h.n2 = w[16];
  if (textured) {
    float w0 = 1.0f - u - v;
    h.uvx = w0 * w[17] + u * w[19] + v * w[21];
    h.uvy = w0 * w[18] + u * w[20] + v * w[22];
  }
  h.mat = w[23];
  h.em = w[24];
  h.sph = -1;
}

// Every sphere after the triangles, strict `<`: a tie stays with a triangle.
__device__ __forceinline__ void near_spheres(const Tables& T, V3 o, V3 d, Near& h) {
  float a = d.x * d.x + d.y * d.y + d.z * d.z;
  bool a_ok = a > 1e-12f;
  float a_safe = fmaxf(a, 1e-12f);
  for (int s = 0; s < T.n_sph; ++s) {
    const float* S = T.sph + s * kSph;
    float r = S[3];
    float l0 = o.x - S[0], l1 = o.y - S[1], l2 = o.z - S[2];
    float bq = 2.0f * (d.x * l0 + d.y * l1 + d.z * l2);
    float cq = l0 * l0 + l1 * l1 + l2 * l2 - r * r;
    float disc = bq * bq - 4.0f * a_safe * cq;
    bool ok = disc >= 0.0f && a_ok && r > 0.0f;
    float sq = sqrtf(fmaxf(disc, 0.0f));
    float q = bq > 0.0f ? -0.5f * (bq + sq) : -0.5f * (bq - sq);
    float qs = fabsf(q) > 1e-10f ? q : 1.0f;
    float x0 = q / a_safe;
    float x1 = cq / qs;
    float lo = fminf(x0, x1), hi = fmaxf(x0, x1);
    float t = lo < 0.0f ? hi : lo;
    ok = ok && t >= 0.0f;
    float t_cand = ok ? t : kTMax;
    if (t_cand < h.t) {
      h.t = t_cand;
      h.n0 = h.n1 = h.n2 = 0.f;
      h.uvx = h.uvy = 0.f;
      h.mat = S[4];
      h.em = S[5];
      h.sph = s;
    }
  }
}

__device__ __forceinline__ Hit finish(const Tables& T, V3 o, V3 d, const Near& w) {
  Hit h;
  h.happened = w.t < kTMax;
  float t_eff = h.happened ? w.t : 0.0f;
  h.p = mk(o.x + d.x * t_eff, o.y + d.y * t_eff, o.z + d.z * t_eff);
  if (w.sph >= 0) {
    const float* S = T.sph + w.sph * kSph;
    h.n = normalize(mk(h.p.x - S[0], h.p.y - S[1], h.p.z - S[2]));
  } else {
    h.n = mk(w.n0, w.n1, w.n2);
  }
  h.uvx = w.uvx;
  h.uvy = w.uvy;
  h.mat = w.mat;
  h.emissive = w.em > 0.5f;
  return h;
}

// The nearest hit over the shared-memory tables (kTriSmem-strided rows).
__device__ Hit nearest(const Tables& T, V3 o, V3 d, bool textured) {
  Near h = {kTMax, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1};
  for (int i = 0; i < T.n_tri; ++i) {
    const float* row = T.tri + i * kTriSmem;
    float w[16];
    row_head(row, w);
    float u, v;
    float t_cand = woop(w, o, d, u, v);
    if (t_cand < h.t) take_tri(h, row, t_cand, u, v, textured);
  }
  near_spheres(T, o, d, h);
  return finish(T, o, d, h);
}

// ---- the BVH walks (replacing mcpt_tpu/kernels/cluster.py:257, 547, 835) --
//
// Both walk the child-pair rows of kernels/tables.py `bvh_tables` from global
// memory (through L1 and L2: a 38k-triangle scene's rows and leaf triangles
// are ~5 MB), one row per step: a row holds both children's boxes, so a step
// tests two boxes from four float4 loads and the next address depends on one
// result only every other level. Leaf children are tested in place from the
// leaf-ordered triangle rows (float4 loads, no index table); of interior
// children one is descended into and the other pushed on the walk's stack
// (LocalStack, or DeepStack for a tree of more than kStack levels).
// megakernel_ref.py's `bvh_nearest` and `bvh_fan` walk the same rows in the
// same order.

// The leading 16 floats of a row in global memory, as four read-only float4
// loads (the row starts 16 bytes aligned).
__device__ __forceinline__ void row_head_ldg(const float* row, float* w) {
  const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 a = __ldg(q + k);
    w[4 * k] = a.x;
    w[4 * k + 1] = a.y;
    w[4 * k + 2] = a.z;
    w[4 * k + 3] = a.w;
  }
}

// One child-pair row: the boxes of children 0 and 1 (min3 max3 each) and,
// per child, its link and count (count > 0: a leaf of `count` leaf rows from
// `link`; count 0: interior with row `link` >= 1, or empty if link is 0).
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

// Entry and exit t of the ray (o, 1/d) through box bx: min bx[0..2], max
// bx[3..5].
__device__ __forceinline__ void slab(const float* bx, V3 o, V3 inv, float& tmin, float& tmax) {
  float a0 = (bx[0] - o.x) * inv.x, b0 = (bx[3] - o.x) * inv.x;
  float a1 = (bx[1] - o.y) * inv.y, b1 = (bx[4] - o.y) * inv.y;
  float a2 = (bx[2] - o.z) * inv.z, b2 = (bx[5] - o.z) * inv.z;
  tmin = fmaxf(fmaxf(fminf(a0, b0), fminf(a1, b1)), fminf(a2, b2));
  tmax = fminf(fminf(fmaxf(a0, b0), fmaxf(a1, b1)), fmaxf(a2, b2));
}

// Does the ray pass through the box? (The bound is tested apart:
// tmin - kEps <= bound.)
__device__ __forceinline__ bool passes(float tmin, float tmax) {
  return tmin - kEps <= tmax && tmax >= -kEps;
}

// Test the `cnt` leaf rows from `first` against the ray (o, d), keeping the
// nearest: equal t goes to the lower row of `tri` (float kLeafId).
__device__ __forceinline__ void leaf_nearest(const Tables& T, int first, int cnt, V3 o, V3 d,
                                             float& t_best, int& best, int& best_row, float& bu,
                                             float& bv) {
  for (int j = 0; j < cnt; ++j) {
    const float* row = T.leaf + (first + j) * kTriSmem;
    float w[16];
    row_head_ldg(row, w);
    float u, v;
    const float t_cand = woop(w, o, d, u, v);
    if (t_cand < t_best || (t_cand == t_best && t_cand < kTMax)) {
      const int id = __float_as_int(__ldg(row + kLeafId));
      if (t_cand < t_best || id < best) {
        t_best = t_cand;
        best = id;
        best_row = first + j;
        bu = u;
        bv = v;
      }
    }
  }
}

// A walk's stack: an entry is a link, a count and a key (the entry t of a
// nearest walk, the ray mask of a fan walk), pushed at most once a tree
// level. LocalStack views kStack entries in three per-thread arrays (local
// memory) that the shallow walk declares, for trees of up to kStack levels;
// DeepStack (below) keeps one entry a level in device memory, for deeper
// trees. The walks are templates over the two, so that a deep tree walks the
// same items in the same order. The arrays stay three locals of the walk's
// function: held in one struct, they moved the shallow BVH instances' stack
// frames and spills (mega_ab.py).
template <class K>
struct LocalStack {
  int *link_, *cnt_;
  K* key_;
  __device__ __forceinline__ void push(int sp, int link, int cnt, K key) {
    link_[sp] = link;
    cnt_[sp] = cnt;
    key_[sp] = key;
  }
  __device__ __forceinline__ K key(int sp) const { return key_[sp]; }
  __device__ __forceinline__ int link(int sp) const { return link_[sp]; }
  __device__ __forceinline__ int cnt(int sp) const { return cnt_[sp]; }
};

// A key as the int that DeepStack stores, and back.
__device__ __forceinline__ int key_bits(float t) { return __float_as_int(t); }
__device__ __forceinline__ int key_bits(uint32_t mask) { return static_cast<int>(mask); }
template <class K>
__device__ __forceinline__ K key_of(int bits) {
  if constexpr (std::is_same_v<K, float>) {
    return __int_as_float(bits);
  } else {
    return static_cast<K>(bits);
  }
}

// The stack of a walk through a tree of more than kStack levels, so that a
// tree of any depth renders, as the JAX package's stackless walks render it.
// Each thread's entries are three int arrays of bvh_depth x n_lanes (link,
// count, key), entry e at e * n_lanes + idx, so that a warp's pushes and pops
// at one level touch neighbouring words. One nearest or fan walk runs at a
// time on a thread, so they share its entries. Memory: 12 bytes a level a
// lane, 805 MB for a 64-level tree over a 1080p block of 1,048,576 lanes,
// where a per-thread local array sized for the deepest tree would reserve as
// much for every resident thread of every launch.
template <class K>
struct DeepStack {
  int *link_, *cnt_, *key_;
  size_t level;  // the stride between a thread's entries: the launch's lanes
  __device__ __forceinline__ void push(int sp, int link, int cnt, K key) {
    link_[sp * level] = link;
    cnt_[sp * level] = cnt;
    key_[sp * level] = key_bits(key);
  }
  __device__ __forceinline__ K key(int sp) const { return key_of<K>(key_[sp * level]); }
  __device__ __forceinline__ int link(int sp) const { return link_[sp * level]; }
  __device__ __forceinline__ int cnt(int sp) const { return cnt_[sp * level]; }
};

template <class K>
__device__ __forceinline__ DeepStack<K> deep_stack(const Params& P) {
  const size_t n = static_cast<size_t>(P.n_lanes);
  int* base = P.deep_stack + (blockIdx.x * blockDim.x + threadIdx.x);
  const size_t plane = n * static_cast<size_t>(P.bvh_depth);
  return {base, base + plane, base + 2 * plane, n};
}

// Nearest hit through the BVH: the brute sweep's answer, ties included
// (equal t goes to the lower triangle row, triangles beat spheres).
//
// Near first: of a row's two children the one the ray enters first is taken
// (child 0 on equal entry t) and the other pushed with its entry t; a child,
// or a popped entry, is entered while its entry t - kEps <= the best t so
// far, the margin of the brute sweep's box test, so the winner's boxes are
// always entered and the order changes only how much is pruned.
//
// While-while (Aila and Laine, "Understanding the efficiency of ray
// traversal on GPUs", 2009): a thread descends interior rows until it holds
// a leaf, and the warp's threads then test their leaves together. Testing
// each row's leaf children in place instead ran up to two sparse leaf loops
// per step, and was slower than the stackless walk it replaced (PERF.md).
template <class Stack>
__device__ __forceinline__ Hit nearest_walk(const Tables& T, V3 o, V3 d, bool textured,
                                            Stack& st) {
  const V3 inv = mk(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  float t_best = kTMax, bu = 0.0f, bv = 0.0f;
  int best = -1, best_row = -1;  // the winner's row in `tri` and in `leaf`
  int sp = 0;
  int link = 0, cnt = 0;  // the item to visit: a row (cnt 0) or a leaf; link -1: none
  auto pop = [&] {  // the next entry still in reach
    link = -1;
    while (sp > 0) {
      --sp;
      if (st.key(sp) - kEps <= t_best) {
        link = st.link(sp);
        cnt = st.cnt(sp);
        return;
      }
    }
  };
  while (link >= 0) {
    while (link >= 0 && cnt == 0) {
      const NodeRow r = load_row(T.bvh, link);
      float t0, x0, t1, x1;
      slab(r.box, o, inv, t0, x0);
      slab(r.box + 6, o, inv, t1, x1);
      const bool swap = t1 < t0;  // child 1 is entered first: it is child a
      const float ta = swap ? t1 : t0, tb = swap ? t0 : t1;
      const int la = swap ? r.link1 : r.link0, lb = swap ? r.link0 : r.link1;
      const int ca = swap ? r.cnt1 : r.cnt0, cb = swap ? r.cnt0 : r.cnt1;
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
    leaf_nearest(T, link, cnt, o, d, t_best, best, best_row, bu, bv);
    pop();
  }
  Near h = {kTMax, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1};
  if (best_row >= 0) take_tri(h, T.leaf + best_row * kTriSmem, t_best, bu, bv, textured);
  near_spheres(T, o, d, h);
  return finish(T, o, d, h);
}

// The nearest walk of a tree of up to kStack levels ...
__device__ Hit nearest_bvh(const Tables& T, V3 o, V3 d, bool textured) {
  int stack_link[kStack], stack_cnt[kStack];
  float stack_t[kStack];
  LocalStack<float> st{stack_link, stack_cnt, stack_t};
  return nearest_walk(T, o, d, textured, st);
}

// ... and of a deeper one.
__device__ Hit nearest_bvh_deep(const Tables& T, V3 o, V3 d, bool textured,
                                DeepStack<float> st) {
  return nearest_walk(T, o, d, textured, st);
}

// The shadow fan's division-free blocked-visibility predicate for one
// triangle: every Möller-Trumbore condition multiplied through by |det|,
// blocking at t < xs. op0, op1 and q = op2·nr2 are the origin's terms.
__device__ __forceinline__ bool tri_blocks(const float* w, float op0, float op1, float q, V3 e,
                                           float xs) {
  float dp2 = e.x * w[6] + e.y * w[7] + e.z * w[8];
  float det = -(dp2 * w[12]);
  float dets = fabsf(det);
  float qs = det < 0.0f ? -q : q;
  float dp0 = e.x * w[0] + e.y * w[1] + e.z * w[2];
  float u_s = op0 * dets + qs * dp0;
  float dp1 = e.x * w[3] + e.y * w[4] + e.z * w[5];
  float v_s = op1 * dets + qs * dp1;
  float m = fminf(fminf(qs, dets - kEps), fminf(fminf(u_s, v_s), dets - (u_s + v_s)));
  return m >= 0.0f && xs * dets - qs > 0.0f;
}

// The same for one sphere (l = o - c, cq = |l|² - r²), a = 1 q-form roots.
__device__ __forceinline__ bool sph_blocks(float l0, float l1, float l2, float cq, bool r_ok, V3 e,
                                           float xs) {
  float hb = e.x * l0 + e.y * l1 + e.z * l2;
  float disc = hb * hb - cq;
  bool ok = disc >= 0.0f && r_ok;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float qq = hb > 0.0f ? -(hb + sq) : -(hb - sq);
  float qs = fabsf(qq) > 1e-10f ? qq : 1.0f;
  float x1 = cq / qs;
  float lo = fminf(qq, x1), hi = fmaxf(qq, x1);
  float t = lo < 0.0f ? hi : lo;
  return ok && t >= 0.0f && t < xs;
}

// Shared-origin S-ray shadow fan: vis[si] is true when nothing blocks ray si
// at t < dist − max(ε, REL_EPS·dist).
template <int NS>
__device__ void occlude_fan(const Tables& T, V3 o, const V3* ws, const float* dists,
                            int ns, bool* vis) {
  float xs[NS];
  bool blocked[NS];
  int n_open = ns;
#pragma unroll
  for (int si = 0; si < NS; ++si) {
    if (si < ns) {
      xs[si] = dists[si] - fmaxf(kRelEps * dists[si], kEps);
      blocked[si] = false;
    }
  }
  for (int i = 0; i < T.n_occ && n_open > 0; ++i) {
    float w[16];
    row_head(T.occ + i * kOcc, w);
    float op2 = o.x * w[6] + o.y * w[7] + o.z * w[8] - w[11];
    float op0 = o.x * w[0] + o.y * w[1] + o.z * w[2] - w[9];
    float op1 = o.x * w[3] + o.y * w[4] + o.z * w[5] - w[10];
    float q = op2 * w[12];
#pragma unroll
    for (int si = 0; si < NS; ++si) {
      if (si >= ns || blocked[si]) continue;
      if (tri_blocks(w, op0, op1, q, ws[si], xs[si])) {
        blocked[si] = true;
        --n_open;
      }
    }
  }
  for (int s = 0; s < T.n_sph && n_open > 0; ++s) {
    const float* S = T.sph + s * kSph;
    float r = S[3];
    float l0 = o.x - S[0], l1 = o.y - S[1], l2 = o.z - S[2];
    float cq = l0 * l0 + l1 * l1 + l2 * l2 - r * r;
    bool r_ok = r > 0.0f;
#pragma unroll
    for (int si = 0; si < NS; ++si) {
      if (si >= ns || blocked[si]) continue;
      if (sph_blocks(l0, l1, l2, cq, r_ok, ws[si], xs[si])) {
        blocked[si] = true;
        --n_open;
      }
    }
  }
#pragma unroll
  for (int si = 0; si < NS; ++si) {
    if (si < ns) vis[si] = !blocked[si];
  }
}

// Test the `cnt` leaf rows from `first` against the fan's rays in mask `m`
// that are still open, clearing from `open` the rays a row blocks; the
// origin's terms once a row.
template <int NS>
__device__ __forceinline__ void leaf_fan(const Tables& T, int first, int cnt, V3 o, const V3* ws,
                                         const float* xs, uint32_t m, uint32_t& open) {
  for (int j = 0; j < cnt; ++j) {
    const uint32_t live = m & open;
    if (!live) break;
    float w[16];
    row_head_ldg(T.leaf + (first + j) * kTriSmem, w);
    float op2 = o.x * w[6] + o.y * w[7] + o.z * w[8] - w[11];
    float op0 = o.x * w[0] + o.y * w[1] + o.z * w[2] - w[9];
    float op1 = o.x * w[3] + o.y * w[4] + o.z * w[5] - w[10];
    float q = op2 * w[12];
#pragma unroll
    for (int si = 0; si < NS; ++si) {
      if (!((live >> si) & 1u)) continue;
      if (tri_blocks(w, op0, op1, q, ws[si], xs[si])) open &= ~(1u << si);
    }
  }
}

// One walk through the BVH for ns <= NS <= 32 shadow rays that share the
// origin o. The walk carries the mask of the rays that entered the current row's box and are still open: a child is entered
// when any of them passes its box before its own bound xs, with the mask of
// those that do; a leaf tests its rows against them and clears the rays a
// row blocks; child 0 goes first and child 1 is pushed with its mask; a
// popped entry keeps those of its rays still open; the walk ends when every
// ray is blocked. A ray is tested against exactly the triangles whose boxes
// it enters, as its own walk would test it. Leaves wait as in nearest_bvh:
// a thread descends rows until it holds a leaf. Then the spheres, by brute
// force.
template <int NS, class Stack>
__device__ __forceinline__ void fan_walk(const Tables& T, V3 o, const V3* ws, const float* dists,
                                         int ns, bool* vis, Stack& st) {
  float xs[NS];
  V3 inv[NS];
  uint32_t open = 0;
#pragma unroll
  for (int si = 0; si < NS; ++si) {
    if (si < ns) {
      xs[si] = dists[si] - fmaxf(kRelEps * dists[si], kEps);
      inv[si] = mk(1.0f / ws[si].x, 1.0f / ws[si].y, 1.0f / ws[si].z);
      open |= 1u << si;
    }
  }
  int sp = 0;
  // the item to visit: a row (cnt 0) or a leaf, with its rays; link -1: none
  int link = open ? 0 : -1, cnt = 0;
  uint32_t mask = open;
  auto pop = [&] {  // the next entry with an open ray
    link = -1;
    while (open && sp > 0) {
      --sp;
      const uint32_t m_sp = st.key(sp);
      if (m_sp & open) {
        link = st.link(sp);
        cnt = st.cnt(sp);
        mask = m_sp & open;
        return;
      }
    }
  };
  while (link >= 0) {
    while (link >= 0 && cnt == 0) {
      const NodeRow r = load_row(T.bvh, link);
      uint32_t m0 = 0, m1 = 0;
#pragma unroll
      for (int si = 0; si < NS; ++si) {
        if (!((mask >> si) & 1u)) continue;
        float t0, x0, t1, x1;
        slab(r.box, o, inv[si], t0, x0);
        slab(r.box + 6, o, inv[si], t1, x1);
        if ((r.cnt0 > 0 || r.link0 > 0) && passes(t0, x0) && t0 - kEps <= xs[si]) m0 |= 1u << si;
        if ((r.cnt1 > 0 || r.link1 > 0) && passes(t1, x1) && t1 - kEps <= xs[si]) m1 |= 1u << si;
      }
      if (m0) {
        if (m1) {
          st.push(sp, r.link1, r.cnt1, m1);
          ++sp;
        }
        link = r.link0;
        cnt = r.cnt0;
        mask = m0;
      } else if (m1) {
        link = r.link1;
        cnt = r.cnt1;
        mask = m1;
      } else {
        pop();
      }
    }
    if (link < 0) break;
    leaf_fan<NS>(T, link, cnt, o, ws, xs, mask, open);
    pop();
  }
  for (int s = 0; s < T.n_sph && open; ++s) {
    const float* S = T.sph + s * kSph;
    float r = S[3];
    float l0 = o.x - S[0], l1 = o.y - S[1], l2 = o.z - S[2];
    float cq = l0 * l0 + l1 * l1 + l2 * l2 - r * r;
    bool r_ok = r > 0.0f;
#pragma unroll
    for (int si = 0; si < NS; ++si) {
      if (!((open >> si) & 1u)) continue;
      if (sph_blocks(l0, l1, l2, cq, r_ok, ws[si], xs[si])) open &= ~(1u << si);
    }
  }
#pragma unroll
  for (int si = 0; si < NS; ++si) {
    if (si < ns) vis[si] = (open >> si) & 1u;
  }
}

// The fan walk of a tree of up to kStack levels.
template <int NS>
__device__ void occlude_fan_walk(const Tables& T, V3 o, const V3* ws, const float* dists,
                                 int ns, bool* vis) {
  int stack_link[kStack], stack_cnt[kStack];
  uint32_t stack_mask[kStack];
  LocalStack<uint32_t> st{stack_link, stack_cnt, stack_mask};
  fan_walk<NS>(T, o, ws, dists, ns, vis, st);
}

// The fan through the BVH: the S = 4 instances walk the vertex's rays
// together; the generic instances (NS > 4) walk each ray alone, since a walk
// of 16 or 32 rays keeps their inverse directions and bounds live and spills
// (at 32 light samples it was slower than one walk a ray, PERF.md).
template <int NS>
__device__ void occlude_fan_bvh(const Tables& T, V3 o, const V3* ws, const float* dists,
                                int ns, bool* vis) {
  if constexpr (NS > 4) {
    for (int si = 0; si < ns; ++si) occlude_fan_walk<1>(T, o, ws + si, dists + si, 1, vis + si);
  } else {
    occlude_fan_walk<NS>(T, o, ws, dists, ns, vis);
  }
}

// occlude_fan_bvh of a tree of more than kStack levels.
template <int NS>
__device__ void occlude_fan_bvh_deep(const Tables& T, V3 o, const V3* ws, const float* dists,
                                     int ns, bool* vis, DeepStack<uint32_t> st) {
  if constexpr (NS > 4) {
    for (int si = 0; si < ns; ++si) fan_walk<1>(T, o, ws + si, dists + si, 1, vis + si, st);
  } else {
    fan_walk<NS>(T, o, ws, dists, ns, vis, st);
  }
}

// ---- the env map (mcpt_tpu/envmap.py:14, Scene.hpp:60-99) ------------------

// Channel `chan` of the env radiance along d: phi = atan2(z, x), theta =
// acos(y), u wraps, v clamps, bilinear over texel centres at -0.5.
__device__ float env_lookup(const Tables& T, V3 d, int chan) {
  const int h = T.env_h, w = T.env_w;
  float n2 = dot(d, d);
  float inv = n2 > 1e-12f ? 1.0f / sqrtf(n2) : 0.0f;
  float phi = atan2f(d.z * inv, d.x * inv);
  float theta = acosf(clampf(d.y * inv, -1.0f, 1.0f));
  float u = (phi + kPi) / kTwoPi;
  float v = theta / kPi;
  u = u - floorf(u);
  v = clampf(v, 0.0f, 1.0f);
  float x = u * static_cast<float>(w) - 0.5f;
  float y = v * static_cast<float>(h) - 0.5f;
  float x0 = floorf(x), y0 = floorf(y);
  float sx = x - x0, sy = y - y0;
  int x0i = static_cast<int>(x0), y0i = static_cast<int>(y0);
  int x0w = ((x0i % w) + w) % w, x1w = (((x0i + 1) % w) + w) % w;
  int y0c = min(max(y0i, 0), h - 1), y1c = min(max(y0i + 1, 0), h - 1);
  float c00 = __ldg(T.env + (y0c * w + x0w) * 3 + chan);
  float c10 = __ldg(T.env + (y0c * w + x1w) * 3 + chan);
  float c01 = __ldg(T.env + (y1c * w + x0w) * 3 + chan);
  float c11 = __ldg(T.env + (y1c * w + x1w) * 3 + chan);
  float c0 = c00 * (1.0f - sx) + c10 * sx;
  float c1 = c01 * (1.0f - sx) + c11 * sx;
  return c0 * (1.0f - sy) + c1 * sy;
}

// ---- materials and the BSDF (megakernel.py:867-1137) -----------------------

struct Mat {
  float mtype, ior_a, ior_b, rough, refl, emit, textured, dirac;
};

__device__ Mat gather_mat(const Tables& T, float mat_id, int chan) {
  Mat m = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int k = static_cast<int>(mat_id);
  if (k < 0 || k >= T.n_mat || static_cast<float>(k) != mat_id) return m;
  const float* r = T.mat + k * kMat;
  m.mtype = r[0];
  m.ior_a = r[1];
  m.ior_b = r[2];
  m.rough = r[3];
  m.refl = pick3(chan, r[4], r[5], r[6]);
  m.emit = pick3(chan, r[7], r[8], r[9]);
  m.textured = r[10];
  m.dirac = r[11];
  return m;
}

__device__ __forceinline__ bool is_conductor(float t) { return t < 1.5f; }
__device__ __forceinline__ bool is_rough(float t) {
  return fabsf(t - 1.0f) < 0.25f || fabsf(t - 3.0f) < 0.25f;
}

__device__ float chessboard(float u, float v) {
  float col = truncf((u - 0.05f) * 10.0f);
  float row = truncf(v * 12.0f);
  bool in_board = col >= 3.0f && col <= 5.0f && row <= 7.0f;
  float s = col + row;
  bool is_white = (s - truncf(s * 0.5f) * 2.0f) == 1.0f;
  return in_board && is_white ? 0.9f : 0.1f;
}

__device__ __forceinline__ float fresnel_schlick(float cos_theta, float f0) {
  float inv = 1.0f - cos_theta;
  float c2 = inv * inv;
  return f0 + (1.0f - f0) * c2 * c2 * inv;
}

__device__ float fresnel(const Mat& m, float ior, V3 incident, V3 nrm) {
  if (is_conductor(m.mtype)) return 1.0f;
  float cosi = clampf(dot(incident, nrm), -1.0f, 1.0f);
  bool outside = cosi <= 0.0f;
  float etai = outside ? 1.0f : ior;
  float etat = outside ? ior : 1.0f;
  float sint = etai / etat * ssqrt(1.0f - cosi * cosi);
  if (sint >= 1.0f) return 1.0f;  // total internal reflection
  float cost = ssqrt(1.0f - sint * sint);
  float aci = fabsf(cosi);
  float rs_den = fmaxf(etat * aci + etai * cost, 1e-6f);
  float rp_den = fmaxf(etai * aci + etat * cost, 1e-6f);
  float rs = (etat * aci - etai * cost) / rs_den;
  float rp = (etai * aci - etat * cost) / rp_den;
  return 0.5f * (rs * rs + rp * rp);
}

__device__ V3 refract(float ior, V3 incident, V3 nrm) {
  float cosi = clampf(dot(incident, nrm), -1.0f, 1.0f);
  bool entering = cosi < 0.0f;
  float etai = entering ? 1.0f : ior;
  float etat = entering ? ior : 1.0f;
  V3 n = entering ? nrm : neg(nrm);
  float ci = fabsf(cosi);
  float eta = etai / etat;
  float k = 1.0f - eta * eta * (1.0f - ci * ci);
  if (!(k >= 0.0f)) return mk(0.f, 0.f, 0.f);
  float coef = eta * ci - ssqrt(k);
  return add(scale(incident, eta), scale(n, coef));
}

__device__ float d_ggx(V3 h, V3 n, float alpha) {
  float noh = fabsf(dot(n, h));
  if (!(noh > kEps)) return 0.0f;
  float tan2 = (1.0f - noh * noh) / (noh * noh);
  float denom = (noh * noh) * (alpha + tan2);
  denom = fabsf(denom) > 0.0f ? denom : 1.0f;
  return alpha * alpha / (kPi * denom * denom);
}

__device__ float g1(V3 v, V3 n, float alpha) {
  float nov = fabsf(dot(n, v));
  if (!(nov > kEps)) return 0.0f;
  float tan_t = ssqrt(1.0f - nov * nov) / nov;
  if (tan_t == 0.0f) return 1.0f;
  float at = alpha * tan_t;
  return 2.0f / (1.0f + sqrtf(1.0f + at * at));
}

__device__ void tangent_frame(V3 n, V3& t, V3& b) {
  if (fabsf(n.x) > fabsf(n.y)) {
    float lx = sqrtf(fmaxf(n.x * n.x + n.z * n.z, 1e-30f));
    t = mk(-n.z / lx, 0.0f, n.x / lx);
  } else {
    float ly = sqrtf(fmaxf(n.y * n.y + n.z * n.z, 1e-30f));
    t = mk(0.0f, n.z / ly, -n.y / ly);
  }
  b = cross(n, t);
}

__device__ V3 sample_mfn(const Mat& m, V3 n, float xi1, float xi2) {
  if (!is_rough(m.mtype)) return n;
  float alpha = m.rough;
  float phi = kTwoPi * xi1;
  float a2 = alpha * alpha;
  float cos_t = ssqrt(fmaxf(1.0f - xi2, 0.0f) / fmaxf(1.0f + (a2 - 1.0f) * xi2, 1e-20f));
  float sin_t = ssqrt(1.0f - cos_t * cos_t);
  float hx = sin_t * cosf(phi);
  float hy = sin_t * sinf(phi);
  V3 t, b;
  tangent_frame(n, t, b);
  return normalize(add(add(scale(t, hx), scale(b, hy)), scale(n, cos_t)));
}

__device__ __forceinline__ V3 half_reflect(V3 wi, V3 wo, V3 n) {
  V3 h = normalize(add(wi, wo));
  return dot(wi, n) > 0.0f ? h : neg(h);
}

// Material::eval (Material.hpp:330-408), the JAX kernel's default form: the
// half vector is selected by the branch before D/G1/Fresnel, and only the
// branch the material select reads is evaluated.
__device__ float eval_bsdf(const Mat& m, float ior, float refl, V3 wi, V3 wo, V3 n,
                           bool is_reflect) {
  float win = dot(wi, n);
  float won = dot(wo, n);
  bool same_side = win * won > 0.0f;
  float eta = win > 0.0f ? ior : 1.0f / ior;
  float alpha = m.rough;
  V3 nwi = neg(wi);
  bool conductor = is_conductor(m.mtype);
  V3 h;
  if (is_reflect) {
    h = half_reflect(wi, wo, n);
  } else {
    V3 h_t0 = normalize(sub(nwi, scale(wo, eta)));
    h = dot(h_t0, n) > 0.0f ? h_t0 : neg(h_t0);
  }
  if (is_rough(m.mtype)) {
    float d_h = d_ggx(h, n, alpha);
    float g_h = g1(wi, h, alpha) * g1(wo, h, alpha);
    float f_h = fresnel(m, ior, nwi, h);
    if (is_reflect) {
      float f_r = conductor ? fresnel_schlick(fabsf(dot(h, wo)), refl) : f_h;
      float denom_r = 4.0f * fabsf(win) * fabsf(won) + kEps;
      return same_side ? f_r * d_h * g_h / denom_r : 0.0f;
    }
    if (conductor || same_side || win * won == 0.0f) return 0.0f;
    float hol = dot(h, wi);
    float hov = dot(h, wo);
    float den = hol + eta * hov;
    den = den * den * fabsf(win * won);
    den = fmaxf(den, 1e-10f);
    return (1.0f - f_h) * d_h * g_h * eta * eta * fabsf(hol * hov) / den;
  }
  bool aligned = dot(h, n) >= kOneMinusEps;
  if (is_reflect) {
    if (!(same_side && aligned)) return 0.0f;
    return conductor ? fresnel_schlick(fabsf(won), refl) : fresnel(m, ior, nwi, n);
  }
  if (!conductor && !same_side && win * won != 0.0f && aligned) {
    return 1.0f - fresnel(m, ior, nwi, n);
  }
  return 0.0f;
}

// Material::pdf (Material.hpp:285-328)
__device__ float pdf(const Mat& m, float ior, V3 wi, V3 wo, V3 n, bool is_reflect) {
  float eta = dot(wi, n) > 0.0f ? ior : 1.0f / ior;
  V3 hv = sub(neg(wi), scale(wo, eta));
  V3 h_t = normalize(hv);
  if (is_rough(m.mtype)) {
    V3 h;
    float jac;
    if (is_reflect) {
      h = half_reflect(wi, wo, n);
      jac = 1.0f / fmaxf(4.0f * fabsf(dot(h, wo)), 1e-8f);
    } else {
      h = h_t;
      float d1 = fmaxf(dot(hv, hv), 1e-12f);
      jac = eta * eta * fabsf(dot(h_t, wo)) / d1;
    }
    float d = d_ggx(h, n, m.rough);
    return d * dot(n, h) * jac;
  }
  V3 h_sm = is_reflect ? normalize(add(wi, wo)) : (dot(h_t, n) > 0.0f ? h_t : neg(h_t));
  return fabsf(dot(h_sm, n)) > kOneMinusEps ? 1.0f : 0.0f;
}

// ---- what both kernels run per block ------------------------------------------

template <bool BVH>
__device__ __forceinline__ Hit trace(const Tables& T, V3 o, V3 d, bool textured) {
  if constexpr (BVH) {
    return nearest_bvh(T, o, d, textured);
  } else {
    return nearest(T, o, d, textured);
  }
}

// The nearest-hit query and the shadow fan of an instance: the deep walks
// (DEEP), the shallow ones (BVH), or the brute-force sweeps.
template <bool BVH, bool DEEP>
__device__ __forceinline__ Hit trace_any(const Params& P, const Tables& T, V3 o, V3 d) {
  if constexpr (DEEP) {
    return nearest_bvh_deep(T, o, d, P.textured, deep_stack<float>(P));
  } else {
    return trace<BVH>(T, o, d, P.textured);
  }
}

template <int NS, bool BVH, bool DEEP>
__device__ __forceinline__ void fan_any(const Params& P, const Tables& T, V3 o, const V3* ws,
                                        const float* dists, int ns, bool* vis) {
  if constexpr (DEEP) {
    occlude_fan_bvh_deep<NS>(T, o, ws, dists, ns, vis, deep_stack<uint32_t>(P));
  } else if constexpr (BVH) {
    occlude_fan_bvh<NS>(T, o, ws, dists, ns, vis);
  } else {
    occlude_fan<NS>(T, o, ws, dists, ns, vis);
  }
}

// Stage the scene tables into shared memory (a few KB for DEMO; at most
// ~181 KB at the 1024-triangle bound) and return the block's view of them.
// Triangle rows land at kTriSmem floats apart, so that every triangle and occluder row starts 16 bytes aligned (the occluder
// table follows the triangle table); the other tables keep their widths.
// The BVH instances stage neither the triangle table nor the (unused)
// occluder table: their walks read the leaf-ordered copy in global memory. Every thread of the block must call it.
template <bool BVH>
__device__ __forceinline__ Tables stage_tables(const Params& P, float* smem) {
  const int cols[8] = {kTri, kOcc, kSph, kMat, kEmt, kEmeta, 1, 8};
  const int rows[8] = {P.rows[0], P.rows[1], P.rows[2], P.rows[3],
                       P.rows[4], P.rows[4], P.rows[5], 1};
  const float* stab[8];
  int off = 0;
  for (int k = 0; k < 8; ++k) {
    if (BVH && k < 2) {
      stab[k] = P.tables[k];
      continue;
    }
    const int n = rows[k] * cols[k];
    if (k == 0) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / kTri;
        smem[off + r * kTriSmem + (i - r * kTri)] = P.tables[0][i];
      }
      stab[0] = smem + off;
      off += rows[0] * kTriSmem;
      continue;
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) smem[off + i] = P.tables[k][i];
    stab[k] = smem + off;
    off += n;
  }
  __syncthreads();
  return {stab[0], stab[1], stab[2], stab[3], stab[4], stab[5], stab[6], stab[7],
          P.rows[0], P.rows[1], P.rows[2], P.rows[3], P.rows[4], P.rows[5],
          P.env, P.bvh, P.leaf, P.env_h, P.env_w};
}

// ---- the host side of both C entries ------------------------------------------

// Every instance of both kernels has this type; kS[s_index(n_dir)] is the
// S of the instance that n_dir light samples take.
using Kernel = void (*)(Params);
constexpr int kS[3] = {4, -16, -32};
inline int s_index(int n_dir) { return n_dir == 4 ? 0 : n_dir <= 16 ? 1 : 2; }

// Params from the C interface's arrays (see the comment on each entry).
inline Params unpack_params(const void* const* tables, const int* rows, const float* fpar,
                            const int* ipar, void* out_rad, void* out_rays) {
  Params P;
  for (int k = 0; k < 8; ++k) P.tables[k] = static_cast<const float*>(tables[k]);
  P.env = static_cast<const float*>(tables[8]);
  P.bvh = static_cast<const float*>(tables[9]);
  P.leaf = static_cast<const float*>(tables[10]);
  for (int k = 0; k < 6; ++k) P.rows[k] = rows[k];
  P.out_rad = static_cast<float*>(out_rad);
  P.out_rays = static_cast<float*>(out_rays);
  P.xscale = fpar[0];
  P.yscale = fpar[1];
  for (int k = 0; k < 9; ++k) P.om[k] = fpar[2 + k];
  for (int k = 0; k < 3; ++k) P.pos[k] = fpar[11 + k];
  P.focal = fpar[14];
  P.aperture = fpar[15];
  P.inv_n_dir = fpar[16];
  P.seed = ipar[0];
  P.lane_offset = ipar[1];
  P.n_lanes = ipar[2];
  P.spp = ipar[3];
  P.width = ipar[4];
  P.height = ipar[5];
  P.max_bounces = ipar[6];
  P.n_dir = ipar[7];
  P.enable_shadow = ipar[8];
  P.textured = ipar[9];
  P.n_sph_emitters = ipar[10];
  P.use_dof = ipar[11];
  P.env_h = ipar[12];
  P.env_w = ipar[13];
  P.use_env = ipar[14];
  P.use_bvh = ipar[15];
  P.lane_stride = ipar[16];
  P.deep_stack = static_cast<int*>(const_cast<void*>(tables[11]));
  P.bvh_depth = ipar[17];
  return P;
}

// Whether P's tree takes the deep instances, and whether P gives them their
// stacks.
inline bool deep(const Params& P) { return P.use_bvh && P.bvh_depth > kStack; }
inline bool stack_ok(const Params& P) { return !deep(P) || P.deep_stack != nullptr; }

// Whether the kernels take P: at most kMaxDir light samples, a positive
// sample count and lane stride, an env map of at least 1x1.
inline bool params_ok(const Params& P) {
  return P.n_dir >= 0 && P.n_dir <= kMaxDir && P.spp > 0 && P.lane_stride > 0 && P.env_h > 0 &&
         P.env_w > 0 && P.max_bounces >= 1 && P.max_bounces <= kMaxDepth;
}

// Dynamic shared memory of one block: the tables stage_tables copies.
inline size_t smem_bytes(const Params& P) {
  const int cols[8] = {kTri, kOcc, kSph, kMat, kEmt, kEmeta, 1, 8};
  const int trows[8] = {P.rows[0], P.rows[1], P.rows[2], P.rows[3],
                        P.rows[4], P.rows[4], P.rows[5], 1};
  size_t floats = 0;
  for (int k = P.use_bvh ? 2 : 0; k < 8; ++k) {
    floats += static_cast<size_t>(trows[k]) * (k == 0 ? kTriSmem : cols[k]);
  }
  return floats * sizeof(float);
}

// Let `kernel` take P's tables in dynamic shared memory: an opt-in above
// 48 KB. Returns their bytes in smem.
inline cudaError_t allow_smem(Kernel kernel, const Params& P, size_t& smem) {
  smem = smem_bytes(P);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launch `kernel` over P's lanes, kThreads a block.
inline cudaError_t launch_lanes(Kernel kernel, const Params& P, cudaStream_t stream) {
  size_t smem;
  cudaError_t e = allow_smem(kernel, P, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (P.n_lanes + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

// What the card makes of `kernel` at P's shared memory, into out[0..4]:
// resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// threads a block, registers a thread, local (stack and spill) bytes a
// thread, dynamic shared-memory bytes a block.
inline cudaError_t kernel_info(Kernel kernel, const Params& P, int* out) {
  size_t smem;
  cudaError_t e = allow_smem(kernel, P, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = a.numRegs;
  out[3] = static_cast<int>(a.localSizeBytes);
  out[4] = static_cast<int>(smem);
  return e;
}

}  // namespace
