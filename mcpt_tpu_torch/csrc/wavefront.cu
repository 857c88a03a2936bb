// The wavefront engine's kernels: the camera rays, the two shading halves of
// a bounce around the intersector (csrc/intersect_prims.cu), and the reverse
// clamp fold. One thread a lane in shade_pre and the fold; camera_rays takes
// pixels, shade_post two lanes (below).
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
// operations of shading and, in shade_pre, the threefry hashes of the
// draws, which bound it (about 1,600 integer operations a lane at 4
// samples); camera_rays is bound by its bytes, 24 B a lane written and 8 B
// a pixel read. So each half reads a lane's state once, keeps the shading
// in registers, and derives the bounce's keys on the
// device from the path key's words (threefry2x32 of prng.py, in uint32): no
// key op, and no other op, runs on the host a bounce. Every lane runs every
// bounce, dead ones too, as in JAX, so the records match lane for lane; the
// fold reads a lane's records only up to its first terminal depth.
//
// shade_post and fold do a few float operations a lane and are bound by
// their bytes: shade_post 84 B a lane at 4 light samples, the fold about
// 20 B a lane on the DEMO's records, but some 56 B a lane of 32-byte
// sectors, since the lanes that share a sector end at different depths. At
// a tile's 196,608 lanes that is a few microseconds of DRAM, the same order
// as a cold launch's fixed chain of dependent reads (about 3 us on the H100:
// the kernel's first loads, then shade_post's gather of the next hits'
// emissive flags and its atomic, the fold's flags and then its records).
// So both issue every load of a thread before its first use. shade_post
// takes 2 lanes a thread with one 8-byte access a plane (flags as one 2-byte
// word), where the lane count and the rows' alignment let it, else a scalar
// instance of the same body, and sums its ray count over the warp and the
// block before one atomic a block. The fold, one lane a thread, reads its
// flags 8 depths at a time and then the records below the first terminal
// depth together: two round trips for the DEMO's paths.
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
  float* out[6];  // o0 o1 o2 d0 d1 d2, P·per lanes each
  int p, per, width, height, dof;
  float aspect, scale, om[9], pos[3], focal, aperture;
};

// camera_rays: one thread a pixel, whose id is read once, its (i, j) derived
// once and its draws hashed once (the lane-a-thread kernel before it hashed a
// pixel's draws for each of its per lanes). Each thread puts its pixel's ray
// in shared memory; then the block writes its pixels' lanes, each ray to its
// per consecutive lanes, consecutive threads to consecutive vectors, so that
// a warp's store is one contiguous run. The vector instance stores kCamVec
// floats (16 bytes) at a time where P·per is a multiple of kCamVec and the
// six planes start on the 16-byte grid (plane k starts at k·P·per·4 bytes);
// the scalar instance of the same body stores one. kernels/wavefront.py's
// CAMERA_VECTOR repeats kCamVec for the checks that predict the instance.
// Measured on the H100 (mega_ab.py, a tile's 65,536 pixels at 3 lanes, cold):
// 4 pixels a thread storing their own lanes (16-byte stores per vectors
// apart across a warp) ran 40% slower than the lane-a-thread kernel before
// it, which this one beats by 8-9%; staged as here, 2 and 4 pixels a thread
// (16-byte id loads, blocks of 128 and 64) ran 2% and 15% slower than one.
// Each instance forced at the same shapes: at 65,536 pixels they take the
// same time; at 147,456 pixels the 16-byte stores run 4-6% faster back to
// back (3 lanes through a thin lens, 1 lane through a pinhole) and 3.5%
// cold (the thin lens), and they are nowhere slower beyond the spread
// between turns.
constexpr int kCamThreads = 256;
constexpr int kCamVec = 4;

// the vector of V floats (V = 1 or 4)
template <int V>
struct CamVec;
template <>
struct CamVec<1> {
  using F = float;
  __device__ static F make(const float (&e)[1]) { return e[0]; }
};
template <>
struct CamVec<4> {
  using F = float4;
  __device__ static F make(const float (&e)[4]) { return make_float4(e[0], e[1], e[2], e[3]); }
};

// The pixel (i, j) = (id mod W, id div W) as floats, the division floored
// as torch's: an id in [0, 2^31) by an unsigned 32-bit division, any other
// by the 64-bit one (the same integers, so the same floats). Measured
// against the 64-bit division alone (mega_ab.py, H100): the same time cold,
// 1-3% faster back to back.
__device__ __forceinline__ void pixel_ij(long long id, int width, float& fi, float& fj) {
  if (id >= 0 && id <= 0x7fffffffLL) {
    const unsigned int u = static_cast<unsigned int>(id), w = static_cast<unsigned int>(width);
    const unsigned int q = u / w;
    fi = static_cast<float>(u - q * w);
    fj = static_cast<float>(q);
    return;
  }
  const long long w = width;
  long long q = id / w, r = id - q * w;
  if (r != 0 && (r < 0) != (w < 0)) {
    r += w;
    q -= 1;
  }
  fi = static_cast<float>(r);
  fj = static_cast<float>(q);
}

// One pixel's ray from its (i, j) and draws u (u[2], u[3] read through a
// thin lens only): o in r[0..2], d in r[3..5].
__device__ __forceinline__ void pixel_ray(const CamArgs& A, float fi, float fj,
                                          const float (&u)[4], float (&r)[6]) {
  const float x = (1.0f - 2.0f * (fi + u[0]) / static_cast<float>(A.width)) * A.aspect * A.scale;
  const float y = (1.0f - 2.0f * (fj + u[1]) / static_cast<float>(A.height)) * A.scale;
  float dir[3];
  if (A.dof) {
    const float rr = A.aperture * sqrtf(u[2]);
    const float theta = kTwoPi * u[3];
    const float dx = rr * cosf(theta), dy = rr * sinf(theta);
    const float zero = 0.0f;
    for (int c = 0; c < 3; ++c) {
      r[c] = A.pos[c] + (A.om[3 * c] * dx + A.om[3 * c + 1] * dy + A.om[3 * c + 2] * zero);
    }
    dir[0] = x * A.focal - dx;
    dir[1] = y * A.focal - dy;
    dir[2] = 1.0f * A.focal;
  } else {
    for (int c = 0; c < 3; ++c) r[c] = A.pos[c];
    dir[0] = x;
    dir[1] = y;
    dir[2] = 1.0f;
  }
  const float inv = 1.0f / sqrtf(dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2]);
  const float dn[3] = {dir[0] * inv, dir[1] * inv, dir[2] * inv};
  for (int c = 0; c < 3; ++c) {
    r[3 + c] = A.om[3 * c] * dn[0] + A.om[3 * c + 1] * dn[1] + A.om[3 * c + 2] * dn[2];
  }
}

// Pixel p of `ids` (a block's kCamThreads from b0 on, one a thread) draws
// uniform_at(key, 4·p + c) as prng.uniform(key, (P, 4)) lays them out. The
// block's lanes of a plane are then written V floats a vector, lane l
// holding the block's pixel l / per.
template <int V>
__global__ void __launch_bounds__(kCamThreads) camera_rays_kernel(CamArgs A) {
  __shared__ float rays[6][kCamThreads];
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kCamThreads;
  const int t = threadIdx.x;
  const long long left = static_cast<long long>(A.p) - static_cast<long long>(b0);
  const int n_px = left < kCamThreads ? static_cast<int>(left) : kCamThreads;
  if (t < n_px) {
    const long long id = __ldg(A.ids + b0 + t);
    const Key k = load_key(A.key);
    const uint32_t base = 4u * static_cast<uint32_t>(b0 + t);
    float u[4];
    u[0] = uniform_at(k, base);
    u[1] = uniform_at(k, base + 1u);
    if (A.dof) {
      u[2] = uniform_at(k, base + 2u);
      u[3] = uniform_at(k, base + 3u);
    }
    float fi, fj, r[6];
    pixel_ij(id, A.width, fi, fj);
    pixel_ray(A, fi, fj, u, r);
#pragma unroll
    for (int c = 0; c < 6; ++c) rays[c][t] = r[c];
  }
  __syncthreads();
  const size_t l0 = b0 * static_cast<size_t>(A.per);
  const int n_vec = n_px * A.per / V;  // whole vectors: V divides P·per and kCamThreads
  for (int v = t; v < n_vec; v += kCamThreads) {
    int px = v * V / A.per, rep = v * V - px * A.per;  // lane v·V's pixel, its lanes before
    float e[6][V];
#pragma unroll
    for (int x = 0; x < V; ++x) {
#pragma unroll
      for (int c = 0; c < 6; ++c) e[c][x] = rays[c][px];
      if (++rep == A.per) {
        rep = 0;
        ++px;
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      reinterpret_cast<typename CamVec<V>::F*>(A.out[c] + l0)[v] = CamVec<V>::make(e[c]);
    }
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

// ---- V consecutive lanes a thread -------------------------------------------

// shade_post comes in two instances of one body: kLanes = 2 lanes a thread,
// each float or int plane read and written with one 8-byte access a thread
// and each flag plane with one 2-byte access, or 1 lane a thread. (4 lanes a
// thread with 16-byte accesses measured 1-3% slower, at 90 registers; 1 lane
// 1-5% slower: mega_ab.py on the H100. The fold keeps one: 2 lanes were as
// fast cold and 0.0008 ms faster back to back, 4 lanes 7-9% slower.) The C
// entry takes kLanes when the lane count is even and every row it is given
// is aligned to its access (the tile's and the train step's shapes), and 1
// otherwise (an odd lane count, whose rows at depth > 0 or sample k > 0
// start off the 8-byte grid, or a view that starts there).
// kernels/wavefront.py's VECTOR_LANES repeats kLanes for the checks that
// predict the instance.
constexpr int kLanes = 2;

// the types of one access of V lanes: floats, ints, flag bytes
template <int V>
struct Lanes;
template <>
struct Lanes<1> {
  using F = float;
  using I = int;
  using B = unsigned char;
};
template <>
struct Lanes<2> {
  using F = float2;
  using I = int2;
  using B = unsigned short;
};

template <typename T>
__device__ __forceinline__ void unpack(T t, T (&x)[1]) {
  x[0] = t;
}
template <typename T, typename T2>
__device__ __forceinline__ void unpack(T2 t, T (&x)[2]) {
  x[0] = t.x;
  x[1] = t.y;
}

template <int V>
__device__ __forceinline__ void load_lanes(const float* p, size_t i, float (&x)[V]) {
  unpack(__ldg(reinterpret_cast<const typename Lanes<V>::F*>(p + i)), x);
}

template <int V>
__device__ __forceinline__ void load_lanes(const int* p, size_t i, int (&x)[V]) {
  unpack(__ldg(reinterpret_cast<const typename Lanes<V>::I*>(p + i)), x);
}

template <int V>
__device__ __forceinline__ void store_lanes(float* p, size_t i, const float (&x)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p + i) = make_float2(x[0], x[1]);
  } else {
    p[i] = x[0];
  }
}

// The flags of lanes i .. i + V - 1, lane j's in byte j (a bool is one byte,
// 0 or 1).
template <int V>
__device__ __forceinline__ unsigned int load_flags(const bool* p, size_t i) {
  return __ldg(reinterpret_cast<const typename Lanes<V>::B*>(p + i));
}

template <int V>
__device__ __forceinline__ void store_flags(bool* p, size_t i, unsigned int w) {
  *reinterpret_cast<typename Lanes<V>::B*>(p + i) = static_cast<typename Lanes<V>::B>(w);
}

__device__ __forceinline__ bool flag(unsigned int w, int j) { return ((w >> (8 * j)) & 0xffu) != 0u; }

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

constexpr int kPostThreads = 256;
// light-sample rows whose loads a thread has in flight at once
constexpr int kPostRows = 4;

template <int V>
struct PostRows {
  float c[kPostRows][V], t[kPostRows][V], h[kPostRows][V];  // contrib, thr, sh_t
};

// Issues the loads of the light-sample rows k0 .. k0 + kPostRows - 1 that
// exist: contrib, and thr and sh_t where the shadows are on.
template <int V>
__device__ __forceinline__ void load_post_rows(const PostArgs& A, int k0, size_t i,
                                               PostRows<V>& R) {
#pragma unroll
  for (int u = 0; u < kPostRows; ++u) {
    if (k0 + u < A.s) {
      const size_t r = static_cast<size_t>(k0 + u) * A.b + i;
      load_lanes<V>(A.contrib, r, R.c[u]);
      if (A.sh_t != nullptr) {
        load_lanes<V>(A.thr, r, R.t[u]);
        load_lanes<V>(A.sh_t, r, R.h[u]);
      }
    }
  }
}

// The bounce's rays, 1 + S a vertex: a thread's vertices summed over its
// warp, then over the block's warps, and one atomicAdd a block. An integer
// sum, so exact in any order.
__device__ __forceinline__ void add_rays(unsigned long long* rays, unsigned int vertices,
                                         int per_vertex) {
  __shared__ unsigned int warp_sums[kPostThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  vertices = __reduce_add_sync(0xffffffffu, vertices);
  if (lane == 0) warp_sums[warp] = vertices;
  __syncthreads();
  if (warp == 0) {
    const unsigned int v =
        __reduce_add_sync(0xffffffffu, lane < kPostThreads / 32 ? warp_sums[lane] : 0u);
    if (lane == 0 && v > 0u) {
      atomicAdd(rays, static_cast<unsigned long long>(v) *
                          static_cast<unsigned long long>(per_vertex));
    }
  }
}

// V lanes a thread. Every load of a thread's lanes is issued before the
// first use: the seven lane planes, the first kPostRows light-sample rows;
// then the gather of the next hits' emissive flags, which waits on nxt_prim
// alone; then the S sum from k = 0 up, further rows kPostRows at a time.
// The second launch bound, the blocks a SM its registers leave room for:
// the scalar instance 6 (at most 40 registers), so that a tile's 768 blocks
// of one lane a thread run in one wave on 132 SMs (left to itself it takes
// 54, 4 blocks a SM, and ran 5% slower than a one-lane body that keeps
// nothing in flight, at an odd lane count); the vector instance 5, what its
// own 48 registers give (with a floor of 1 it took 70 and ran 6% slower back
// to back at 442,368 lanes). mega_ab.py on the H100.
template <int V>
__global__ void __launch_bounds__(kPostThreads, V == 1 ? 6 : 5)
    shade_post_kernel(PostArgs A) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * kPostThreads + threadIdx.x) * V;
  unsigned int vertices = 0u;
  if (i < static_cast<size_t>(A.b)) {  // V > 1 only for b % V == 0: all of a thread's lanes
    float fac[V], leaf_pre[V], env_c[V], w[V], emis[V], total[V];
    int np[V];
    load_lanes<V>(A.fac, i, fac);
    load_lanes<V>(A.leaf_pre, i, leaf_pre);
    load_lanes<V>(A.env_c, i, env_c);
    load_lanes<V>(A.w, i, w);
    load_lanes<V>(A.nxt_prim, i, np);
    const unsigned int at = load_flags<V>(A.at_vertex, i), rr = load_flags<V>(A.rr_kill, i);
    PostRows<V> R;
    load_post_rows<V>(A, 0, i, R);
    for (int j = 0; j < V; ++j) {
      emis[j] = np[j] >= 0 && np[j] < A.n_emissive ? __ldg(A.emissive + np[j]) : 0.0f;
      total[j] = 0.0f;
    }
    // visibility: no hit strictly closer than the light sample
    for (int k0 = 0; k0 < A.s; k0 += kPostRows) {
      if (k0 > 0) load_post_rows<V>(A, k0, i, R);
#pragma unroll
      for (int u = 0; u < kPostRows; ++u) {
        if (k0 + u < A.s) {
          for (int j = 0; j < V; ++j) {
            float c = R.c[u][j];
            if (A.sh_t != nullptr && !(R.h[u][j] >= R.t[u][j])) c = 0.0f;
            total[j] = k0 + u == 0 ? c : total[j] + c;
          }
        }
      }
    }
    float l_dir[V], leaf[V];
    unsigned int terminal = 0u, alive = 0u;
    for (int j = 0; j < V; ++j) {
      l_dir[j] = fac[j] * total[j];
      const bool at_vertex = flag(at, j), rr_kill = flag(rr, j);
      const bool cont = at_vertex && !rr_kill && np[j] >= 0 && !(emis[j] > 0.5f);
      // a roulette kill keeps the raw l_dir (Scene.cpp:129,156)
      const float vertex_leaf =
          rr_kill ? l_dir[j] : t_clamp(l_dir[j], 0.0f, kClampDirect) + env_c[j];
      leaf[j] = at_vertex ? vertex_leaf : leaf_pre[j];
      terminal |= static_cast<unsigned int>(!cont) << (8 * j);
      alive |= static_cast<unsigned int>(cont) << (8 * j);
      vertices += at_vertex ? 1u : 0u;
    }
    store_lanes<V>(A.l_dir, i, l_dir);
    store_lanes<V>(A.w_rec, i, w);
    store_lanes<V>(A.leaf, i, leaf);
    store_flags<V>(A.terminal, i, terminal);
    store_flags<V>(A.alive, i, alive);
  }
  add_rays(A.rays, vertices, 1 + A.s);
}

// ---- fold (the reverse clamp scan) ------------------------------------------

struct FoldArgs {
  const float *l_dir, *w, *leaf;
  const bool* terminal;
  float* out;
  int b, depth;
};

// depths of flags, and then of records, whose loads a thread has in flight
// at once (4 depths of records measured 6-12% slower)
constexpr int kFoldDepths = 8;

// A terminal record replaces whatever the depths after it folded to, so a
// lane's value needs only its records up to its first terminal depth f. One
// lane a thread. The thread reads its flags kFoldDepths depths at a time,
// the chunk's loads issued together, takes the first set one from the
// chunk's bit mask, and reads the next chunk only where none is set. Then it
// issues the loads of leaf_f (0 where no depth is terminal) and of the l_dir
// and w of the depths below f, kFoldDepths depths at a time from the top,
// and folds them in registers: bitwise the full reverse scan, and no record
// at or after f (but leaf_f) reaches the value.
__global__ void __launch_bounds__(kWfThreads) fold_kernel(FoldArgs A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= A.b) return;
  const size_t b = static_cast<size_t>(A.b);
  const unsigned char* flags = reinterpret_cast<const unsigned char*>(A.terminal);
  int f = A.depth;
  for (int d0 = 0; d0 < A.depth; d0 += kFoldDepths) {
    unsigned char t[kFoldDepths];
#pragma unroll
    for (int u = 0; u < kFoldDepths; ++u) {
      t[u] = d0 + u < A.depth ? __ldg(flags + static_cast<size_t>(d0 + u) * b + i) : 0;
    }
    unsigned int set = 0u;  // bit u: depth d0 + u is terminal
#pragma unroll
    for (int u = 0; u < kFoldDepths; ++u) set |= static_cast<unsigned int>(t[u] != 0) << u;
    if (set != 0u) {
      f = d0 + __ffs(set) - 1;
      break;
    }
  }
  float radiance = f < A.depth ? __ldg(A.leaf + static_cast<size_t>(f) * b + i) : 0.0f;
  for (int hi = f; hi > 0;) {
    const int lo = max(hi - kFoldDepths, 0);
    float l[kFoldDepths], w[kFoldDepths];
#pragma unroll
    for (int u = 0; u < kFoldDepths; ++u) {
      if (lo + u < hi) {
        const size_t q = static_cast<size_t>(lo + u) * b + i;
        l[u] = __ldg(A.l_dir + q);
        w[u] = __ldg(A.w + q);
      }
    }
#pragma unroll
    for (int u = kFoldDepths - 1; u >= 0; --u) {
      if (lo + u < hi) {
        radiance = t_clamp(l[u], 0.0f, kClampDirect) +
                   t_clamp(w[u] * radiance, 0.0f, kClampIndirect);
      }
    }
    hi = lo;
  }
  A.out[i] = radiance;
}

inline int wf_blocks(int n) { return (n + kWfThreads - 1) / kWfThreads; }

inline int wf_status() { return static_cast<int>(cudaGetLastError()); }

inline bool aligned(const void* p, unsigned int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0u;
}

// Launches shade_post's instance V over A.b lanes and reports V in *lanes.
template <int V>
int launch_post(const PostArgs& A, void* stream, int* lanes) {
  constexpr int per_block = kPostThreads * V;
  shade_post_kernel<V><<<(A.b + per_block - 1) / per_block, kPostThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(A);
  *lanes = V;
  return wf_status();
}

}  // namespace

// The C entries: in/out arrays of device pointers, int and float parameters
// (see kernels/wavefront.py), the stream. Each returns 0 or the launch's
// cudaError, or -1 when it refuses its parameters; with no lanes it launches
// nothing.
extern "C" {

// camera_rays takes a sixth argument, where it reports the instance it
// launched: the floats of its stores, kCamVec or 1 (0 for no launch).
int mcpt_wf_camera(const void* const* in, void* const* out, const int* ip, const float* fp,
                   void* stream, int* floats) {
  *floats = 0;
  CamArgs A;
  A.ids = static_cast<const long long*>(in[0]);
  A.key = static_cast<const long long*>(in[1]);
  for (int k = 0; k < 6; ++k) A.out[k] = static_cast<float*>(out[k]);
  A.p = ip[0];
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
  if (A.p < 0 || A.per < 1 || A.width < 1 || A.height < 1) return -1;
  if (A.p == 0) return 0;
  bool vec = static_cast<long long>(A.p) * A.per % kCamVec == 0;
  for (int k = 0; k < 6; ++k) vec = vec && aligned(A.out[k], 4 * kCamVec);
  const int blocks = (A.p + kCamThreads - 1) / kCamThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    camera_rays_kernel<kCamVec><<<blocks, kCamThreads, 0, s>>>(A);
  } else {
    camera_rays_kernel<1><<<blocks, kCamThreads, 0, s>>>(A);
  }
  *floats = vec ? kCamVec : 1;
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

// shade_post takes a sixth argument, where it reports the instance it
// launched: its lanes a thread, kLanes or 1 (0 for no launch).
int mcpt_wf_shade_post(const void* const* in, void* const* out, const int* ip, const float* fp,
                       void* stream, int* lanes) {
  (void)fp;
  *lanes = 0;
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
  // the rows read: the lane planes, and the sample rows where S > 0 (thr and
  // sh_t only with shadows)
  const bool shadows = A.s > 0 && A.sh_t != nullptr;
  constexpr unsigned int kF = 4 * kLanes, kB = kLanes;  // an access's bytes
  const bool vec =
      A.b % kLanes == 0 && aligned(A.fac, kF) && aligned(A.leaf_pre, kF) &&
      aligned(A.env_c, kF) && aligned(A.w, kF) && aligned(A.nxt_prim, kF) &&
      aligned(A.at_vertex, kB) && aligned(A.rr_kill, kB) && (A.s == 0 || aligned(A.contrib, kF)) &&
      (!shadows || (aligned(A.thr, kF) && aligned(A.sh_t, kF))) && aligned(A.l_dir, kF) &&
      aligned(A.w_rec, kF) && aligned(A.leaf, kF) && aligned(A.terminal, kB) &&
      aligned(A.alive, kB);
  return vec ? launch_post<kLanes>(A, stream, lanes) : launch_post<1>(A, stream, lanes);
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
