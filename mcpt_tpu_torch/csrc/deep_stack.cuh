// The stack of K3's BVH walk through a tree of more than kStack levels
// (intersect_prims.cu's `intersect_walk_deep`), so that a tree of any depth
// renders, as the JAX package's stackless walks render it.
//
// An entry is a link, a count and the entry t, pushed at most once a tree
// level. The stack has two tiers:
// - the top kTier entries in the block's shared memory, three planes of
//   kTier x Stride words (Stride: the kernel's threads a block) in which a
//   thread owns a column, entry e in slot e % kTier at (e % kTier) * Stride
//   + the thread's index: a warp's accesses to one slot hit 32 banks;
// - below them, the entries that did not fit, in the ray's area of device
//   memory (`DeepArea`), moved kRun at a time: when a push finds the tier
//   full, its oldest kRun entries go out; when a pop empties it while
//   entries remain below, the kRun entries below come back.
// It is still one LIFO, so a walk visits the same items in the same order
// as with any other stack. A walk whose stack stays within kTier entries
// touches no device memory. A run goes out when the tier fills and comes
// back when a pop empties the tier, so it moves once each way for each time
// the walk's stack passes its level.
//
// Why not every entry in device memory (the stack this replaces): a walk
// of a tree whose stack reaches 63 entries pushed and popped 756 bytes a
// ray each way, each global store written through to L2, and every pop
// waited on a load of its own; at 196,608 rays that stack is three times
// the H100's 50 MB L2. Here a run is kRun independent loads or stores, and
// an entry below the tier costs its bytes once each way. Why shared memory
// and not local arrays for the tier: at K3's 1,280 resident threads a SM
// a local tier of 32 entries is 480 KB, past the L1, and local tiers of 8
// to 32 entries measured 7-15% slower than the one-tier stack there; a
// shared tier of 8 entries is 24 KB a block, and 27% faster. Why 8 entries
// and runs of 4: chosen while the megakernels' deep walk shared this stack,
// where a larger tier took L1 from their walks; for K3 alone a tier of 16
// measured within 1% in two calls and 5% faster in a third, one of 32
// slower, and runs of 2 moved too little at a time (PERF.md). The
// megakernels' deep instances keep the one-tier stack (mega_common.cuh
// DeepStack): this one, tried there with tiers of 4 to 32 entries and
// inline or out-of-line copies, was slower (PERF.md).

// The device area holds spill_entries(depth) entries a ray in three int
// planes (link, count, t), entry e of ray i at e * rays + i within a
// plane, so that a warp's spills and fills of one run touch neighbouring
// words. kernels/intersect_prims.py allocates it by the same rule
// (constants.py DEEP_TIER, DEEP_RUN, spill_entries), and the plain walk
// (intersect_prims_ref.py `intersect_walk_ref`, megakernel_ref.py `_Walk`)
// tallies the entries moved each way under `spill` and `fill`.

#pragma once

#include <cstddef>

#include <cuda_runtime.h>

namespace {

// entries of the tier a thread keeps in shared memory, and of a run moved
// between it and device memory (powers of two, kRun dividing kTier)
constexpr int kTier = 8;
constexpr int kRun = 4;
static_assert((kTier & (kTier - 1)) == 0 && kRun > 0 && kTier % kRun == 0);

// Entries of a ray's device area for a tree of `depth` levels: a walk
// pushes at most one entry a level, and entries go out in whole runs.
__host__ __device__ constexpr int spill_entries(int depth) {
  return depth > kTier ? (depth - kTier + kRun - 1) / kRun * kRun : 0;
}

// A ray's device area: `at` its entry 0's link, `level` the stride between
// its entries (the launch's rays) and `entries` its entries (spill_entries
// of the tree's depth): link, count and t planes are level x entries apart.
struct DeepArea {
  int* at;
  int level, entries;
};

// The shared memory of a block's tiers: three planes of kTier x threads
// ints.
__host__ __device__ constexpr size_t tier_bytes(int threads) {
  return 3 * sizeof(int) * static_cast<size_t>(kTier) * threads;
}

// A run's copies between a thread's column of the tiers and its device
// area (`q` its first entry), out of line: inlined, the copy out spilled in
// the walk at its 48 registers and slowed it 24% (PERF.md).
template <int Stride>
__device__ __noinline__ void spill_run(const int* tier, int lo, int* q, size_t level,
                                       size_t plane) {
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int* e = tier + ((lo + j) & (kTier - 1)) * Stride;
    q[0] = e[0];
    q[plane] = e[kTier * Stride];
    q[2 * plane] = e[2 * kTier * Stride];
    q += level;
  }
}

template <int Stride>
__device__ __noinline__ void fill_run(int* tier, int lo, const int* q, size_t level,
                                      size_t plane) {
  int l[kRun], c[kRun], k[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    l[j] = q[0];
    c[j] = q[plane];
    k[j] = q[2 * plane];
    q += level;
  }
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    int* e = tier + ((lo + j) & (kTier - 1)) * Stride;
    e[0] = l[j];
    e[kTier * Stride] = c[j];
    e[2 * kTier * Stride] = k[j];
  }
}

// A thread's stack. `tier` is the block's tiers in shared memory (tier_bytes
// of them) and Stride its threads; the t planes hold the float's bits.
template <int Stride>
struct TierStack {
  static constexpr int kPlane = kTier * Stride;
  int* tier_;  // this thread's column: link at tier_[slot], count and t kPlane on
  DeepArea dev_;
  int lo = 0;  // entries below lo are in device memory only

  __device__ __forceinline__ TierStack(int* tier, DeepArea dev)
      : tier_(tier + threadIdx.x), dev_(dev) {}

  __device__ __forceinline__ static int at(int sp) { return (sp & (kTier - 1)) * Stride; }

  __device__ __forceinline__ void push(int sp, int link, int cnt, float t) {
    if (sp == lo + kTier) {  // the tier's oldest run out
      spill_run<Stride>(tier_, lo, dev_.at + lo * size_t(dev_.level), dev_.level,
                        size_t(dev_.level) * dev_.entries);
      lo += kRun;
    }
    int* e = tier_ + at(sp);
    e[0] = link;
    e[kPlane] = cnt;
    e[2 * kPlane] = __float_as_int(t);
  }
  // The walk reads an entry's t first, once sp is down to it: a pop that
  // empties the tier takes the run below back here.
  __device__ __forceinline__ float t(int sp) {
    if (sp < lo) {
      lo -= kRun;
      fill_run<Stride>(tier_, lo, dev_.at + lo * size_t(dev_.level), dev_.level,
                       size_t(dev_.level) * dev_.entries);
    }
    return __int_as_float(tier_[at(sp) + 2 * kPlane]);
  }
  __device__ __forceinline__ int link(int sp) const { return tier_[at(sp)]; }
  __device__ __forceinline__ int cnt(int sp) const { return tier_[at(sp) + kPlane]; }
};

}  // namespace
