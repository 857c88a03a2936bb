// The pick of a light sample's emitter row, which the wavefront's vertex
// kernels (wavefront.cu, wavefront_bwd.cu) share.

#pragma once

namespace {

// lights.py pick of one (sample, lane) from its draws u0, u1: the mesh by
// area (the count of lcum's entries below u0 · total area, a binary search,
// as searchsorted), then the mesh's first emitter row whose intra-mesh
// cumulative area exceeds sqrt(u1)·mesh_area, else its last row (a binary
// search over the mesh's rows, which scene.py light_mesh_rows lays out
// contiguous with a nondecreasing intra). A is the kernel's arguments
// (lcum and the per-mesh area, first row and row count, intra, and their
// counts); mesh_area gets the picked mesh's area.
template <class Args>
__device__ __forceinline__ int light_pick(const Args& A, float u0, float u1, float& mesh_area) {
  const float target = u0 * A.total_area;
  int lo = 0, hi = A.n_lcum;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(A.lcum + mid) < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int mesh = min(max(lo, 0), A.n_lcum - 1);
  mesh_area = __ldg(A.mesh_area + mesh);
  const float p_tgt = sqrtf(u1) * mesh_area;
  const int end = __ldg(A.mesh_first + mesh) + __ldg(A.mesh_count + mesh);
  lo = __ldg(A.mesh_first + mesh);
  hi = end;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p_tgt < __ldg(A.intra + mid)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return min(max(lo < end ? lo : end - 1, 0), A.n_emt - 1);
}

}  // namespace
