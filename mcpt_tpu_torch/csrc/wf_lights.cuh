// Device code that the wavefront's forward kernels (wavefront.cu) and their
// backward kernels (wavefront_bwd.cu) share: the gather of a table row and
// the pick of a light sample's emitter row.

#pragma once

namespace {

// Row `idx` of a (rows, cols) table, or zeros outside it (intersect._gather).
__device__ __forceinline__ void row_or_zero(const float* table, int idx, int rows, int cols,
                                            float* out) {
  const bool ok = idx >= 0 && idx < rows;
  for (int c = 0; c < cols; ++c) out[c] = ok ? table[idx * cols + c] : 0.0f;
}

// lights.py pick of one (sample, lane) from its draws lu: the mesh by area
// (searchsorted on lmesh_cum), then the mesh's first emitter row whose
// intra-mesh cumulative area exceeds sqrt(u1)·mesh_area, else its last row.
// A is the kernel's arguments (lcum, emt_mesh, mesh_area, intra and their
// counts); mesh_area gets the picked mesh's area.
template <class Args>
__device__ __forceinline__ int light_pick(const Args& A, const float* lu, float& mesh_area) {
  const float target = lu[0] * A.total_area;
  int mesh = 0;
  for (int j = 0; j < A.n_lcum; ++j) mesh += A.lcum[j] < target ? 1 : 0;
  mesh = min(max(mesh, 0), A.n_lcum - 1);
  mesh_area = 0.0f;
  for (int e = 0; e < A.n_emt; ++e) {
    const float a = A.emt_mesh[e] == mesh ? A.mesh_area[e] : 0.0f;
    mesh_area = e == 0 ? a : fmaxf(mesh_area, a);
  }
  const float p_tgt = sqrtf(lu[1]) * mesh_area;
  int sel = A.n_emt, last = -1;
  for (int e = 0; e < A.n_emt; ++e) {
    if (A.emt_mesh[e] != mesh) continue;
    last = e;
    if (sel == A.n_emt && p_tgt < A.intra[e]) sel = e;
  }
  sel = sel >= A.n_emt ? last : sel;
  return min(max(sel, 0), A.n_emt - 1);
}

}  // namespace
