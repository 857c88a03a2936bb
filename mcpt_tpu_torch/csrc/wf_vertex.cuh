// The wavefront vertex's pieces, which the forward kernel shade_pre
// (wavefront.cu) and its reverse shade_pre_bwd (wavefront_bwd.cu) share: the
// arguments both read, the bounce's keys, the surface at the hit, the env
// leaf, the light sample, and beside each piece of the vertex's arithmetic
// its reverse (`*_bwd`). The forward pieces that mega_common.cuh has (the
// material gather, sample_mfn, fresnel, reflect, refract, eval_bsdf, pdf,
// env_lookup) are called from there.
//
// A reverse takes its function's primal inputs and its output adjoints,
// recomputes its own internals from those inputs, and returns the input
// adjoints, by autograd's rules: clamp passes its closed interval, maximum
// halves a tie, abs multiplies by the sign (0 at 0), a sqrt takes its
// derivative in float64 rounded once (the plain version's sqrt is float64
// rounded to float32), a select sends the adjoint to its side and a zero
// to the other. Each is the same float32 operations in the same order as
// its plain version in kernels/vertex_ref.py, so the two agree bit for bit
// on the card (-fmad=false, no fast math), the signs of zeros included: a
// block that a lane does not take (a lobe of the BSDF, a branch of the
// reverse, Fresnel on a conductor) is skipped here and its outputs are
// +0, which the plain version, computing it for every lane, masks them to.

#pragma once

#include "wf_lights.cuh"
#include "wf_random.cuh"

namespace {

constexpr int kShadeCols = 11, kSphShadeCols = 5, kEmtCols = 17;

// The arguments of shade_pre and shade_pre_bwd: the lanes' ray, hit, flags,
// wavelength, channel and the path key; the tables; the counts and scalars.
struct VtxArgs {
  const float *o[3], *d[3], *t, *u, *v, *lam;
  const int* prim;
  const bool* alive;
  const long long *chan, *key;
  const float *tri_shade, *sph_shade, *emt, *intra, *lcum, *mesh_area;
  const int *mesh_first, *mesh_count;
  Tables T;  // the material table and the env map
  int b, depth, n_tris, n_ts, n_sph, n_emt, n_lcum, s, n_sph_emitters, use_env;
  float total_area, rr_rate, inv_rr, bg[3];
};

// The first 24 entries of `in` (see kernels/wavefront.py), the first 13 int
// and 6 float parameters; false when they are refused.
inline bool unpack_vtx(const void* const* in, const int* ip, const float* fp, VtxArgs& A) {
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
  A.T = Tables{};
  A.T.mat = static_cast<const float*>(in[16]);
  A.emt = static_cast<const float*>(in[17]);
  A.intra = static_cast<const float*>(in[18]);
  A.lcum = static_cast<const float*>(in[19]);
  A.mesh_area = static_cast<const float*>(in[20]);
  A.mesh_first = static_cast<const int*>(in[21]);
  A.mesh_count = static_cast<const int*>(in[22]);
  A.T.env = static_cast<const float*>(in[23]);
  A.b = ip[0];
  A.depth = ip[1];
  A.n_tris = ip[2];
  A.n_ts = ip[3];
  A.n_sph = ip[4];
  A.T.n_mat = ip[5];
  A.n_emt = ip[6];
  A.n_lcum = ip[7];
  A.s = ip[8];
  A.n_sph_emitters = ip[9];
  A.use_env = ip[10];
  A.T.env_h = ip[11];
  A.T.env_w = ip[12];
  A.total_area = fp[0];
  A.rr_rate = fp[1];
  A.inv_rr = fp[2];
  for (int k = 0; k < 3; ++k) A.bg[k] = fp[3 + k];
  return A.b >= 0 && A.depth >= 0 && A.s >= 0 && A.T.n_mat >= 1 &&
         (A.s == 0 || (A.n_emt >= 1 && A.n_lcum >= 1)) && A.T.env_h >= 1 && A.T.env_w >= 1;
}

// The lane of this thread in a launch of any block shape.
__device__ __forceinline__ int lane_index() {
  return blockIdx.x * (blockDim.x * blockDim.y * blockDim.z) + threadIdx.x +
         blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
}

// The bounce's two keys, the same in every lane: kd = fold_in(key, depth),
// then fold_in(kd, 0) for the vertex's draws and fold_in(kd, 1) for the
// light samples'. Each thread derives them (one warp a block deriving them
// into shared memory measured no faster, mega_ab.py on the H100).
struct BounceKeys {
  Key vtx, light;
};
__device__ __forceinline__ BounceKeys bounce_keys(const long long* key, int depth) {
  const Key kd = fold_in(load_key(key), static_cast<uint32_t>(depth));
  return {fold_in(kd, 0u), fold_in(kd, 1u)};
}

// ---- autograd's rules -------------------------------------------------------

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
// a / b, rounded as IEEE division; a zero numerator takes no division (the
// same bits: a zero of the operands' signs, or NaN from 0/0 and 0/NaN),
// which keeps the many masked adjoints off the division's slow path
__device__ __forceinline__ float qdiv(float a, float b) {
  return a == 0.0f && b != 0.0f && !isnan(b)
             ? __int_as_float((__float_as_int(a) ^ __float_as_int(b)) & 0x80000000)
             : a / b;
}
// the float64 sqrt's adjoint at x for the output adjoint g, rounded once (g
// itself, a zero, for g = 0 and x > 0: no float64 division and sqrt then)
__device__ __forceinline__ float dsqrt(float g, float x) {
  return g == 0.0f && x > 0.0f
             ? g
             : static_cast<float>(static_cast<double>(g) / (2.0 * sqrt(static_cast<double>(x))));
}
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ float mask(bool c, float g) { return c ? g : 0.0f; }
__device__ __forceinline__ V3 mask(bool c, V3 g) { return c ? g : mk(0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ float twice(float g, float a) { return 2.0f * (g * a); }
// sqrt of clamp_min(x, 1e-12) backward
__device__ __forceinline__ float ssqrt_bwd(float g, float x) {
  return mask(x >= 1e-12f, dsqrt(g, t_clamp_min(x, 1e-12f)));
}

__device__ __forceinline__ V3 normalize_bwd(V3 a, V3 g) {
  const float dd = dot(a, a);
  const float cl = t_clamp_min(dd, 1e-20f);
  const float inv = 1.0f / sqrtf(cl);
  const float g_inv = dot(g, a);
  const float g_dd = mask(dd >= 1e-20f, dsqrt(-g_inv * (inv * inv), cl));
  return mk(g.x * inv + twice(g_dd, a.x), g.y * inv + twice(g_dd, a.y),
            g.z * inv + twice(g_dd, a.z));
}

__device__ __forceinline__ void reflect_bwd(V3 wo, V3 n, V3 g, V3& g_wo, V3& g_n) {
  const float s = 2.0f * dot(wo, n);
  const float g_dot = dot(g, n) * 2.0f;
  g_wo = mk(-g.x + g_dot * n.x, -g.y + g_dot * n.y, -g.z + g_dot * n.z);
  g_n = mk(g.x * s + g_dot * wo.x, g.y * s + g_dot * wo.y, g.z * s + g_dot * wo.z);
}

__device__ __forceinline__ void schlick_bwd(float c, float f0, float g, float& g_c, float& g_f0) {
  const float inv = 1.0f - c;
  const float c2 = inv * inv;
  const float a = 1.0f - f0;
  const float p1 = a * c2;
  const float p2 = p1 * c2;
  const float g_p2 = g * inv;
  float g_inv = g * p2;
  const float g_p1 = g_p2 * c2;
  float g_c2 = g_p2 * p1;
  const float g_a = g_p1 * c2;
  g_c2 = g_c2 + g_p1 * a;
  g_inv = g_inv + twice(g_c2, inv);
  g_c = -g_inv;
  g_f0 = g - g_a;
}

// ---- the surface at the hit (intersect.py surface_at_c) ---------------------

struct Surf {
  V3 p, n, ss;  // the point, the normal, the sphere row's centre
  float t_eff, uvx, uvy;
  float mat;  // the material id
  bool happened, is_tri, emissive;
};

// Row `idx` of a (rows, cols) table, or zeros outside it (intersect._gather).
template <int C>
__device__ __forceinline__ void row_or_zero(const float* table, int idx, int rows, float* out) {
  const bool ok = idx >= 0 && idx < rows;
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = ok ? __ldg(table + idx * C + c) : 0.0f;
}

__device__ __forceinline__ Surf surface_at(const VtxArgs& A, int i, V3 o, V3 d) {
  Surf S;
  const int prim = A.prim[i];
  S.happened = prim >= 0;
  S.is_tri = S.happened && prim < A.n_tris;
  S.t_eff = S.happened ? A.t[i] : 0.0f;
  S.p = mk(o.x + d.x * S.t_eff, o.y + d.y * S.t_eff, o.z + d.z * S.t_eff);
  float ts[kShadeCols], ss[kSphShadeCols];
  row_or_zero<kShadeCols>(A.tri_shade, S.is_tri ? prim : -1, A.n_ts, ts);
  row_or_zero<kSphShadeCols>(A.sph_shade, S.happened && !S.is_tri ? prim - A.n_tris : -1,
                             A.n_sph, ss);
  const float hu = A.u[i], hv = A.v[i];
  const float w0 = 1.0f - hu - hv;
  S.ss = mk(ss[0], ss[1], ss[2]);
  const V3 ns = sub(S.p, S.ss);
  const float ninv = 1.0f / t_clamp_min(sqrtf(ns.x * ns.x + ns.y * ns.y + ns.z * ns.z), 1e-20f);
  S.n = S.is_tri ? mk(ts[0], ts[1], ts[2]) : mk(ns.x * ninv, ns.y * ninv, ns.z * ninv);
  S.uvx = S.is_tri ? w0 * ts[3] + hu * ts[5] + hv * ts[7] : 0.0f;
  S.uvy = S.is_tri ? w0 * ts[4] + hu * ts[6] + hv * ts[8] : 0.0f;
  S.mat = S.happened ? static_cast<float>(static_cast<long long>(S.is_tri ? ts[9] : ss[3])) : 0.0f;
  S.emissive = S.happened && (S.is_tri ? ts[10] : ss[4]) > 0.5f;
  return S;
}

// (g_o, g_d) from the adjoints of p = o + d·t_eff and of the normal, which
// depends on p only on a sphere (t is detached, the rows constant).
__device__ __forceinline__ void surface_bwd(const Surf& S, V3 o, V3 d, V3 g_p, V3 g_n, V3& g_o,
                                            V3& g_d) {
  const V3 p = mk(o.x + d.x * S.t_eff, o.y + d.y * S.t_eff, o.z + d.z * S.t_eff);
  const V3 ns = sub(p, S.ss);
  const float sq = ns.x * ns.x + ns.y * ns.y + ns.z * ns.z;
  const float ln = sqrtf(sq);
  const float inv = 1.0f / t_clamp_min(ln, 1e-20f);
  V3 gs = mk(0.0f, 0.0f, 0.0f);
  if (!S.is_tri) {  // a sphere's normal (p - c)/|p - c|
    const float g_inv = dot(g_n, ns);
    const float g_sq = mask(ln >= 1e-20f, dsqrt(-g_inv * (inv * inv), sq));
    gs = mk(g_n.x * inv + twice(g_sq, ns.x), g_n.y * inv + twice(g_sq, ns.y),
            g_n.z * inv + twice(g_sq, ns.z));
  }
  g_o = add(g_p, gs);
  g_d = scale(g_o, S.t_eff);
}

// ---- the env leaf (envmap.py sample_env_chan) -------------------------------

// The env map along dir at the lane's channel, or the background's channel.
__device__ __forceinline__ float env_chan(const VtxArgs& A, V3 dir, int chan) {
  return A.use_env ? env_lookup(A.T, dir, chan) : pick3(chan, A.bg[0], A.bg[1], A.bg[2]);
}

// The map's reverse (the background's is zero): the adjoint of d through the
// bilinear weights (the texels and their indices are constant).
__device__ V3 env_bwd(const Tables& T, V3 d, int chan, float g) {
  const int h = T.env_h, w = T.env_w;
  const float n2 = d.x * d.x + d.y * d.y + d.z * d.z;
  const bool ok = n2 > 1e-12f;
  const float n2s = ok ? n2 : 1.0f;
  const float r = 1.0f / sqrtf(n2s);
  const float inv = ok ? r : 0.0f;
  const float x_ = d.x * inv, y_ = d.y * inv, z_ = d.z * inv;
  const float phi = atan2f(z_, x_);
  const float yc = t_clamp(y_, -1.0f, 1.0f);
  const float theta = acosf(yc);
  float u = (phi + kPi) / kTwoPi;
  const float v = theta / kPi;
  u = u - floorf(u);
  const float vc = t_clamp(v, 0.0f, 1.0f);
  const float x = u * static_cast<float>(w) - 0.5f;
  const float y = vc * static_cast<float>(h) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float sx = x - x0, sy = y - y0;
  const int x0i = static_cast<int>(x0), y0i = static_cast<int>(y0);
  const int x0w = ((x0i % w) + w) % w, x1w = (((x0i + 1) % w) + w) % w;
  const int y0c = min(max(y0i, 0), h - 1), y1c = min(max(y0i + 1, 0), h - 1);
  const float c00 = __ldg(T.env + (y0c * w + x0w) * 3 + chan);
  const float c10 = __ldg(T.env + (y0c * w + x1w) * 3 + chan);
  const float c01 = __ldg(T.env + (y1c * w + x0w) * 3 + chan);
  const float c11 = __ldg(T.env + (y1c * w + x1w) * 3 + chan);
  const float c0 = c00 * (1.0f - sx) + c10 * sx;
  const float c1 = c01 * (1.0f - sx) + c11 * sx;
  const float g_c0 = g * (1.0f - sy), g_c1 = g * sy;
  const float g_y = g * c1 - g * c0;
  const float g_x = ((g_c0 * c10 - g_c0 * c00) + g_c1 * c11) - g_c1 * c01;
  const float g_v = mask(v >= 0.0f && v <= 1.0f, g_y * static_cast<float>(h));
  const float g_phi = qdiv(g_x * static_cast<float>(w), kTwoPi);
  const float g_theta = qdiv(g_v, kPi);
  const float g_yc = g_theta * -(1.0f / sqrtf(1.0f - yc * yc));
  const float g_y_ = mask(y_ >= -1.0f && y_ <= 1.0f, g_yc);
  const float rr = 1.0f / (z_ * z_ + x_ * x_);
  const V3 g_u = mk(g_phi * -z_ * rr, g_y_, g_phi * x_ * rr);
  const float g_inv = dot(g_u, d);
  const float g_n2 = mask(ok, dsqrt(-mask(ok, g_inv) * (r * r), n2s));
  return mk(g_u.x * inv + twice(g_n2, d.x), g_u.y * inv + twice(g_n2, d.y),
            g_u.z * inv + twice(g_n2, d.z));
}

// ---- the light sample (lights.py sample_light_c) ----------------------------

struct Light {
  V3 p, n;
  float emit, pdf;
  int sel;  // the emitter row
};

// One (sample, lane)'s light from its draws lu: the two-stage pick
// (wf_lights.cuh light_pick), then the point, its normal, the emission at
// `chan` and the pdf.
__device__ __forceinline__ Light light_sample(const VtxArgs& A, float lu0, float lu1, float lu2,
                                              float lu3, int chan) {
  Light L;
  float mesh_area;
  L.sel = light_pick(A, lu0, lu1, mesh_area);
  const float* row = A.emt + L.sel * kEmtCols;
  const float x = sqrtf(lu2), y = lu3;
  const float wx = x * (1.0f - y), wy = x * y;
  L.p = mk(row[0] + row[3] * wx + row[6] * wy, row[1] + row[4] * wx + row[7] * wy,
           row[2] + row[5] * wx + row[8] * wy);
  L.n = mk(row[9], row[10], row[11]);
  if (A.n_sph_emitters && row[16] > 0.5f) {  // a uniform point on an emissive sphere
    const float ys = 1.0f - 2.0f * lu2;
    const float sq = sqrtf(t_clamp_min(1.0f - ys * ys, 0.0f));
    const float ph = kTwoPi * lu3;
    const V3 dv = mk(sq * cosf(ph), ys, sq * sinf(ph));
    L.p = mk(row[0] + row[3] * dv.x, row[1] + row[3] * dv.y, row[2] + row[3] * dv.z);
    L.n = dv;
  }
  L.emit = pick3(chan, row[12], row[13], row[14]);
  L.pdf = 1.0f / t_clamp_min(mesh_area, 1e-20f);
  return L;
}

// The emitter row's adjoint (17 columns into `g`) from the adjoints of the
// light's point, normal and emission.
__device__ __forceinline__ void light_point_bwd(const VtxArgs& A, const float* row, float lu2,
                                                float lu3, int chan, V3 g_p, V3 g_n, float g_emit,
                                                float* g) {
  const float x = sqrtf(lu2);
  const float wx = x * (1.0f - lu3), wy = x * lu3;
  V3 g_ps = mk(0.0f, 0.0f, 0.0f), dv = g_ps;
  if (A.n_sph_emitters) {
    const bool is_se = row[16] > 0.5f;
    const float ys = 1.0f - 2.0f * lu2;
    const float sq = sqrtf(t_clamp_min(1.0f - ys * ys, 0.0f));
    const float ph = kTwoPi * lu3;
    dv = mk(sq * cosf(ph), ys, sq * sinf(ph));
    g_ps = mask(is_se, g_p);
    g_p = is_se ? mk(0.0f, 0.0f, 0.0f) : g_p;
    g_n = is_se ? mk(0.0f, 0.0f, 0.0f) : g_n;
  }
  g[0] = g_p.x;
  g[1] = g_p.y;
  g[2] = g_p.z;
  g[3] = g_p.x * wx;
  g[4] = g_p.y * wx;
  g[5] = g_p.z * wx;
  g[6] = g_p.x * wy;
  g[7] = g_p.y * wy;
  g[8] = g_p.z * wy;
  g[9] = g_n.x;
  g[10] = g_n.y;
  g[11] = g_n.z;
  g[12] = mask(chan == 0, g_emit);
  g[13] = mask(chan == 1, g_emit);
  g[14] = mask(chan == 2, g_emit);
  g[15] = 0.0f;
  g[16] = 0.0f;
  if (A.n_sph_emitters) {
    g[0] = g[0] + g_ps.x;
    g[1] = g[1] + g_ps.y;
    g[2] = g[2] + g_ps.z;
    g[3] = g[3] + dot(g_ps, dv);
  }
}

// ---- the microfacet normal, Fresnel, refraction -----------------------------

__device__ V3 tangent_frame_bwd(V3 n, V3 g_t, V3 g_b) {
  const bool ax = fabsf(n.x) > fabsf(n.y);
  const float sx = n.x * n.x + n.z * n.z, sy = n.y * n.y + n.z * n.z;
  const float clx = t_clamp_min(sx, 1e-30f), cly = t_clamp_min(sy, 1e-30f);
  const float lx = sqrtf(clx), ly = sqrtf(cly);
  const V3 t = ax ? mk(qdiv(-n.z, lx), 0.0f, qdiv(n.x, lx))
                 : mk(0.0f, qdiv(n.z, ly), qdiv(-n.y, ly));
  const V3 g_n = cross(t, g_b);
  const V3 gt = add(g_t, cross(g_b, n));
  const V3 ga = mask(ax, gt);
  const V3 gb = ax ? mk(0.0f, 0.0f, 0.0f) : gt;
  const float g_lx = -ga.x * qdiv(t.x, lx) - ga.z * qdiv(t.z, lx);
  const float g_ly = -gb.y * qdiv(t.y, ly) - gb.z * qdiv(t.z, ly);
  const float g_sx = mask(sx >= 1e-30f, dsqrt(g_lx, clx));
  const float g_sy = mask(sy >= 1e-30f, dsqrt(g_ly, cly));
  return mk(g_n.x + (qdiv(ga.z, lx) + twice(g_sx, n.x)),
            g_n.y + (-qdiv(gb.z, ly) + twice(g_sy, n.y)),
            g_n.z + ((-qdiv(ga.x, lx) + twice(g_sx, n.z)) + (qdiv(gb.y, ly) + twice(g_sy, n.z))));
}

// sample_mfn backward: (g_n, g_alpha) from the microfacet normal's adjoint
// (n itself on a smooth lane, which skips the rest).
__device__ void sample_mfn_bwd(float mtype, float alpha, V3 n, float xi1, float xi2, V3 g, V3& g_n,
                               float& g_alpha) {
  const bool rough = is_rough(mtype);
  V3 c = mk(0.0f, 0.0f, 0.0f);
  g_alpha = 0.0f;
  if (rough) {
    const float phi = kTwoPi * xi1;
    const float a2 = alpha * alpha;
    const float den0 = 1.0f + (a2 - 1.0f) * xi2;
    const float den = t_clamp_min(den0, 1e-20f);
    const float ratio = qdiv(t_clamp_min(1.0f - xi2, 0.0f), den);
    const float cos_t = sqrtf(t_clamp_min(ratio, 1e-12f));
    const float q = 1.0f - cos_t * cos_t;
    const float sin_t = sqrtf(t_clamp_min(q, 1e-12f));
    const float cph = cosf(phi), sph = sinf(phi);
    const float hx = sin_t * cph, hy = sin_t * sph;
    const bool ax = fabsf(n.x) > fabsf(n.y);
    const float lx = sqrtf(t_clamp_min(n.x * n.x + n.z * n.z, 1e-30f));
    const float ly = sqrtf(t_clamp_min(n.y * n.y + n.z * n.z, 1e-30f));
    const V3 t = ax ? mk(qdiv(-n.z, lx), 0.0f, qdiv(n.x, lx))
                   : mk(0.0f, qdiv(n.z, ly), qdiv(-n.y, ly));
    const V3 b = cross(n, t);
    const V3 hu = add(add(scale(t, hx), scale(b, hy)), scale(n, cos_t));
    const V3 g_hu = normalize_bwd(hu, g);
    const float g_sin = dot(g_hu, t) * cph + dot(g_hu, b) * sph;
    const float g_cos = dot(g_hu, n) - twice(ssqrt_bwd(g_sin, q), cos_t);
    const float g_ratio = ssqrt_bwd(g_cos, ratio);
    const float g_den0 = mask(den0 >= 1e-20f, -g_ratio * qdiv(ratio, den));
    g_alpha = twice(g_den0 * xi2, alpha);
    const V3 g_tn = tangent_frame_bwd(n, scale(g_hu, hx), scale(g_hu, hy));
    c = mk(g_hu.x * cos_t + g_tn.x, g_hu.y * cos_t + g_tn.y, g_hu.z * cos_t + g_tn.z);
  }
  const V3 gs = rough ? mk(0.0f, 0.0f, 0.0f) : g;
  g_n = add(gs, c);
}

// fresnel backward: (g_ior, g_inc, g_nrm); a block that a conductor or total
// internal reflection (kr is 1 there) skips.
__device__ void fresnel_bwd(float mtype, float ior, V3 inc, V3 nrm, float g, float& g_ior,
                            V3& g_inc, V3& g_nrm) {
  const float dt = dot(inc, nrm);
  const float cosi = t_clamp(dt, -1.0f, 1.0f);
  const bool outside = cosi <= 0.0f;
  const float etai = outside ? 1.0f : ior, etat = outside ? ior : 1.0f;
  const float q = 1.0f - cosi * cosi;
  const float sq = sqrtf(t_clamp_min(q, 1e-12f));
  const float ratio = etai / etat;
  const float sint = ratio * sq;
  const bool tir = sint >= 1.0f;
  const float sint_s = tir ? 0.0f : sint;
  const float q2 = 1.0f - sint_s * sint_s;
  g_ior = 0.0f;
  g_inc = g_nrm = mk(0.0f, 0.0f, 0.0f);
  if (is_conductor(mtype) || tir) return;
  const float cost = sqrtf(t_clamp_min(q2, 1e-12f));
  const float aci = fabsf(cosi);
  const float rsd0 = etat * aci + etai * cost, rpd0 = etai * aci + etat * cost;
  const float rs_den = t_clamp_min(rsd0, 1e-6f), rp_den = t_clamp_min(rpd0, 1e-6f);
  const float rs = qdiv(etat * aci - etai * cost, rs_den);
  const float rp = qdiv(etai * aci - etat * cost, rp_den);
  const float gs = g * 0.5f;
  const float g_rs = twice(gs, rs), g_rp = twice(gs, rp);
  const float g_rsn = qdiv(g_rs, rs_den), g_rpn = qdiv(g_rp, rp_den);
  const float g_rsd = mask(rsd0 >= 1e-6f, -g_rs * qdiv(rs, rs_den));
  const float g_rpd = mask(rpd0 >= 1e-6f, -g_rp * qdiv(rp, rp_den));
  float g_etat = ((g_rsd * aci + g_rpd * cost) + g_rsn * aci) - g_rpn * cost;
  float g_etai = ((g_rsd * cost + g_rpd * aci) - g_rsn * cost) + g_rpn * aci;
  const float g_aci = ((g_rsd * etat + g_rpd * etai) + g_rsn * etat) + g_rpn * etai;
  const float g_cost = ((g_rsd * etai + g_rpd * etat) - g_rsn * etai) - g_rpn * etat;
  const float g_sint = tir ? 0.0f : -twice(ssqrt_bwd(g_cost, q2), sint_s);
  const float g_ratio = g_sint * sq;
  const float g_cosi = g_aci * sgn(cosi) - twice(ssqrt_bwd(g_sint * ratio, q), cosi);
  g_etai = g_etai + qdiv(g_ratio, etat);
  g_etat = g_etat - g_ratio * qdiv(ratio, etat);
  g_ior = outside ? g_etat : g_etai;
  const float g_dt = mask(dt >= -1.0f && dt <= 1.0f, g_cosi);
  g_inc = scale(nrm, g_dt);
  g_nrm = scale(inc, g_dt);
}

// refract backward: (g_ior, g_inc, g_nrm); a block that total internal
// reflection (the zero vector) skips.
__device__ void refract_bwd(float ior, V3 inc, V3 nrm, V3 g, float& g_ior, V3& g_inc, V3& g_nrm) {
  const float dt = dot(inc, nrm);
  const float cosi = t_clamp(dt, -1.0f, 1.0f);
  const bool entering = cosi < 0.0f;
  const float etai = entering ? 1.0f : ior, etat = entering ? ior : 1.0f;
  const V3 n = entering ? nrm : neg(nrm);
  const float ci = fabsf(cosi);
  const float eta = etai / etat;
  const float b = 1.0f - ci * ci;
  const float e2 = eta * eta;
  const float k = 1.0f - e2 * b;
  const bool ok = k >= 0.0f;
  const float ks = ok ? k : 1.0f;
  g_ior = 0.0f;
  g_inc = g_nrm = mk(0.0f, 0.0f, 0.0f);
  if (!ok) return;
  const float coef = eta * ci - sqrtf(t_clamp_min(ks, 1e-12f));
  const float g_coef = dot(g, n);
  const float g_k = ssqrt_bwd(-g_coef, ks);
  const float g_eta = (dot(g, inc) + g_coef * ci) + twice(-g_k * b, eta);
  const float g_ci = g_coef * eta + twice(-(-g_k * e2), ci);
  const float g_dt = mask(dt >= -1.0f && dt <= 1.0f, g_ci * sgn(cosi));
  g_ior = entering ? -g_eta * qdiv(eta, etat) : qdiv(g_eta, etat);
  g_inc = mk(g.x * eta + g_dt * nrm.x, g.y * eta + g_dt * nrm.y, g.z * eta + g_dt * nrm.z);
  const V3 gc = scale(g, coef);
  g_nrm = mk((entering ? gc.x : -gc.x) + g_dt * inc.x, (entering ? gc.y : -gc.y) + g_dt * inc.y,
             (entering ? gc.z : -gc.z) + g_dt * inc.z);
}

// ---- the microfacet terms, the BSDF and its pdf -----------------------------

__device__ void d_ggx_bwd(V3 h, V3 n, float alpha, float g, V3& g_h, V3& g_n, float& g_alpha) {
  const float dh = dot(n, h);
  const float noh = fabsf(dh);
  const bool good = noh > kEps;
  const float ns = good ? noh : 1.0f;
  const float n2 = ns * ns;
  const float tan2 = qdiv(1.0f - n2, n2);
  const float at = alpha + tan2;
  const float den0 = n2 * at;
  const bool nz = fabsf(den0) > 0.0f;
  const float den = nz ? den0 : 1.0f;
  const float pd = kPi * den;
  const float pdd = pd * den;
  const float d = qdiv(alpha * alpha, pdd);
  const float gd = mask(good, g);
  const float g_aa = qdiv(gd, pdd);
  const float g_pdd = -gd * qdiv(d, pdd);
  const float g_den0 = mask(nz, g_pdd * pd + (g_pdd * den) * kPi);
  const float g_at = g_den0 * n2;
  const float g_n2 = g_den0 * at - qdiv(g_at, n2) - g_at * qdiv(tan2, n2);
  const float g_dh = mask(good, twice(g_n2, ns)) * sgn(dh);
  g_h = scale(n, g_dh);
  g_n = scale(h, g_dh);
  g_alpha = g_at + twice(g_aa, alpha);
}

__device__ void g1_bwd(V3 v, V3 n, float alpha, float g, V3& g_v, V3& g_n, float& g_alpha) {
  const float dv = dot(n, v);
  const float nov = fabsf(dv);
  const bool good = nov > kEps;
  const float ns = good ? nov : 1.0f;
  const float q = 1.0f - ns * ns;
  const float sq = sqrtf(t_clamp_min(q, 1e-12f));
  const float tan_t = qdiv(sq, ns);
  const float at = alpha * tan_t;
  const float r = 1.0f + at * at;
  const float rc = 1.0f / (1.0f + sqrtf(r));
  const float g_den = -(mask(good && tan_t != 0.0f, g) * 2.0f) * (rc * rc);
  const float g_at = twice(dsqrt(g_den, r), at);
  const float g_tan = g_at * alpha;
  const float g_ns = -g_tan * qdiv(tan_t, ns) - twice(ssqrt_bwd(qdiv(g_tan, ns), q), ns);
  const float g_dv = mask(good, g_ns) * sgn(dv);
  g_v = scale(n, g_dv);
  g_n = scale(v, g_dv);
  g_alpha = g_at * tan_t;
}

struct BsdfAdj {
  float ior, alpha, refl;
  V3 wi, wo, n;
  float f;  // eval_bsdf_bwd: the BSDF's value, bitwise eval_bsdf's
};

// eval_bsdf backward, with the BSDF's value (bitwise eval_bsdf's, which the
// light samples read from here). A smooth lane takes the smooth block
// (Fresnel at n, or Schlick's for a conductor), a rough one the rough
// block: its lobe (reflection or refraction), then D, G and F at the half
// vector h and h's own reverse.
__device__ BsdfAdj eval_bsdf_bwd(float mtype, float ior, float alpha, float refl, V3 wi, V3 wo,
                                 V3 n, bool is_reflect, float g) {
  const float win = dot(wi, n), won = dot(wo, n);
  const float ww = win * won;
  const bool same = ww > 0.0f, up = win > 0.0f;
  const float rc = 1.0f / ior;
  const float eta = up ? ior : rc;
  const V3 nwi = neg(wi);
  const bool cond = is_conductor(mtype);
  const V3 hv = sub(nwi, scale(wo, eta));
  const V3 hs = add(wi, wo);
  const V3 h_s = scale(hs, 1.0f / sqrtf(t_clamp_min(dot(hs, hs), 1e-20f)));
  const V3 h_t0 = scale(hv, 1.0f / sqrtf(t_clamp_min(dot(hv, hv), 1e-20f)));
  const bool flip = dot(h_t0, n) > 0.0f;
  const V3 h = is_reflect ? (up ? h_s : neg(h_s)) : (flip ? h_t0 : neg(h_t0));
  const float awon = fabsf(won);
  Mat m{};
  m.mtype = mtype;
  BsdfAdj o;
  if (!is_rough(mtype)) {  // the smooth block
    const bool aligned = dot(h, n) >= kOneMinusEps;
    const float f_sm = fresnel(m, ior, nwi, n);
    o.f = is_reflect ? (same && aligned ? (cond ? fresnel_schlick(awon, refl) : f_sm) : 0.0f)
                     : (!cond && !same && ww != 0.0f && aligned ? 1.0f - f_sm : 0.0f);
    const float g_sr = mask(is_reflect && same && aligned, g);
    const float g_st = mask(!is_reflect && !cond && !same && ww != 0.0f && aligned, g);
    float g_awon_s;
    schlick_bwd(awon, refl, mask(cond, g_sr), g_awon_s, o.refl);
    V3 g_nwi_s, g_n_s;
    fresnel_bwd(mtype, ior, nwi, n, (cond ? 0.0f : g_sr) - g_st, o.ior, g_nwi_s, g_n_s);
    const float g_won_s = g_awon_s * sgn(won);
    o.alpha = 0.0f;
    o.wi = neg(g_nwi_s);
    o.wo = scale(n, g_won_s);
    o.n = mk(g_n_s.x + g_won_s * wo.x, g_n_s.y + g_won_s * wo.y, g_n_s.z + g_won_s * wo.z);
    return o;
  }
  // the rough block: its lobe
  const float d_h = d_ggx(h, n, alpha);
  const float ga = g1(wi, h, alpha), gb = g1(wo, h, alpha);
  const float g_h = ga * gb;
  const float f_h = fresnel(m, ior, nwi, h);
  const float hwo = dot(h, wo);
  float g_gh, g_dh, g_fh, g_awon = 0.0f, g_awin = 0.0f, g_hwo = 0.0f, g_refl = 0.0f;
  float g_hol = 0.0f, g_hov = 0.0f, g_eta = 0.0f, g_ww = 0.0f;
  if (is_reflect) {  // f_r·D·G/(4|wi·n||wo·n| + ε) on the same side
    const float ahwo = fabsf(hwo);
    const float f_r = cond ? fresnel_schlick(ahwo, refl) : f_h;
    const float awin = fabsf(win);
    const float a4 = 4.0f * awin;
    const float denom_r = a4 * awon + kEps;
    const float rr1 = f_r * d_h;
    const float rr3 = qdiv(rr1 * g_h, denom_r);
    o.f = same ? rr3 : 0.0f;
    const float g_rr3 = mask(same, g);
    const float g_rr2 = qdiv(g_rr3, denom_r);
    const float g_denr = -g_rr3 * qdiv(rr3, denom_r);
    const float g_rr1 = g_rr2 * g_h;
    const float g_fr = g_rr1 * d_h;
    float g_ahwo;
    schlick_bwd(ahwo, refl, mask(cond, g_fr), g_ahwo, g_refl);
    g_gh = g_rr2 * rr1;
    g_dh = g_rr1 * f_r;
    g_fh = cond ? 0.0f : g_fr;
    g_awon = g_denr * a4;
    g_awin = (g_denr * awon) * 4.0f;
    g_hwo = g_ahwo * sgn(hwo);
  } else {  // (1 − F)·D·G·eta²|h·wi h·wo| / ((h·wi + eta h·wo)² |wi·n wo·n|)
    const float hol = dot(h, wi), hov = hwo;
    const float den_a = hol + eta * hov;
    const float den_b = den_a * den_a;
    const float aww = fabsf(ww);
    const float den_c = den_b * aww;
    const float den = t_clamp_min(den_c, 1e-10f);
    const float omf = 1.0f - f_h;
    const float t1 = omf * d_h, t2 = t1 * g_h, t3 = t2 * eta, t4 = t3 * eta;
    const float hh = hol * hov, ahh = fabsf(hh);
    const float t6 = qdiv(t4 * ahh, den);
    o.f = cond || same || ww == 0.0f ? 0.0f : t6;
    const float g_t6 = mask(!(cond || same || ww == 0.0f), g);
    const float g_t5 = qdiv(g_t6, den);
    const float g_den_c = mask(den_c >= 1e-10f, -g_t6 * qdiv(t6, den));
    const float g_t4 = g_t5 * ahh;
    const float g_hh = (g_t5 * t4) * sgn(hh);
    const float g_t3 = g_t4 * eta;
    const float g_t2 = g_t3 * eta;
    const float g_t1 = g_t2 * g_h;
    const float g_den_a = twice(g_den_c * aww, den_a);
    g_gh = g_t2 * t1;
    g_dh = g_t1 * omf;
    g_fh = -(g_t1 * d_h);
    g_hol = g_hh * hov + g_den_a;
    g_hov = g_hh * hol + g_den_a * eta;
    g_eta = (g_t4 * t3 + g_t3 * t2) + g_den_a * hov;
    g_ww = (g_den_c * den_b) * sgn(ww);
  }
  // F, G and D at h
  float gi;
  V3 g_nwi, g_hvec, g_wi, g_hx, g_wo, g_hy, g_hz, g_nd;
  float g_al, g_al2, g_al3;
  fresnel_bwd(mtype, ior, nwi, h, g_fh, gi, g_nwi, g_hvec);
  g1_bwd(wi, h, alpha, g_gh * gb, g_wi, g_hx, g_al);
  g1_bwd(wo, h, alpha, g_gh * ga, g_wo, g_hy, g_al2);
  d_ggx_bwd(h, n, alpha, g_dh, g_hz, g_nd, g_al3);
  g_hvec = add(add(add(g_hvec, g_hx), g_hy), g_hz);
  g_hvec = mk(g_hvec.x + ((g_hol * wi.x + g_hov * wo.x) + g_hwo * wo.x),
              g_hvec.y + ((g_hol * wi.y + g_hov * wo.y) + g_hwo * wo.y),
              g_hvec.z + ((g_hol * wi.z + g_hov * wo.z) + g_hwo * wo.z));
  // h: ±normalize(wi + wo) for reflection, ±normalize(-wi - eta·wo) else
  V3 g_hs = mk(0.0f, 0.0f, 0.0f), g_hv = g_hs;
  if (is_reflect) {
    g_hs = normalize_bwd(hs, up ? g_hvec : neg(g_hvec));
  } else {
    g_hv = normalize_bwd(hv, flip ? g_hvec : neg(g_hvec));
  }
  g_nwi = add(g_nwi, g_hv);
  g_eta = g_eta - dot(g_hv, wo);
  const float g_win = g_ww * won + g_awin * sgn(win);
  const float g_won = g_ww * win + g_awon * sgn(won);
  o.ior = gi + (up ? g_eta : -(up ? 0.0f : g_eta) * (rc * rc));
  o.alpha = (g_al + g_al2) + g_al3;
  o.refl = g_refl;
  o.wi = mk(((g_wi.x + g_hol * h.x + g_hs.x) - g_nwi.x) + g_win * n.x,
            ((g_wi.y + g_hol * h.y + g_hs.y) - g_nwi.y) + g_win * n.y,
            ((g_wi.z + g_hol * h.z + g_hs.z) - g_nwi.z) + g_win * n.z);
  o.wo = mk(((g_wo.x + (g_hov * h.x + g_hwo * h.x) + g_hs.x) - g_hv.x * eta) + g_won * n.x,
            ((g_wo.y + (g_hov * h.y + g_hwo * h.y) + g_hs.y) - g_hv.y * eta) + g_won * n.y,
            ((g_wo.z + (g_hov * h.z + g_hwo * h.z) + g_hs.z) - g_hv.z * eta) + g_won * n.z);
  o.n = mk(g_nd.x + (g_win * wi.x + g_won * wo.x), g_nd.y + (g_win * wi.y + g_won * wo.y),
           g_nd.z + (g_win * wi.z + g_won * wo.z));
  return o;
}

// pdf backward (refl stays 0). A smooth lane's pdf is a constant; a rough
// one's D(h)·(n·h)·jacobian runs back through D and its lobe's jacobian
// and half vector.
__device__ BsdfAdj pdf_bwd(float mtype, float ior, float alpha, V3 wi, V3 wo, V3 n, bool is_reflect,
                           float g) {
  BsdfAdj o;
  o.ior = o.alpha = o.refl = o.f = 0.0f;
  o.wi = o.wo = o.n = mk(0.0f, 0.0f, 0.0f);
  if (!is_rough(mtype)) return o;
  const bool up = dot(wi, n) > 0.0f;
  const float rc = 1.0f / ior;
  const float eta = up ? ior : rc;
  const V3 hs = add(wi, wo);
  const V3 h_s = scale(hs, 1.0f / sqrtf(t_clamp_min(dot(hs, hs), 1e-20f)));
  const V3 h_r = up ? h_s : neg(h_s);
  const float hrwo = dot(h_r, wo);
  const float jr0 = 4.0f * fabsf(hrwo);
  const float jac_r = 1.0f / t_clamp_min(jr0, 1e-8f);
  const V3 hv = sub(neg(wi), scale(wo, eta));
  const float dd = dot(hv, hv);
  const V3 h_t = scale(hv, 1.0f / sqrtf(t_clamp_min(dd, 1e-20f)));
  const float d1 = t_clamp_min(dd, 1e-12f);
  const float htwo = dot(h_t, wo);
  const float jt1 = eta * eta;
  const float jac_t = qdiv(jt1 * fabsf(htwo), d1);
  const V3 h = is_reflect ? h_r : h_t;
  const float jac = is_reflect ? jac_r : jac_t;
  const float d = d_ggx(h, n, alpha);
  const float nh = dot(n, h);
  const float g_p1 = g * jac;
  const float g_jac = g * (d * nh);
  const float g_nh = g_p1 * d;
  V3 g_h, g_n;
  d_ggx_bwd(h, n, alpha, g_p1 * nh, g_h, g_n, o.alpha);
  g_h = mk(g_h.x + g_nh * n.x, g_h.y + g_nh * n.y, g_h.z + g_nh * n.z);
  o.n = mk(g_n.x + g_nh * h.x, g_n.y + g_nh * h.y, g_n.z + g_nh * h.z);
  if (is_reflect) {  // the jacobian 1/(4|h·wo|), h = ±normalize(wi + wo)
    const float g_jr0 = mask(jr0 >= 1e-8f, -g_jac * (jac_r * jac_r));
    const float g_hrwo = (g_jr0 * 4.0f) * sgn(hrwo);
    const V3 g_hr = mk(g_h.x + g_hrwo * wo.x, g_h.y + g_hrwo * wo.y, g_h.z + g_hrwo * wo.z);
    const V3 g_hs = normalize_bwd(hs, up ? g_hr : neg(g_hr));
    o.wi = g_hs;
    o.wo = mk(g_hs.x + g_hrwo * h_r.x, g_hs.y + g_hrwo * h_r.y, g_hs.z + g_hrwo * h_r.z);
    return o;
  }
  // the jacobian eta²|h·wo|/|hv|², h = normalize(hv)
  const float g_jt2 = qdiv(g_jac, d1);
  const float g_d1 = -g_jac * qdiv(jac_t, d1);
  const float g_htwo = (g_jt2 * jt1) * sgn(htwo);
  V3 g_hv = normalize_bwd(
      hv, mk(g_h.x + g_htwo * wo.x, g_h.y + g_htwo * wo.y, g_h.z + g_htwo * wo.z));
  const float g_dd = mask(dd >= 1e-12f, g_d1);
  g_hv = mk(g_hv.x + twice(g_dd, hv.x), g_hv.y + twice(g_dd, hv.y), g_hv.z + twice(g_dd, hv.z));
  const float g_eta = twice(g_jt2 * fabsf(htwo), eta) - dot(g_hv, wo);
  o.ior = up ? g_eta : -(up ? 0.0f : g_eta) * (rc * rc);
  o.wi = neg(g_hv);
  o.wo = mk(g_htwo * h_t.x - g_hv.x * eta, g_htwo * h_t.y - g_hv.y * eta,
            g_htwo * h_t.z - g_hv.z * eta);
  return o;
}

// ---- the vertex (integrator.py _bounce up to the ray queries) --------------

// What a lane's vertex computes, and the values its reverse reads.
struct Vtx {
  Surf S;
  Mat m;
  V3 o, d, wo, mfn, p_dl, p_new, wi;
  int chan, row;  // row: the material id clamped into the table
  bool ok;        // the id names a row
  float lam, ior, refl, won, awon, b_leaf, xi0, xi1, kr, a0, a1, a2, mx, off_scale, sign, fac;
  float ev, pv, pvs, wr, w, env_leaf, env_wi, env_ind, leaf_pre;
  bool alive, at_vertex, inner, rr_kill, branch, pv_ok, dirac;
};

// Lane i's vertex up to what its light samples read (Scene.cpp:85-119): the
// surface, the material, the depth-0 emitter and env leaves, the ε-offset
// point p_dl.
__device__ __forceinline__ Vtx vertex_base(const VtxArgs& A, int i) {
  Vtx v;
  v.o = mk(A.o[0][i], A.o[1][i], A.o[2][i]);
  v.d = mk(A.d[0][i], A.d[1][i], A.d[2][i]);
  v.chan = static_cast<int>(A.chan[i]);
  v.lam = A.lam[i];
  v.alive = A.alive[i];
  v.S = surface_at(A, i, v.o, v.d);
  const Surf& S = v.S;
  v.wo = neg(v.d);
  v.env_leaf = env_chan(A, v.d, v.chan);  // miss: env/background (Scene.cpp:88-95)
  v.m = gather_mat(A.T, S.mat, v.chan);
  const long long row =
      min(max(static_cast<long long>(S.mat), 0LL), static_cast<long long>(A.T.n_mat - 1));
  v.row = static_cast<int>(row);
  v.ok = S.mat == static_cast<float>(row);
  // depth-0 emitter hit (Scene.cpp:102-107)
  v.won = dot(v.wo, S.n);
  v.awon = fabsf(v.won);
  v.b_leaf = t_clamp(v.m.emit * v.awon, 0.0f, 1.0f);
  const bool is_b = A.depth == 0 && S.happened && S.emissive;
  v.at_vertex = v.alive && S.happened && !is_b;
  v.ior = v.m.ior_a + v.m.ior_b / (v.lam * v.lam);
  v.refl = v.m.textured > 0.5f ? chessboard(S.uvx, S.uvy) : v.m.refl;
  // NEE from the scale-relative ε-offset point (Scene.cpp:113-119)
  v.a0 = fabsf(S.p.x);
  v.a1 = fabsf(S.p.y);
  v.a2 = fabsf(S.p.z);
  v.mx = t_maximum(v.a0, t_maximum(v.a1, v.a2));
  v.off_scale = t_clamp_min(kRelEps * v.mx, kEps);
  v.p_dl = mk(S.p.x + S.n.x * v.off_scale, S.p.y + S.n.y * v.off_scale,
              S.p.z + S.n.z * v.off_scale);
  v.inner = v.won < 0.0f;
  return v;
}

// The rest of lane i's vertex `v` (Scene.cpp:109-110, 121-159) with its
// draws from k_vtx: the microfacet normal and Fresnel kr, roulette, the
// reflect/refract branch, the next ray and its weight.
__device__ __forceinline__ Vtx vertex_rest(const VtxArgs& A, Vtx v, int i, Key k_vtx) {
  const Surf& S = v.S;
  // microfacet normal + Fresnel split (Scene.cpp:109-110)
  const uint32_t base = 4u * static_cast<uint32_t>(i);
  v.xi0 = uniform_at(k_vtx, base);
  v.xi1 = uniform_at(k_vtx, base + 1u);
  const float xi2 = uniform_at(k_vtx, base + 2u), xi3 = uniform_at(k_vtx, base + 3u);
  v.mfn = sample_mfn(v.m, S.n, v.xi0, v.xi1);
  v.kr = fresnel(v.m, v.ior, v.d, v.mfn);
  v.fac = v.inner ? 1.0f - v.kr : v.kr;

  // Russian roulette + stochastic reflect/refract (Scene.cpp:121-159)
  v.rr_kill = xi2 >= A.rr_rate;
  v.branch = xi3 < v.kr;
  const float sign_reflect = dot(v.wo, v.mfn) < 0.0f ? -1.0f : 1.0f;
  v.sign = v.branch ? sign_reflect : -sign_reflect;
  const float os = v.off_scale * v.sign;
  v.p_new = mk(S.p.x + S.n.x * os, S.p.y + S.n.y * os, S.p.z + S.n.z * os);
  v.wi = v.branch ? reflect(v.wo, v.mfn) : refract(v.ior, v.d, v.mfn);
  v.ev = eval_bsdf(v.m, v.ior, v.refl, v.wi, v.wo, S.n, v.branch);
  v.pv = pdf(v.m, v.ior, v.wi, v.wo, S.n, v.branch);
  // indirect weight (Scene.cpp:135-144,162-171), the reference's |wo·n|
  v.pv_ok = fabsf(v.pv) > 1e-10f;
  v.pvs = v.pv_ok ? v.pv : 1.0f;
  v.wr = v.ev * v.awon / v.pvs;
  v.dirac = v.m.dirac > 0.5f;
  v.w = v.dirac ? v.ev * A.inv_rr : (v.pv_ok ? v.wr * A.inv_rr : 0.0f);
  v.env_wi = env_chan(A, v.wi, v.chan);
  v.env_ind = v.env_wi * v.ev * A.inv_rr;
  v.leaf_pre = !v.alive ? 0.0f : (!S.happened ? v.env_leaf : v.b_leaf);
  return v;
}

}  // namespace
