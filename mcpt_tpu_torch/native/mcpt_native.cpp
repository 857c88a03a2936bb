// mcpt_native: host-side native runtime for the TPU path tracer.
//
// The reference implements its asset pipeline and acceleration-structure
// build in C++ (vendored OBJ_Loader.hpp, lodepng, BVH.cpp). These are the
// host-side (non-XLA) hot paths of this framework too, so they are native
// here as well:
//   - obj_load:   Wavefront OBJ -> flat per-face-vertex arrays
//                 (capability of OBJ_Loader.hpp:363 LoadFile + fan
//                 triangulation, consumed like Triangle.hpp:83-135)
//   - bvh_build:  median-split / binned-SAH BVH over AABBs, flattened to
//                 the threaded miss-link layout (same contract as bvh.py)
//
// C ABI, ctypes-consumed (native.py). Two-call pattern: *_query returns
// sizes, caller allocates numpy buffers, *_fill writes them.
//
// Build: g++ -O2 -shared -fPIC -o libmcpt_native.so mcpt_native.cpp

#include <algorithm>
#include <array>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ loader
// ---------------------------------------------------------------------------

struct ObjData {
  std::vector<float> positions;  // F*9
  std::vector<float> texcoords;  // F*6
  std::vector<float> normals;    // F*9
};

static thread_local ObjData g_obj;

static int parse_index(const char* tok, int count) {
  int i = std::atoi(tok);
  return i > 0 ? i - 1 : count + i;
}

// Returns the number of triangles, or -1 on error. Data cached for obj_fill.
long obj_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(sz, '\0');
  if (std::fread(buf.data(), 1, sz, f) != (size_t)sz) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  std::vector<float> vs, vts, vns;
  g_obj.positions.clear();
  g_obj.texcoords.clear();
  g_obj.normals.clear();
  std::vector<std::array<int, 3>> face;

  const char* p = buf.data();
  const char* end = p + buf.size();
  char tokbuf[256];
  while (p < end) {
    // one line
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) nl = end;
    const char* q = p;
    p = nl + 1;
    // skip leading spaces
    while (q < nl && (*q == ' ' || *q == '\t')) q++;
    if (q >= nl || *q == '#') continue;
    if (q[0] == 'v' && (q + 1 < nl) && q[1] == ' ') {
      float x = 0, y = 0, z = 0;
      std::sscanf(q + 2, "%f %f %f", &x, &y, &z);
      vs.push_back(x);
      vs.push_back(y);
      vs.push_back(z);
    } else if (q[0] == 'v' && q[1] == 't') {
      float u = 0, v = 0;
      std::sscanf(q + 3, "%f %f", &u, &v);
      vts.push_back(u);
      vts.push_back(v);
    } else if (q[0] == 'v' && q[1] == 'n') {
      float x = 0, y = 0, z = 0;
      std::sscanf(q + 3, "%f %f %f", &x, &y, &z);
      vns.push_back(x);
      vns.push_back(y);
      vns.push_back(z);
    } else if (q[0] == 'f' && (q[1] == ' ' || q[1] == '\t')) {
      face.clear();
      const char* t = q + 2;
      while (t < nl) {
        while (t < nl && (*t == ' ' || *t == '\t')) t++;
        if (t >= nl) break;
        const char* ts = t;
        while (t < nl && *t != ' ' && *t != '\t' && *t != '\r') t++;
        size_t len = std::min<size_t>(t - ts, sizeof(tokbuf) - 1);
        std::memcpy(tokbuf, ts, len);
        tokbuf[len] = 0;
        int vi = -1, ti = -1, ni = -1;
        char* s1 = std::strchr(tokbuf, '/');
        if (!s1) {
          vi = parse_index(tokbuf, (int)vs.size() / 3);
        } else {
          *s1 = 0;
          vi = parse_index(tokbuf, (int)vs.size() / 3);
          char* s2 = std::strchr(s1 + 1, '/');
          if (s2) {
            *s2 = 0;
            if (s2 > s1 + 1) ti = parse_index(s1 + 1, (int)vts.size() / 2);
            if (*(s2 + 1)) ni = parse_index(s2 + 1, (int)vns.size() / 3);
          } else if (*(s1 + 1)) {
            ti = parse_index(s1 + 1, (int)vts.size() / 2);
          }
        }
        face.push_back({vi, ti, ni});
      }
      // fan triangulation
      for (size_t k = 1; k + 1 < face.size(); k++) {
        const std::array<int, 3> tri[3] = {face[0], face[k], face[k + 1]};
        for (int c = 0; c < 3; c++) {
          int vi = tri[c][0], ti = tri[c][1], ni = tri[c][2];
          for (int j = 0; j < 3; j++)
            g_obj.positions.push_back(
                (vi >= 0 && (size_t)(3 * vi + j) < vs.size()) ? vs[3 * vi + j]
                                                              : 0.f);
          for (int j = 0; j < 2; j++)
            g_obj.texcoords.push_back(
                (ti >= 0 && (size_t)(2 * ti + j) < vts.size()) ? vts[2 * ti + j]
                                                               : 0.f);
          for (int j = 0; j < 3; j++)
            g_obj.normals.push_back(
                (ni >= 0 && (size_t)(3 * ni + j) < vns.size()) ? vns[3 * ni + j]
                                                               : 0.f);
        }
      }
    }
  }
  return (long)(g_obj.positions.size() / 9);
}

void obj_fill(float* positions, float* texcoords, float* normals) {
  std::memcpy(positions, g_obj.positions.data(),
              g_obj.positions.size() * sizeof(float));
  std::memcpy(texcoords, g_obj.texcoords.data(),
              g_obj.texcoords.size() * sizeof(float));
  std::memcpy(normals, g_obj.normals.data(),
              g_obj.normals.size() * sizeof(float));
  ObjData().positions.swap(g_obj.positions);  // release
  ObjData().texcoords.swap(g_obj.texcoords);
  ObjData().normals.swap(g_obj.normals);
}

// ---------------------------------------------------------------------------
// BVH builder (flattened threaded layout; contract identical to bvh.py)
// ---------------------------------------------------------------------------

struct BvhOut {
  std::vector<float> node_min, node_max;  // N*3
  std::vector<int32_t> node_miss, leaf_start, leaf_count;  // N
  std::vector<int32_t> prim_ids;  // P
};

static thread_local BvhOut g_bvh;

struct BuildNode {
  float bmin[3], bmax[3];
  int32_t left = -1, right = -1;
  int32_t prim_start = -1, prim_count = 0;  // into a scratch prim order
};

static void aabb_of(const float* mn, const float* mx, const int32_t* ids,
                    int n, float* bmin, float* bmax) {
  for (int j = 0; j < 3; j++) {
    bmin[j] = FLT_MAX;
    bmax[j] = -FLT_MAX;
  }
  for (int i = 0; i < n; i++) {
    for (int j = 0; j < 3; j++) {
      bmin[j] = std::min(bmin[j], mn[3 * ids[i] + j]);
      bmax[j] = std::max(bmax[j], mx[3 * ids[i] + j]);
    }
  }
}

// method: 0 = median (reference BVH.cpp:50-89 semantics), 1 = binned SAH.
long bvh_build(const float* aabb_min, const float* aabb_max, long n,
               int leaf_size, int method, int sah_bins) {
  g_bvh = BvhOut();
  if (n <= 0) return 0;
  std::vector<float> cent(3 * n);
  for (long i = 0; i < n; i++)
    for (int j = 0; j < 3; j++)
      cent[3 * i + j] = 0.5f * (aabb_min[3 * i + j] + aabb_max[3 * i + j]);

  std::vector<int32_t> order(n);
  for (long i = 0; i < n; i++) order[i] = (int32_t)i;

  std::vector<BuildNode> nodes;
  nodes.reserve(2 * n / std::max(leaf_size, 1) + 8);

  // Iterative DFS build: frames are (segment of `order`, parent, is_right).
  struct Frame {
    long lo, hi;
    int32_t parent;
    bool right;
  };
  std::vector<Frame> stack;
  stack.push_back({0, n, -1, false});
  std::vector<int32_t> right_child;
  while (!stack.empty()) {
    Frame fr = stack.back();
    stack.pop_back();
    int32_t idx = (int32_t)nodes.size();
    nodes.emplace_back();
    right_child.push_back(-1);
    BuildNode& nd = nodes[idx];
    long cnt = fr.hi - fr.lo;
    aabb_of(aabb_min, aabb_max, order.data() + fr.lo, (int)cnt, nd.bmin,
            nd.bmax);
    if (fr.parent >= 0) {
      if (fr.right)
        right_child[fr.parent] = idx;
      else
        nodes[fr.parent].left = idx;
    }
    if (cnt <= leaf_size) {
      nd.prim_start = (int32_t)fr.lo;
      nd.prim_count = (int32_t)cnt;
      continue;
    }
    // centroid bounds + longest axis
    float cmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX},
          cmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (long i = fr.lo; i < fr.hi; i++)
      for (int j = 0; j < 3; j++) {
        cmin[j] = std::min(cmin[j], cent[3 * order[i] + j]);
        cmax[j] = std::max(cmax[j], cent[3 * order[i] + j]);
      }
    int axis = 0;
    float ext[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1], cmax[2] - cmin[2]};
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    long mid = fr.lo + cnt / 2;
    bool did_sah = false;
    if (method == 1 && ext[axis] > 0.f) {
      // binned SAH on the longest axis
      int nb = sah_bins;
      std::vector<int> bin_of(cnt);
      std::vector<long> counts(nb, 0);
      std::vector<float> bmn(nb * 3, FLT_MAX), bmx(nb * 3, -FLT_MAX);
      float inv = nb / ext[axis];
      for (long i = 0; i < cnt; i++) {
        int32_t pid = order[fr.lo + i];
        int b = std::min(nb - 1,
                         (int)((cent[3 * pid + axis] - cmin[axis]) * inv));
        bin_of[i] = b;
        counts[b]++;
        for (int j = 0; j < 3; j++) {
          bmn[3 * b + j] = std::min(bmn[3 * b + j], aabb_min[3 * pid + j]);
          bmx[3 * b + j] = std::max(bmx[3 * b + j], aabb_max[3 * pid + j]);
        }
      }
      auto surf = [](const float* mn2, const float* mx2) {
        float d0 = std::max(mx2[0] - mn2[0], 0.f),
              d1 = std::max(mx2[1] - mn2[1], 0.f),
              d2 = std::max(mx2[2] - mn2[2], 0.f);
        return 2.f * (d0 * d1 + d0 * d2 + d1 * d2);
      };
      double best_cost = DBL_MAX;
      int best_b = -1;
      for (int b = 1; b < nb; b++) {
        long nl = 0;
        float lmn[3] = {FLT_MAX, FLT_MAX, FLT_MAX},
              lmx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX}, rmn[3] = {FLT_MAX,
                                                                 FLT_MAX,
                                                                 FLT_MAX},
              rmx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        for (int k = 0; k < b; k++) {
          nl += counts[k];
          for (int j = 0; j < 3; j++) {
            lmn[j] = std::min(lmn[j], bmn[3 * k + j]);
            lmx[j] = std::max(lmx[j], bmx[3 * k + j]);
          }
        }
        long nr = cnt - nl;
        if (nl == 0 || nr == 0) continue;
        for (int k = b; k < nb; k++)
          for (int j = 0; j < 3; j++) {
            rmn[j] = std::min(rmn[j], bmn[3 * k + j]);
            rmx[j] = std::max(rmx[j], bmx[3 * k + j]);
          }
        double cost = (double)surf(lmn, lmx) * nl + (double)surf(rmn, rmx) * nr;
        if (cost < best_cost) {
          best_cost = cost;
          best_b = b;
        }
      }
      if (best_b > 0) {
        auto it = std::stable_partition(
            order.begin() + fr.lo, order.begin() + fr.hi, [&](int32_t pid) {
              int b = std::min(
                  nb - 1, (int)((cent[3 * pid + axis] - cmin[axis]) * inv));
              return b < best_b;
            });
        mid = it - order.begin();
        did_sah = (mid > fr.lo && mid < fr.hi);
      }
    }
    if (!did_sah) {
      if (ext[axis] > 0.f) {
        std::nth_element(order.begin() + fr.lo, order.begin() + mid,
                         order.begin() + fr.hi, [&](int32_t a, int32_t b) {
                           return cent[3 * a + axis] < cent[3 * b + axis];
                         });
      }
      // degenerate spread: plain halving (mid already set)
    }
    stack.push_back({mid, fr.hi, idx, true});
    stack.push_back({fr.lo, mid, idx, false});
  }

  // Flatten: pop order above IS DFS preorder; compute miss links.
  long nn = (long)nodes.size();
  g_bvh.node_min.resize(nn * 3);
  g_bvh.node_max.resize(nn * 3);
  g_bvh.node_miss.assign(nn, -1);
  g_bvh.leaf_start.assign(nn, -1);
  g_bvh.leaf_count.assign(nn, 0);
  g_bvh.prim_ids.clear();
  g_bvh.prim_ids.reserve(n);
  for (long i = 0; i < nn; i++) {
    std::memcpy(&g_bvh.node_min[3 * i], nodes[i].bmin, 12);
    std::memcpy(&g_bvh.node_max[3 * i], nodes[i].bmax, 12);
    if (nodes[i].left >= 0) {
      int32_t l = nodes[i].left, r = right_child[i];
      g_bvh.node_miss[l] = r;
      g_bvh.node_miss[r] = g_bvh.node_miss[i];
    } else {
      g_bvh.leaf_start[i] = (int32_t)g_bvh.prim_ids.size();
      g_bvh.leaf_count[i] = nodes[i].prim_count;
      for (int k = 0; k < nodes[i].prim_count; k++)
        g_bvh.prim_ids.push_back(order[nodes[i].prim_start + k]);
    }
  }
  return nn;
}

long bvh_prim_count() { return (long)g_bvh.prim_ids.size(); }

void bvh_fill(float* node_min, float* node_max, int32_t* node_miss,
              int32_t* leaf_start, int32_t* leaf_count, int32_t* prim_ids) {
  std::memcpy(node_min, g_bvh.node_min.data(),
              g_bvh.node_min.size() * sizeof(float));
  std::memcpy(node_max, g_bvh.node_max.data(),
              g_bvh.node_max.size() * sizeof(float));
  std::memcpy(node_miss, g_bvh.node_miss.data(),
              g_bvh.node_miss.size() * sizeof(int32_t));
  std::memcpy(leaf_start, g_bvh.leaf_start.data(),
              g_bvh.leaf_start.size() * sizeof(int32_t));
  std::memcpy(leaf_count, g_bvh.leaf_count.data(),
              g_bvh.leaf_count.size() * sizeof(int32_t));
  std::memcpy(prim_ids, g_bvh.prim_ids.data(),
              g_bvh.prim_ids.size() * sizeof(int32_t));
  g_bvh = BvhOut();
}

}  // extern "C"
