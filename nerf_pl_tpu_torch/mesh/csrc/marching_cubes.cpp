// Native mesh ops for nerf_pl_tpu: iso-surface extraction + triangle-cluster
// connected components.
//
// Replaces the reference's external native deps (PyMCubes for
// extract_color_mesh.py:144 and open3d's cluster_connected_triangles for
// :163-171) with one self-contained C++ library exposed through a C ABI and
// loaded from Python via ctypes (nerf_pl_tpu/mesh/native.py).
//
// Iso-surface extraction uses marching TETRAHEDRA: each grid cell splits
// into 6 tetrahedra around the main diagonal (a decomposition that assigns
// matching diagonals to the shared faces of neighboring cells, so the
// surface is watertight), and each tetrahedron's 16 in/out cases are handled
// in closed form — no 256-entry triangle table to transcribe. Vertices are
// deduplicated per grid edge via a hash map, positions linearly interpolated
// to the iso level. Coordinate convention matches PyMCubes: vertices are in
// (i, j, k) grid-index units with i varying over the first array axis.
//
// Build: g++ -O3 -shared -fPIC -o libnerfmesh.so marching_cubes.cpp

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

struct MeshOut {
  std::vector<float> verts;   // 3 * n_verts
  std::vector<int32_t> tris;  // 3 * n_tris
};

inline uint64_t edge_key(uint64_t a, uint64_t b) {
  return a < b ? (a << 32) | b : (b << 32) | a;
}

class Extractor {
 public:
  Extractor(const float *field, int nx, int ny, int nz, float iso)
      : field_(field), nx_(nx), ny_(ny), nz_(nz), iso_(iso) {
    out_ = new MeshOut();
    edge_to_vert_.reserve(1 << 16);
  }

  MeshOut *run() {
    // cube corners as (di, dj, dk)
    static const int C[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                                {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
    // 6 tetrahedra sharing the c0-c6 main diagonal; neighbors agree on
    // face diagonals, so the mesh is watertight.
    static const int T[6][4] = {{0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
                                {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6}};
    for (int i = 0; i < nx_ - 1; ++i)
      for (int j = 0; j < ny_ - 1; ++j)
        for (int k = 0; k < nz_ - 1; ++k) {
          float val[8];
          uint64_t cid[8];
          V3 pos[8];
          for (int c = 0; c < 8; ++c) {
            int ci = i + C[c][0], cj = j + C[c][1], ck = k + C[c][2];
            val[c] = field_[(size_t)ci * ny_ * nz_ + (size_t)cj * nz_ + ck];
            cid[c] = (uint64_t)ci * (ny_ + 1) * (nz_ + 1) +
                     (uint64_t)cj * (nz_ + 1) + ck;
            pos[c] = {(float)ci, (float)cj, (float)ck};
          }
          for (int t = 0; t < 6; ++t)
            do_tet(val, pos, cid, T[t]);
        }
    return out_;
  }

 private:
  int32_t vert_on_edge(const V3 &pa, const V3 &pb, float va, float vb,
                       uint64_t ia, uint64_t ib) {
    uint64_t key = edge_key(ia, ib);
    auto it = edge_to_vert_.find(key);
    if (it != edge_to_vert_.end()) return it->second;
    float denom = vb - va;
    float t = (std::fabs(denom) > 1e-12f) ? (iso_ - va) / denom : 0.5f;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    int32_t id = (int32_t)(out_->verts.size() / 3);
    out_->verts.push_back(pa.x + t * (pb.x - pa.x));
    out_->verts.push_back(pa.y + t * (pb.y - pa.y));
    out_->verts.push_back(pa.z + t * (pb.z - pa.z));
    edge_to_vert_.emplace(key, id);
    return id;
  }

  void emit(int32_t a, int32_t b, int32_t c) {
    if (a == b || b == c || a == c) return;  // degenerate (t clamped)
    out_->tris.push_back(a);
    out_->tris.push_back(b);
    out_->tris.push_back(c);
  }

  void do_tet(const float *val, const V3 *pos, const uint64_t *cid,
              const int idx[4]) {
    int mask = 0;
    for (int c = 0; c < 4; ++c)
      if (val[idx[c]] > iso_) mask |= 1 << c;
    if (mask == 0 || mask == 15) return;

    auto ev = [&](int a, int b) {
      return vert_on_edge(pos[idx[a]], pos[idx[b]], val[idx[a]], val[idx[b]],
                          cid[idx[a]], cid[idx[b]]);
    };

    // one corner separated from the other three -> one triangle
    auto one = [&](int a, int b, int c, int d) {
      emit(ev(a, b), ev(a, c), ev(a, d));
    };
    // two vs two -> quad -> two triangles
    auto two = [&](int a, int b, int c, int d) {
      int32_t vac = ev(a, c), vad = ev(a, d), vbc = ev(b, c), vbd = ev(b, d);
      emit(vac, vad, vbd);
      emit(vac, vbd, vbc);
    };

    switch (mask) {
      case 1:  one(0, 1, 2, 3); break;
      case 14: one(0, 1, 3, 2); break;
      case 2:  one(1, 0, 3, 2); break;
      case 13: one(1, 0, 2, 3); break;
      case 4:  one(2, 0, 1, 3); break;
      case 11: one(2, 0, 3, 1); break;
      case 8:  one(3, 0, 2, 1); break;
      case 7:  one(3, 0, 1, 2); break;
      case 3:  two(0, 1, 2, 3); break;   // {0,1} inside
      case 12: two(2, 3, 0, 1); break;
      case 5:  two(0, 2, 1, 3); break;   // {0,2} inside
      case 10: two(1, 3, 0, 2); break;
      case 6:  two(1, 2, 0, 3); break;   // {1,2} inside
      case 9:  two(0, 3, 1, 2); break;
    }
  }

  const float *field_;
  int nx_, ny_, nz_;
  float iso_;
  MeshOut *out_;
  std::unordered_map<uint64_t, int32_t> edge_to_vert_;
};

struct DSU {
  std::vector<int32_t> parent, rank_;
  explicit DSU(int64_t n) : parent(n), rank_(n, 0) {
    for (int64_t i = 0; i < n; ++i) parent[i] = (int32_t)i;
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    if (rank_[a] == rank_[b]) rank_[a]++;
  }
};

}  // namespace

extern "C" {

void *nerfmesh_marching_cubes(const float *field, int nx, int ny, int nz,
                              float iso) {
  Extractor ex(field, nx, ny, nz, iso);
  return ex.run();
}

int64_t nerfmesh_num_vertices(void *h) {
  return (int64_t)(((MeshOut *)h)->verts.size() / 3);
}
int64_t nerfmesh_num_triangles(void *h) {
  return (int64_t)(((MeshOut *)h)->tris.size() / 3);
}
void nerfmesh_copy(void *h, float *verts_out, int32_t *tris_out) {
  auto *m = (MeshOut *)h;
  std::memcpy(verts_out, m->verts.data(), m->verts.size() * sizeof(float));
  std::memcpy(tris_out, m->tris.data(), m->tris.size() * sizeof(int32_t));
}
void nerfmesh_free(void *h) { delete (MeshOut *)h; }

// Triangle connected components through shared vertices (open3d
// cluster_connected_triangles semantics for largest-cluster noise removal).
// Writes a cluster id per triangle; returns the number of clusters.
int32_t nerfmesh_cluster_triangles(const int32_t *tris, int64_t n_tris,
                                   int64_t n_verts, int32_t *cluster_out) {
  DSU dsu(n_verts);
  for (int64_t t = 0; t < n_tris; ++t) {
    dsu.unite(tris[3 * t], tris[3 * t + 1]);
    dsu.unite(tris[3 * t], tris[3 * t + 2]);
  }
  std::unordered_map<int32_t, int32_t> root_to_cluster;
  int32_t next = 0;
  for (int64_t t = 0; t < n_tris; ++t) {
    int32_t root = dsu.find(tris[3 * t]);
    auto it = root_to_cluster.find(root);
    if (it == root_to_cluster.end()) {
      root_to_cluster.emplace(root, next);
      cluster_out[t] = next++;
    } else {
      cluster_out[t] = it->second;
    }
  }
  return next;
}

}  // extern "C"
