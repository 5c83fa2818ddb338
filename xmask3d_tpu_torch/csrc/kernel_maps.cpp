// Host kernel-map builder of the sparse conv engine, in C++.
//
// The port's own copy of the JAX package's native builder: voxel-coordinate
// hashing, strided-unique downsampling and per-offset gather maps, with an
// open-addressing hash table over 20-bit-per-axis int64 keys. It builds the
// same maps as the numpy builder in `ops/sparse_conv.py` bit for bit
// (`tests/test_torch_native_kmaps.py`).
//
// Coordinates must lie in [0, 2^20) per axis (`data/native.py` checks):
// C++ `/` and `%` truncate toward zero where numpy's floor, which agree
// only on non-negative values.
//
// Built at first use by `data/native.py` with
// `g++ -O3 -fPIC -shared -std=c++17` into `xmask3d_tpu_torch/_build/` and
// bound with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBits = 20;
constexpr int64_t kEmpty = -1;

inline int64_t pack(const int32_t* c) {
  return (static_cast<int64_t>(c[0]) << (2 * kBits)) |
         (static_cast<int64_t>(c[1]) << kBits) | static_cast<int64_t>(c[2]);
}

inline uint64_t mix(uint64_t x) {
  // splitmix64 finalizer
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

// open-addressing hash table: keys int64, values int32 (first index wins)
struct Table {
  std::vector<int64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;

  explicit Table(int64_t n) {
    uint64_t cap = 16;
    while (cap < static_cast<uint64_t>(2 * n)) cap <<= 1;
    keys.assign(cap, kEmpty);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  // insert if absent; returns true when newly inserted
  bool insert(int64_t key, int32_t val) {
    uint64_t h = mix(static_cast<uint64_t>(key)) & mask;
    while (true) {
      if (keys[h] == kEmpty) {
        keys[h] = key;
        vals[h] = val;
        return true;
      }
      if (keys[h] == key) return false;
      h = (h + 1) & mask;
    }
  }

  int32_t find(int64_t key) const {
    uint64_t h = mix(static_cast<uint64_t>(key)) & mask;
    while (true) {
      if (keys[h] == kEmpty) return -1;
      if (keys[h] == key) return vals[h];
      h = (h + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

// Gather map: for each of k offsets and each of n_out output coords, the
// index of the input voxel at (out + offset), or -1.
// kmap must hold k * cap int32; columns beyond n_out stay -1.
void xm_build_kmap(const int32_t* coords, int64_t n, const int32_t* out_coords,
                   int64_t n_out, const int32_t* offsets, int32_t k,
                   int64_t cap, int32_t* kmap) {
  Table t(n);
  for (int64_t i = 0; i < n; ++i) t.insert(pack(coords + 3 * i), (int32_t)i);
  constexpr int32_t kMax = 1 << kBits;
  for (int32_t o = 0; o < k; ++o) {
    const int32_t* off = offsets + 3 * o;
    int32_t* row = kmap + o * cap;
    for (int64_t j = 0; j < n_out; ++j) {
      int32_t q[3] = {out_coords[3 * j] + off[0], out_coords[3 * j + 1] + off[1],
                      out_coords[3 * j + 2] + off[2]};
      // negative/overflow neighbor queries at the grid boundary never match
      if (q[0] < 0 || q[1] < 0 || q[2] < 0 || q[0] >= kMax || q[1] >= kMax ||
          q[2] >= kMax) {
        row[j] = -1;
      } else {
        row[j] = t.find(pack(q));
      }
    }
    for (int64_t j = n_out; j < cap; ++j) row[j] = -1;
  }
}

// Unique parents (c / stride * stride) in first-occurrence order.
// Returns the number written (<= capacity).
int64_t xm_unique_parents(const int32_t* coords, int64_t n, int32_t stride,
                          int64_t capacity, int32_t* out) {
  Table t(n);
  int64_t m = 0;
  for (int64_t i = 0; i < n && m < capacity; ++i) {
    int32_t p[3] = {coords[3 * i] / stride * stride,
                    coords[3 * i + 1] / stride * stride,
                    coords[3 * i + 2] / stride * stride};
    if (t.insert(pack(p), (int32_t)m)) {
      std::memcpy(out + 3 * m, p, 3 * sizeof(int32_t));
      ++m;
    }
  }
  return m;
}

// Parent lookup + octant for transposed convs: for each fine coord, the
// index of its stride-2x parent among parent_coords and the octant id
// (x*4 + y*2 + z of (c/stride) % 2).
void xm_parent_octant(const int32_t* coords, int64_t n,
                      const int32_t* parent_coords, int64_t n_parent,
                      int32_t stride, int64_t cap, int32_t* parent_idx,
                      int32_t* octant) {
  Table t(n_parent);
  for (int64_t i = 0; i < n_parent; ++i)
    t.insert(pack(parent_coords + 3 * i), (int32_t)i);
  int32_t s2 = 2 * stride;
  for (int64_t i = 0; i < n; ++i) {
    int32_t p[3] = {coords[3 * i] / s2 * s2, coords[3 * i + 1] / s2 * s2,
                    coords[3 * i + 2] / s2 * s2};
    parent_idx[i] = t.find(pack(p));
    int32_t ox = (coords[3 * i] / stride) % 2;
    int32_t oy = (coords[3 * i + 1] / stride) % 2;
    int32_t oz = (coords[3 * i + 2] / stride) % 2;
    octant[i] = ox * 4 + oy * 2 + oz;
  }
  for (int64_t i = n; i < cap; ++i) {
    parent_idx[i] = -1;
    octant[i] = 0;
  }
}

// Exact sparse quantization: dedup packed coords, emitting representative
// indices (first occurrence) and the point->voxel inverse map.
// Returns the voxel count. (reference dataset/voxelization_utils.py:38-102,
// exact int64 packing instead of FNV hashing.)
int64_t xm_sparse_quantize(const int32_t* coords, int64_t n, int32_t* inds,
                           int32_t* inverse) {
  Table t(n);
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t key = pack(coords + 3 * i);
    int32_t existing = t.find(key);
    if (existing < 0) {
      t.insert(key, (int32_t)m);
      inds[m] = (int32_t)i;
      inverse[i] = (int32_t)m;
      ++m;
    } else {
      inverse[i] = existing;
    }
  }
  return m;
}

}  // extern "C"
