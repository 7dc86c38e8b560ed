// Native host-side IO/preprocessing for patchwork_tpu.
//
// Equivalent of the reference's C++ runtime layer: the compute path lives
// on the device (JAX/XLA), but ingest hot loops — point-record
// extraction from serialized messages, KITTI bin loading with validity
// masking, and the host-side voxel-grid downsample (reference
// PointCloudProcessor::voxelGridFilter, point_cloud_processor.cpp:150-196,
// re-done with an open-addressing hash instead of std::string keys) — run
// natively and hand SoA float32 buffers straight to the device.
//
// Exposed as a plain C ABI consumed via ctypes (patchwork_tpu/io/native.py).
// Built on first use by patchwork_tpu/io/native.py (or native/build.sh)
// with g++ -O3 -fPIC -shared -std=c++17 into build/native/.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Strided xyz extraction from a packed point-record blob (PointCloud2
// data payload): out is (n, 3) float32 row-major.  Returns points written.
int64_t pw_extract_xyz(const uint8_t* data, int64_t n, int32_t point_step,
                       int32_t off_x, int32_t off_y, int32_t off_z,
                       float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* rec = data + i * point_step;
    float x, y, z;
    std::memcpy(&x, rec + off_x, 4);
    std::memcpy(&y, rec + off_y, 4);
    std::memcpy(&z, rec + off_z, 4);
    out[i * 3 + 0] = x;
    out[i * 3 + 1] = y;
    out[i * 3 + 2] = z;
  }
  return n;
}

// KITTI velodyne .bin loader: float32 (x,y,z,intensity) records.  Fills a
// fixed-capacity (cap, 3) buffer + validity mask (finite rows only) in one
// pass.  Returns the number of records read, or -1 on IO error.
int64_t pw_load_kitti_bin(const char* path, float* out_xyz, uint8_t* out_valid,
                          int64_t cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<float> rec(4096 * 4);
  int64_t count = 0;
  size_t got;
  while ((got = std::fread(rec.data(), sizeof(float), rec.size(), f)) > 0) {
    int64_t recs = static_cast<int64_t>(got) / 4;
    for (int64_t i = 0; i < recs && count < cap; ++i, ++count) {
      float x = rec[i * 4], y = rec[i * 4 + 1], z = rec[i * 4 + 2];
      out_xyz[count * 3 + 0] = x;
      out_xyz[count * 3 + 1] = y;
      out_xyz[count * 3 + 2] = z;
      out_valid[count] = std::isfinite(x) && std::isfinite(y) && std::isfinite(z);
    }
    if (count >= cap) break;
  }
  std::fclose(f);
  return count;
}

// Open-addressing voxel hash map for the host-side centroid downsample.
struct VoxelSlot {
  int64_t key;   // packed voxel coord, -1 = empty
  float sx, sy, sz;
  int32_t cnt;
};

static inline int64_t pack_voxel(int32_t vx, int32_t vy, int32_t vz) {
  // 21 bits per axis, offset to non-negative
  const int64_t off = 1 << 20;
  return (((int64_t)(vx + off)) << 42) | (((int64_t)(vy + off)) << 21) |
         ((int64_t)(vz + off));
}

// Voxel-grid centroid filter.  out_xyz must hold n rows.  Returns the
// number of occupied voxels (centroids written).
int64_t pw_voxel_downsample(const float* xyz, int64_t n, float voxel_size,
                            float* out_xyz) {
  if (n <= 0 || voxel_size <= 0) return 0;
  size_t slots = 1;
  while (slots < static_cast<size_t>(n) * 2) slots <<= 1;
  std::vector<VoxelSlot> table(slots);
  for (auto& s : table) s.key = -1;
  const float inv = 1.0f / voxel_size;
  const size_t mask = slots - 1;

  for (int64_t i = 0; i < n; ++i) {
    float x = xyz[i * 3], y = xyz[i * 3 + 1], z = xyz[i * 3 + 2];
    int32_t vx = (int32_t)std::floor(x * inv);
    int32_t vy = (int32_t)std::floor(y * inv);
    int32_t vz = (int32_t)std::floor(z * inv);
    int64_t key = pack_voxel(vx, vy, vz);
    size_t h = (size_t)(key * 0x9E3779B97F4A7C15ULL) & mask;
    while (true) {
      VoxelSlot& s = table[h];
      if (s.key == key) {
        s.sx += x; s.sy += y; s.sz += z; s.cnt += 1;
        break;
      }
      if (s.key == -1) {
        s.key = key; s.sx = x; s.sy = y; s.sz = z; s.cnt = 1;
        break;
      }
      h = (h + 1) & mask;
    }
  }
  int64_t out = 0;
  for (const auto& s : table) {
    if (s.key != -1) {
      out_xyz[out * 3 + 0] = s.sx / s.cnt;
      out_xyz[out * 3 + 1] = s.sy / s.cnt;
      out_xyz[out * 3 + 2] = s.sz / s.cnt;
      ++out;
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// Greedy sequential landmark association (SLAM back end).
//
// Exact semantics of patchwork_tpu/slam/landmarks._LandmarkGrid: process
// observations in order; match each to the nearest existing landmark
// strictly within `gate` (running means included, so earlier observations
// of the same keyframe are visible), update the running mean (re-bucketing
// when it crosses a cell), else insert a new landmark.  Cell size == gate,
// so every in-gate landmark lies in the 27 neighboring cells.  The Python
// batched path (kd-tree snapshot + dirty overlay) is the fallback; this is
// the production path for multi-thousand-keyframe maps (VERDICT r2 item 7).

struct PwAssoc {
  double gate;
  double inv;                                  // 1 / cell
  std::vector<float> pos;                      // 3 * L running means
  std::vector<int64_t> cnt;
  std::vector<int64_t> key_of;
  std::unordered_map<int64_t, std::vector<int32_t>> cells;
};

static inline int64_t pw_assoc_key(double x, double y, double z, double inv) {
  const int64_t off = 1 << 20;
  int64_t ix = (int64_t)std::floor(x * inv) + off;
  int64_t iy = (int64_t)std::floor(y * inv) + off;
  int64_t iz = (int64_t)std::floor(z * inv) + off;
  return (ix << 42) | (iy << 21) | iz;
}

void* pw_assoc_create(double gate) {
  PwAssoc* a = new PwAssoc();
  a->gate = gate;
  a->inv = 1.0 / gate;
  return a;
}

void pw_assoc_destroy(void* h) { delete static_cast<PwAssoc*>(h); }

int64_t pw_assoc_size(void* h) {
  return static_cast<int64_t>(static_cast<PwAssoc*>(h)->cnt.size());
}

// Associate one keyframe's world-frame observations (n, 3) float32;
// writes each observation's landmark id into ids_out (n,).
void pw_assoc_add(void* h, const float* world, int64_t n, int64_t* ids_out) {
  PwAssoc& a = *static_cast<PwAssoc*>(h);
  const double g2 = a.gate * a.gate;
  for (int64_t i = 0; i < n; ++i) {
    const double wx = world[i * 3], wy = world[i * 3 + 1],
                 wz = world[i * 3 + 2];
    const int64_t off = 1 << 20;
    const int64_t cx = (int64_t)std::floor(wx * a.inv) + off;
    const int64_t cy = (int64_t)std::floor(wy * a.inv) + off;
    const int64_t cz = (int64_t)std::floor(wz * a.inv) + off;
    int32_t best = -1;
    double best_d2 = g2;
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
          auto it = a.cells.find(((cx + dx) << 42) | ((cy + dy) << 21) |
                                 (cz + dz));
          if (it == a.cells.end()) continue;
          for (int32_t j : it->second) {
            const double ddx = (double)a.pos[j * 3] - wx;
            const double ddy = (double)a.pos[j * 3 + 1] - wy;
            const double ddz = (double)a.pos[j * 3 + 2] - wz;
            const double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 < best_d2) { best = j; best_d2 = d2; }
          }
        }
    if (best >= 0) {
      const double c = (double)a.cnt[best];
      const double nx = ((double)a.pos[best * 3] * c + wx) / (c + 1.0);
      const double ny = ((double)a.pos[best * 3 + 1] * c + wy) / (c + 1.0);
      const double nz = ((double)a.pos[best * 3 + 2] * c + wz) / (c + 1.0);
      a.pos[best * 3] = (float)nx;
      a.pos[best * 3 + 1] = (float)ny;
      a.pos[best * 3 + 2] = (float)nz;
      a.cnt[best] += 1;
      const int64_t key = pw_assoc_key(a.pos[best * 3], a.pos[best * 3 + 1],
                                       a.pos[best * 3 + 2], a.inv);
      if (key != a.key_of[best]) {
        auto& old = a.cells[a.key_of[best]];
        for (size_t k = 0; k < old.size(); ++k)
          if (old[k] == best) { old.erase(old.begin() + k); break; }
        a.cells[key].push_back(best);
        a.key_of[best] = key;
      }
      ids_out[i] = best;
    } else {
      const int32_t j = (int32_t)a.cnt.size();
      a.pos.push_back(world[i * 3]);
      a.pos.push_back(world[i * 3 + 1]);
      a.pos.push_back(world[i * 3 + 2]);
      a.cnt.push_back(1);
      const int64_t key = pw_assoc_key(world[i * 3], world[i * 3 + 1],
                                       world[i * 3 + 2], a.inv);
      a.key_of.push_back(key);
      a.cells[key].push_back(j);
      ids_out[i] = j;
    }
  }
}

// Export running means (L, 3) float32 and observation counts (L,).
void pw_assoc_export(void* h, float* pos_out, int64_t* cnt_out) {
  PwAssoc& a = *static_cast<PwAssoc*>(h);
  std::memcpy(pos_out, a.pos.data(), a.pos.size() * sizeof(float));
  std::memcpy(cnt_out, a.cnt.data(), a.cnt.size() * sizeof(int64_t));
}

}  // extern "C"
