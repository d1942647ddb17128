// Host-side native runtime for the ergodic-exploration engine.
//
// Reference counterpart: the C++ ROS node's map pipeline — OccupancyGrid
// deserialization + the per-pose Bresenham obstacle searches inside
// Collision (SURVEY.md sections 2 L1/L5, 4.3). The build replaces per-pose
// searches with a distance transform computed once per map update; THIS
// file is that transform's host-side implementation (exact Felzenszwalb-
// Huttenlocher EDT, O(HW)) plus ROS int8 ingest and the entropy map, so a
// real-time single-robot host loop never round-trips a map through the
// accelerator, and batched exploration jobs can preprocess thousands of
// maps on host threads while the device solves (the data-loader role).
//
// Exposed as a plain C ABI consumed via ctypes (see
// ergodic_exploration_tpu/native.py). No Python.h dependency.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

// 1-D squared distance transform (Felzenszwalb & Huttenlocher 2004).
// f: input costs (INF where empty), d: output min_j (q-j)^2 + f[j].
void dt1d(const float* f, float* d, int* v, float* z, int n) {
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = 1; q < n; q++) {
    if (f[q] == kInf) continue;
    float s;
    while (true) {
      if (f[v[k]] == kInf) {  // drop empty parabolas
        if (k == 0) {
          v[0] = q;
          z[0] = -kInf;
          z[1] = kInf;
          goto next_q;
        }
        k--;
        continue;
      }
      s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2.0f * q - 2.0f * v[k]);
      if (s <= z[k]) {
        k--;
      } else {
        break;
      }
    }
    k++;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kInf;
  next_q:;
  }
  k = 0;
  for (int q = 0; q < n; q++) {
    while (z[k + 1] < q) k++;
    float fv = f[v[k]];
    d[q] = (fv == kInf) ? kInf : (q - v[k]) * (q - v[k]) + fv;
  }
}

void edt2d_one(const float* occ_prob, int h, int w, float occupied_threshold,
               float resolution, float far, float* dist_out, float* grad_out) {
  std::vector<float> g(static_cast<size_t>(h) * w);
  // columns pass: per column j, squared vertical distance to nearest
  // occupied cell
  std::vector<float> f(std::max(h, w)), d(std::max(h, w)), z(std::max(h, w) + 1);
  std::vector<int> v(std::max(h, w));
  for (int j = 0; j < w; j++) {
    for (int i = 0; i < h; i++)
      f[i] = (occ_prob[i * w + j] >= occupied_threshold) ? 0.0f : kInf;
    dt1d(f.data(), d.data(), v.data(), z.data(), h);
    for (int i = 0; i < h; i++) g[i * w + j] = d[i];
  }
  // rows pass
  for (int i = 0; i < h; i++) {
    for (int j = 0; j < w; j++) f[j] = g[i * w + j];
    dt1d(f.data(), d.data(), v.data(), z.data(), w);
    for (int j = 0; j < w; j++) {
      float val = d[j];
      dist_out[i * w + j] =
          (val == kInf) ? far : std::sqrt(val) * resolution;
    }
  }
  if (grad_out == nullptr) return;
  // central differences (one-sided at borders), zeroed on the FAR plateau —
  // identical semantics to DistanceField.from_grid (ops/distance.py)
  for (int i = 0; i < h; i++) {
    for (int j = 0; j < w; j++) {
      float dc = dist_out[i * w + j];
      float gx, gy;
      if (dc >= far) {
        gx = gy = 0.0f;
      } else {
        if (j == 0)
          gx = (dist_out[i * w + 1] - dc) / resolution;
        else if (j == w - 1)
          gx = (dc - dist_out[i * w + w - 2]) / resolution;
        else
          gx = (dist_out[i * w + j + 1] - dist_out[i * w + j - 1]) /
               (2.0f * resolution);
        if (i == 0)
          gy = (dist_out[w + j] - dc) / resolution;
        else if (i == h - 1)
          gy = (dc - dist_out[(h - 2) * w + j]) / resolution;
        else
          gy = (dist_out[(i + 1) * w + j] - dist_out[(i - 1) * w + j]) /
               (2.0f * resolution);
      }
      grad_out[(i * w + j) * 2 + 0] = gx;
      grad_out[(i * w + j) * 2 + 1] = gy;
    }
  }
}

}  // namespace

extern "C" {

// ROS nav_msgs/OccupancyGrid int8 -> occupancy data: -1 stays -1 (unknown),
// 0..100 -> probability 0..1 (GridMap.from_ros parity).
void eet_ros_ingest(const int8_t* raw, int64_t n, float* out) {
  for (int64_t i = 0; i < n; i++) {
    int8_t r = raw[i];
    out[i] = (r < 0) ? -1.0f : static_cast<float>(r) / 100.0f;
  }
}

// Bernoulli entropy map with unknown cells at p=0.5 (target.mutual_
// information_map parity, sans blur).
void eet_entropy(const float* data, int64_t n, float* out) {
  constexpr float eps = 1e-6f;
  for (int64_t i = 0; i < n; i++) {
    float p = data[i] < 0.0f ? 0.5f : data[i];
    p = p < eps ? eps : (p > 1.0f - eps ? 1.0f - eps : p);
    out[i] = -(p * std::log(p) + (1.0f - p) * std::log1p(-p));
  }
}

// Exact EDT + gradient for one map. grad_out may be null.
void eet_edt2d(const float* occ_prob, int32_t h, int32_t w,
               float occupied_threshold, float resolution, float far,
               float* dist_out, float* grad_out) {
  edt2d_one(occ_prob, h, w, occupied_threshold, resolution, far, dist_out,
            grad_out);
}

// Batched EDT over n maps using host threads (the device feed path).
void eet_edt2d_batch(const float* occ_prob, int32_t n, int32_t h, int32_t w,
                     float occupied_threshold, float resolution, float far,
                     float* dist_out, float* grad_out, int32_t n_threads) {
  if (n_threads <= 0)
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  const size_t map = static_cast<size_t>(h) * w;
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) {
    pool.emplace_back([=]() {
      for (int32_t i = t; i < n; i += n_threads) {
        edt2d_one(occ_prob + i * map, h, w, occupied_threshold, resolution,
                  far, dist_out + i * map,
                  grad_out ? grad_out + i * map * 2 : nullptr);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
