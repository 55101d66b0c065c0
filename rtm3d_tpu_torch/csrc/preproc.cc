// Fused host preprocessing for the port's reader (rtm3d_tpu_torch/data/
// native.py, data/fast_preproc.py): host C++, the port's own copy of the JAX
// package's native/preproc.cc.
//
// The reference's host path is OpenCV's C++ kernels called one python op at
// a time (cv2.warpAffine / cv2.resize / normalize, reference:
// preprocess/transforms.py:346,492-494, dataset_reader.py:63-69), plus a
// per-image mean-pad (dataset_reader.py:175-195). This library fuses the
// whole image path (affine warp covering resize + pad + scale-shift
// augmentation as one matrix, border fill, /255-mean/std normalisation) into
// ONE pass over the image, and processes batches with a persistent thread
// pool. Exposed through a plain C ABI for ctypes.
//
// Built at first use by rtm3d_tpu_torch/utils/kernel_build.py (build_host):
//   c++ -O3 -std=c++17 -shared -fPIC -pthread -> rtm3d_tpu_torch/_build/preproc-<hash>.so
// without the JAX build's -march=native (native/Makefile), so the compiler
// contracts no multiply-add into an FMA here where that build may.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------------
// Tiny persistent thread pool.
// ----------------------------------------------------------------------
class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void Run(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      tasks_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

ThreadPool* pool() {
  static ThreadPool* p = new ThreadPool(
      std::max(1u, std::thread::hardware_concurrency()));
  return p;
}

// ----------------------------------------------------------------------
// Fused inverse-mapped bilinear affine warp + normalize.
// dst(y, x) = (bilinear(src, M^-1 * (x, y)) / 255 - mean) / std
// Out-of-bounds samples take the border colour.
// M is the FORWARD 2x3 matrix (src -> dst), like cv2.warpAffine.
// ----------------------------------------------------------------------
void WarpNormalizeOne(const uint8_t* src, int sh, int sw, const float* M,
                      const float* border, float* dst, int dh, int dw,
                      const float* mean, const float* stdv) {
  // invert the forward affine
  const float a = M[0], b = M[1], c = M[2];
  const float d = M[3], e = M[4], f = M[5];
  const float det = a * e - b * d;
  const float inv_det = det != 0.f ? 1.f / det : 0.f;
  const float ia = e * inv_det, ib = -b * inv_det;
  const float id = -d * inv_det, ie = a * inv_det;
  const float ic = -(ia * c + ib * f);
  const float iff = -(id * c + ie * f);

  const float inv255 = 1.f / 255.f;
  float bnorm[3], sinv[3];
  for (int ch = 0; ch < 3; ++ch) {
    bnorm[ch] = (border[ch] * inv255 - mean[ch]) / stdv[ch];
    sinv[ch] = inv255 / stdv[ch];
  }

  for (int y = 0; y < dh; ++y) {
    float* drow = dst + (size_t)y * dw * 3;
    const float fy = (float)y;
    for (int x = 0; x < dw; ++x) {
      const float sx = ia * x + ib * fy + ic;
      const float sy = id * x + ie * fy + iff;
      float* out = drow + x * 3;
      if (sx < -1.f || sy < -1.f || sx >= (float)sw || sy >= (float)sh) {
        out[0] = bnorm[0];
        out[1] = bnorm[1];
        out[2] = bnorm[2];
        continue;
      }
      int x0 = (int)std::floor(sx), y0 = (int)std::floor(sy);
      const float wx = sx - x0, wy = sy - y0;
      const int x1 = x0 + 1, y1 = y0 + 1;
      const float w00 = (1 - wx) * (1 - wy), w01 = wx * (1 - wy);
      const float w10 = (1 - wx) * wy, w11 = wx * wy;
      for (int ch = 0; ch < 3; ++ch) {
        auto sample = [&](int yy, int xx) -> float {
          if (xx < 0 || yy < 0 || xx >= sw || yy >= sh) return border[ch];
          return (float)src[((size_t)yy * sw + xx) * 3 + ch];
        };
        const float v = w00 * sample(y0, x0) + w01 * sample(y0, x1) +
                        w10 * sample(y1, x0) + w11 * sample(y1, x1);
        out[ch] = v * sinv[ch] - mean[ch] / stdv[ch];
      }
    }
  }
}

}  // namespace

extern "C" {

// Single image. src: uint8 HWC BGR (sh, sw, 3); M: forward 2x3 affine;
// border: 3 floats (0..255); dst: float32 (dh, dw, 3); mean/std: 3 floats
// in 0..1 space.
void rtm3d_warp_normalize(const uint8_t* src, int sh, int sw, const float* M,
                          const float* border, float* dst, int dh, int dw,
                          const float* mean, const float* stdv) {
  WarpNormalizeOne(src, sh, sw, M, border, dst, dh, dw, mean, stdv);
}

// Batch: images may have different source sizes; all land on (dh, dw).
// srcs: array of pointers; shs/sws: per-image sizes; Ms: (n, 6); borders:
// (n, 3); dst: (n, dh, dw, 3) contiguous.
void rtm3d_warp_normalize_batch(const uint8_t** srcs, const int* shs,
                                const int* sws, const float* Ms,
                                const float* borders, float* dst, int n,
                                int dh, int dw, const float* mean,
                                const float* stdv) {
  std::atomic<int> done(0);
  std::mutex mu;
  std::condition_variable cv;
  for (int i = 0; i < n; ++i) {
    pool()->Run([=, &done, &mu, &cv] {
      WarpNormalizeOne(srcs[i], shs[i], sws[i], Ms + (size_t)i * 6,
                       borders + (size_t)i * 3,
                       dst + (size_t)i * dh * dw * 3, dh, dw, mean, stdv);
      {
        std::lock_guard<std::mutex> lock(mu);
        done.fetch_add(1);
      }
      cv.notify_one();
    });
  }
  std::unique_lock<std::mutex> lock(mu);
  cv.wait(lock, [&] { return done.load() == n; });
}

// Gaussian heatmap splat (numpy-oracle-compatible, for CPU target building
// when the on-device path is not used). hm: (C, H, W) float32, updated with
// max-combine. centers: (n, 2) int; cls: (n,); sigma/radius: (n,); noise:
// (n,) 0/1; mask: (n,) 0/1.
void rtm3d_splat_heatmap(float* hm, int C, int H, int W, const int* centers,
                         const int* cls, const float* sigma,
                         const float* radius, const uint8_t* noise,
                         const uint8_t* mask, int n) {
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    const int cx = centers[i * 2], cy = centers[i * 2 + 1];
    const int r = (int)radius[i];
    const float s2 = 2.f * sigma[i] * sigma[i];
    const int c = cls[i];
    if (c < 0 || c >= C) continue;
    float* plane = hm + (size_t)c * H * W;
    for (int dy = -r; dy <= r; ++dy) {
      const int yy = cy + dy;
      if (yy < 0 || yy >= H) continue;
      for (int dx = -r; dx <= r; ++dx) {
        const int xx = cx + dx;
        if (xx < 0 || xx >= W) continue;
        float g = std::exp(-(float)(dx * dx + dy * dy) / s2);
        if (noise[i] && dx == 0 && dy == 0) g = 0.9999f;
        float& ref = plane[(size_t)yy * W + xx];
        if (g > ref) ref = g;
      }
    }
  }
}

int rtm3d_version() { return 1; }

}  // extern "C"
