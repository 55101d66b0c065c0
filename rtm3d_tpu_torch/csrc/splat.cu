// Gaussian heatmap target splat for Hopper (sm_90a): one thread per output
// pixel, the object loop in registers, one store per output element.
//
// Replaces rtm3d_tpu/ops/splat.py::_splat_kernel (the Pallas TPU kernel
// launched by splat_heatmap_pallas). Same function: for every (b, y, x) and
// class c, the max over slots n of
//     g = exp(-(dx^2 + dy^2) / (2 sigma^2)),  dx = x - cx, dy = y - cy
// (integer offsets from the integer center), 0 outside |dx| <= R and
// |dy| <= R, 0.9999 at a noise slot's center, counted only where mask[b, n]
// is set and clip(cls[b, n], 0, C-1) == c; 0 where no slot reaches. The
// output is NCHW (B, C, H, W), the port's logits layout; the TPU kernel's
// public layout was NHWC.
//
// What bounds it: memory. Each object touches a window of a few hundred
// pixels, so at the training shape (B 32, N 64, C 3, 96x320) the work is
// ~1e6 operations against an 11.8 MB output that must be written once
// (rtm3d_tpu_torch/ops/splat.py::splat_bytes, ::splat_flops). At that size
// the launch itself dominates.
//
// Design, right before fast:
// - A block is one 32x8 tile of one image; a thread owns one pixel and
//   holds its C running maxima in registers (C is a template parameter, so
//   the class select is unrolled and nothing spills to local memory).
// - The block stages the image's slots in shared memory, 64 at a time
//   (6 scalars each), and marks a slot live only if it is masked in and its
//   window (or a noise center) reaches the tile. Every thread of the block
//   reads the same flag, so a dead slot is skipped uniformly across warps.
// - No atomics and no read-modify-write of device memory: each output
//   element is stored once, coalesced along x, and the result is
//   deterministic.
// - IEEE expf and division (build without --use_fast_math): the focal loss
//   counts a pixel positive only where the target is exactly 1.0, and
//   exp(-0/x) is exactly 1. d^2 is computed in integers and then converted,
//   as the TPU kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kSlotChunk = 64;
constexpr int kMaxClasses = 8;

template <int C>
__global__ void __launch_bounds__(kTileX * kTileY)
splat_kernel(const int32_t* __restrict__ m_proj,   // (B, N, 2): x, y
             const int32_t* __restrict__ cls,      // (B, N)
             const float* __restrict__ sigma,      // (B, N)
             const float* __restrict__ radius,     // (B, N)
             const uint8_t* __restrict__ mask,     // (B, N)
             const uint8_t* __restrict__ noise,    // (B, N)
             float* __restrict__ out,              // (B, C, H, W)
             int n_slots, int height, int width) {
  __shared__ int s_cx[kSlotChunk], s_cy[kSlotChunk], s_cls[kSlotChunk];
  __shared__ float s_two_s2[kSlotChunk], s_rad[kSlotChunk];
  __shared__ int s_flags[kSlotChunk];  // bit0 live, bit1 noise

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  // the tile's last pixel, clipped to the map
  const int x1 = min(x0 + kTileX, width) - 1, y1 = min(y0 + kTileY, height) - 1;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;

  for (int base = 0; base < n_slots; base += kSlotChunk) {
    const int count = min(kSlotChunk, n_slots - base);
    if (tid < count) {
      const int64_t i = static_cast<int64_t>(b) * n_slots + base + tid;
      const int cx = m_proj[2 * i], cy = m_proj[2 * i + 1];
      const float s = sigma[i], r = radius[i];
      const bool m = mask[i] != 0;
      const bool nz = m && noise[i] != 0;
      // the window, and a noise center whatever R is, reaching the tile
      const float reach = fmaxf(r, 0.f);
      const float gap_x = static_cast<float>(max(max(x0 - cx, cx - x1), 0));
      const float gap_y = static_cast<float>(max(max(y0 - cy, cy - y1), 0));
      const bool live = m && gap_x <= reach && gap_y <= reach;
      s_cx[tid] = cx;
      s_cy[tid] = cy;
      s_cls[tid] = min(max(cls[i], 0), C - 1);
      s_two_s2[tid] = 2.f * s * s;
      s_rad[tid] = r;
      s_flags[tid] = (live ? 1 : 0) | (nz ? 2 : 0);
    }
    __syncthreads();
    for (int n = 0; n < count; ++n) {
      const int flags = s_flags[n];
      if (!(flags & 1)) continue;  // the same for every thread of the block
      const int dx = x - s_cx[n], dy = y - s_cy[n];
      const float r = s_rad[n];
      float g = 0.f;
      if (fabsf(static_cast<float>(dx)) <= r && fabsf(static_cast<float>(dy)) <= r) {
        const float d2 = static_cast<float>(dx * dx + dy * dy);  // in the window: no overflow
        g = expf(-d2 / s_two_s2[n]);
      }
      if ((flags & 2) && dx == 0 && dy == 0) g = 0.9999f;
      const int c_n = s_cls[n];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c == c_n) acc[c] = fmaxf(acc[c], g);
      }
    }
    __syncthreads();
  }

  if (x < width && y < height) {
    const int64_t plane = static_cast<int64_t>(height) * width;
    float* dst = out + static_cast<int64_t>(b) * C * plane + static_cast<int64_t>(y) * width + x;
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c * plane] = acc[c];
  }
}

template <int C>
int launch(const int32_t* m_proj, const int32_t* cls, const float* sigma, const float* radius,
           const uint8_t* mask, const uint8_t* noise, float* out, int batch, int n_slots,
           int height, int width, cudaStream_t stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((width + kTileX - 1) / kTileX, (height + kTileY - 1) / kTileY, batch);
  splat_kernel<C><<<grid, block, 0, stream>>>(m_proj, cls, sigma, radius, mask, noise, out,
                                              n_slots, height, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int splat_max_classes() { return kMaxClasses; }

// Launch on `stream`; returns cudaGetLastError() as an int (0 = launched),
// or cudaErrorInvalidValue for a class count outside 1..kMaxClasses.
extern "C" int splat_heatmap_launch(const int32_t* m_proj, const int32_t* cls,
                                    const float* sigma, const float* radius,
                                    const uint8_t* mask, const uint8_t* noise, float* out,
                                    int batch, int n_slots, int height, int width,
                                    int num_classes, cudaStream_t stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  switch (num_classes) {
#define SPLAT_CASE(c) \
  case c:             \
    return launch<c>(m_proj, cls, sigma, radius, mask, noise, out, batch, n_slots, height, width, stream);
    SPLAT_CASE(1)
    SPLAT_CASE(2)
    SPLAT_CASE(3)
    SPLAT_CASE(4)
    SPLAT_CASE(5)
    SPLAT_CASE(6)
    SPLAT_CASE(7)
    SPLAT_CASE(8)
#undef SPLAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
