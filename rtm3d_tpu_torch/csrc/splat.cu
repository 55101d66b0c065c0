// Gaussian heatmap target splat for Hopper (sm_90a): one block per 8x64
// tile of one image, four pixels a thread, the tile's live slots compacted
// once, one store per output element.
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
// (rtm3d_tpu_torch/ops/splat.py::splat_bytes, ::splat_flops). A PyTorch fill
// of the same output takes about 1.1x that bound; the rest of this kernel's
// time is reading the slots before the first store and the Gaussians of the
// few tiles that hold several objects.
//
// Design:
// - A block of 128 threads owns one 8x64 tile of one image; a thread owns
//   four neighbouring pixels of one row and holds their C running maxima in
//   registers (C is a template parameter, so the class select is unrolled
//   and nothing spills to local memory). A warp covers a 16x8 patch, so a
//   slot's window (11x11 at the training shape) meets about 2 of a tile's 4
//   warps where a warp of 64x2 pixels met 6 of 8. Small blocks even out the
//   tiles that hold several objects. The tile shape is this file's
//   (splat_tile_shape); ops/splat.py::splat_launch_geometry gives the grid
//   of such tiles, and this file checks that it covers the map.
// - The block reads its image's slots 128 at a time, one per thread, and
//   keeps a slot only if it is masked in and its window (or a noise center)
//   reaches the tile. The kept slots are compacted into a shared list with
//   __ballot_sync, __popc and a prefix over the block's warps, so the pixel
//   loop runs over live slots only (about 2 a tile at the training shape,
//   of 64), and a thread whose four pixels the window misses skips the
//   slot. A tile that no slot reaches stores zeros and nothing else.
// - No atomics and no read-modify-write of device memory: each output
//   element is stored once, 16 bytes a thread and class where the row is
//   16-byte aligned and all four pixels are on the map (W % 4 == 0), one
//   float at a time on the ragged edge. The result is deterministic.
// - IEEE expf and division (build without --use_fast_math): the focal loss
//   counts a pixel positive only where the target is exactly 1.0, and
//   exp(-0/x) is exactly 1. d^2 is computed in integers and then converted,
//   as the TPU kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A thread owns kPixels pixels along x; a warp 4 x 8 threads, so a 16 x 8
// pixel patch; a block kWarpCols x kWarpRows warps, so an 8 x 64 tile.
constexpr int kPixels = 4;
constexpr int kLaneCols = 4, kLaneRows = 8;
constexpr int kWarpCols = 4, kWarpRows = 1;
constexpr int kTileW = kWarpCols * kLaneCols * kPixels;
constexpr int kTileH = kWarpRows * kLaneRows;
constexpr int kWarps = kWarpCols * kWarpRows;
constexpr int kThreads = 32 * kWarps;  // also the slots read per chunk
constexpr int kMaxClasses = 8;
constexpr int kNoiseBit = 1 << 8;  // above the class in a slot's meta word
constexpr unsigned kFullMask = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(kThreads)
splat_kernel(const int32_t* __restrict__ m_proj,   // (B, N, 2): x, y
             const int32_t* __restrict__ cls,      // (B, N)
             const float* __restrict__ sigma,      // (B, N)
             const float* __restrict__ radius,     // (B, N)
             const uint8_t* __restrict__ mask,     // (B, N)
             const uint8_t* __restrict__ noise,    // (B, N)
             float* __restrict__ out,              // (B, C, H, W)
             int n_slots, int height, int width) {
  // the live slots of the current chunk, compacted
  __shared__ int s_cx[kThreads], s_cy[kThreads], s_meta[kThreads];
  __shared__ float s_two_s2[kThreads], s_rad[kThreads];
  __shared__ int s_warp_live[kWarps];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int px = x0 + ((warp % kWarpCols) * kLaneCols + lane % kLaneCols) * kPixels;
  const int y = y0 + (warp / kWarpCols) * kLaneRows + lane / kLaneCols;
  // the tile's last pixel, clipped to the map
  const int x1 = min(x0 + kTileW, width) - 1, y1 = min(y0 + kTileH, height) - 1;

  float acc[C][kPixels];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < kPixels; ++k) acc[c][k] = 0.f;
  }

  for (int base = 0; base < n_slots; base += kThreads) {
    bool live = false;
    int cx = 0, cy = 0, meta = 0;
    float two_s2 = 0.f, r = 0.f;
    if (tid < n_slots - base) {
      const int64_t i = static_cast<int64_t>(b) * n_slots + base + tid;
      if ((reinterpret_cast<uintptr_t>(m_proj) & 7u) == 0) {  // one 8-byte load where aligned
        const int2 c = reinterpret_cast<const int2*>(m_proj)[i];
        cx = c.x;
        cy = c.y;
      } else {
        cx = m_proj[2 * i];
        cy = m_proj[2 * i + 1];
      }
      r = radius[i];
      const float s = sigma[i];
      const bool m = mask[i] != 0;
      // the window, and a noise center whatever R is, reaching the tile
      const float reach = fmaxf(r, 0.f);
      const float gap_x = static_cast<float>(max(max(x0 - cx, cx - x1), 0));
      const float gap_y = static_cast<float>(max(max(y0 - cy, cy - y1), 0));
      live = m && gap_x <= reach && gap_y <= reach;
      meta = min(max(cls[i], 0), C - 1) | (m && noise[i] != 0 ? kNoiseBit : 0);
      two_s2 = 2.f * s * s;
    }
    // Compact the live slots. A warp that writes s_warp_live here has passed
    // the previous chunk's second barrier, so every warp is done reading it,
    // and the first barrier keeps the list until every warp is done with it.
    const unsigned ballot = __ballot_sync(kFullMask, live);
    if (lane == 0) s_warp_live[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int n = s_warp_live[v];
      offset += v < warp ? n : 0;
      total += n;
    }
    if (live) {
      const int k = offset + __popc(ballot & ((1u << lane) - 1u));
      s_cx[k] = cx;
      s_cy[k] = cy;
      s_meta[k] = meta;
      s_two_s2[k] = two_s2;
      s_rad[k] = r;
    }
    __syncthreads();
    for (int n = 0; n < total; ++n) {
      const int dy = y - s_cy[n];
      const float rad = s_rad[n];
      const int meta_n = s_meta[n];
      const bool row_in = fabsf(static_cast<float>(dy)) <= rad;
      const bool noise_row = (meta_n & kNoiseBit) && dy == 0;
      const int dx0 = px - s_cx[n];
      // g is 0 on this thread's pixels unless the window or the noise
      // center meets them
      const bool cols_in = static_cast<float>(dx0) <= rad &&
                           static_cast<float>(dx0 + kPixels - 1) >= -rad;
      const bool center_in = noise_row && dx0 <= 0 && dx0 + kPixels > 0;
      if (!(row_in && cols_in) && !center_in) continue;
      const float two_s2_n = s_two_s2[n];
      const int c_n = meta_n & (kNoiseBit - 1);
      float g[kPixels];
#pragma unroll
      for (int k = 0; k < kPixels; ++k) {
        const int dx = dx0 + k;
        g[k] = 0.f;
        if (row_in && fabsf(static_cast<float>(dx)) <= rad) {
          const float d2 = static_cast<float>(dx * dx + dy * dy);  // in the window: no overflow
          g[k] = expf(-d2 / two_s2_n);
        }
        if (noise_row && dx == 0) g[k] = 0.9999f;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c != c_n) continue;  // the slot's class: the same in every thread
#pragma unroll
        for (int k = 0; k < kPixels; ++k) acc[c][k] = fmaxf(acc[c][k], g[k]);
      }
    }
  }

  if (y >= height) return;
  const int64_t plane = static_cast<int64_t>(height) * width;
  float* dst = out + static_cast<int64_t>(b) * C * plane + static_cast<int64_t>(y) * width + px;
  if (width % 4 == 0 && px + kPixels <= width) {
    // px and every row start are multiples of 4 floats: 16-byte stores
#pragma unroll
    for (int c = 0; c < C; ++c) {
      *reinterpret_cast<float4*>(dst + c * plane) = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int k = 0; k < kPixels; ++k) {
        if (px + k < width) dst[c * plane + k] = acc[c][k];
      }
    }
  }
}

template <int C>
int launch(const int32_t* m_proj, const int32_t* cls, const float* sigma, const float* radius,
           const uint8_t* mask, const uint8_t* noise, float* out, int batch, int n_slots,
           int height, int width, int grid_x, int grid_y, cudaStream_t stream) {
  const dim3 grid(grid_x, grid_y, batch);
  splat_kernel<C><<<grid, kThreads, 0, stream>>>(m_proj, cls, sigma, radius, mask, noise, out,
                                              n_slots, height, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int splat_max_classes() { return kMaxClasses; }

// The pixels of a block's tile: rows (tile_h) and columns (tile_w).
extern "C" void splat_tile_shape(int* tile_h, int* tile_w) {
  *tile_h = kTileH;
  *tile_w = kTileW;
}

// Launch a grid_x x grid_y x batch grid of tiles on `stream`; returns
// cudaGetLastError() as an int (0 = launched), or cudaErrorInvalidValue for
// a class count outside 1..kMaxClasses or a grid that does not cover the
// map.
extern "C" int splat_heatmap_launch(const int32_t* m_proj, const int32_t* cls,
                                    const float* sigma, const float* radius,
                                    const uint8_t* mask, const uint8_t* noise, float* out,
                                    int batch, int n_slots, int height, int width,
                                    int num_classes, int grid_x, int grid_y,
                                    cudaStream_t stream) {
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  if (grid_x <= 0 || grid_y <= 0 ||
      static_cast<int64_t>(grid_x) * kTileW < width ||
      static_cast<int64_t>(grid_y) * kTileH < height) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (num_classes) {
#define SPLAT_CASE(c)                                                                              \
  case c:                                                                                          \
    return launch<c>(m_proj, cls, sigma, radius, mask, noise, out, batch, n_slots, height, width, \
                     grid_x, grid_y, stream);
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
