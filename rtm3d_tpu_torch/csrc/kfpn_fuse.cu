// The KFPN's softmax-attention fusion for Hopper (sm_90a), in two launches:
//
//     z = x0 + sum_i up_i * softmax_HW(up_i)
//
// over the upsampled maps up_i in the order they are given (the KFPN's loop:
// level 5, then 4, then 3), every softmax per (image, channel) over the H x W
// pixels. All maps are channels_last, (B, H, W, C) in memory, of one dtype
// (bfloat16 or float32, the detect step's compute dtypes); z is written in
// the same layout and dtype.
//
// Replaces no TPU kernel: the JAX package leaves this fusion to XLA
// (rtm3d_tpu/nn/kfpn.py). PyTorch's composition of it (a layout copy, a
// softmax, a broadcast multiply of a channels_last map by an NCHW one, an
// add, per level) moves each stride-4 map five times and runs two of the
// four steps in the generic, unvectorised elementwise kernel.
//
// What bounds it: memory. Every map has to be read twice, once for its
// statistics and once to weight it, and z written once:
// ops/kfpn_fuse.py::kfpn_fuse_bytes = (2 n + 2) maps' bytes for n upsampled
// maps, 4.36 GB at b32 x 256 x 104 x 320 in bf16 (n = 3), 1.30 ms at
// 3.35 TB/s. The arithmetic (one exp2 a value a pass) is a fifth of that
// at the SFU's rate.
//
// Design:
// - A thread owns 8 channels of a pixel: one 16-byte load in bf16, two in
//   fp32; a pixel's C channels are C / 8 neighbouring threads, so a
//   warp reads 512 contiguous bytes of a 256-channel bf16 map.
// - Statistics (stats_kernel), one launch for every map: a cluster of
//   kCluster blocks per (map, image, channel slice), each block a
//   contiguous eighth of the pixels; at a small batch the channels are cut
//   into slices of at least 32, so that the grid still covers the SMs
//   (ops/kfpn_fuse.py::kfpn_fuse_stats_slices). A thread keeps an online
//   (max, sum of exp2) pair per channel over kUnroll pixels at a time
//   (kUnroll + 1 exp2 per kUnroll values); a block combines its pixel
//   lanes' pairs in shared memory, lane by lane; the cluster's blocks then
//   read each other's partials through distributed shared memory, block 0
//   first, each block finishing an eighth of the slice's channels, and
//   store two statistics per (map, image, channel): the max m and log2 of
//   the sum of exponentials l.
//   No atomics: every sum is taken in a fixed order, so two runs give the
//   same bits.
// - Apply (apply_kernel): a thread reads its channels' statistics once,
//   then for each of its pixels x0 and every up_i, accumulates
//   x0 + up_i * exp2((up_i - m_i) * log2e - l_i) in float32 in the maps'
//   order, rounds once to the maps' dtype and stores z. The difference
//   up_i - m_i comes first, exact near the max, as in PyTorch's softmax: a
//   single folded shift log2e * m + l, rounded at the magnitude of m,
//   put an error of |m| * 2^-24 on every weight (1e-3 on the maps of a
//   trained network in fp32, whose values reach 1e4).
// - The exp2 is the SFU's (ex2.approx.ftz: 2 ulp, far below bf16's
//   rounding, which the composition pays three times over).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kVec = 8;              // channels a thread owns
constexpr int kCluster = 8;          // statistics blocks per (map, image)
constexpr int kStatsThreads = 512;   // at most, per statistics block
constexpr int kApplyThreads = 256;   // at most, per apply block
constexpr int kUnroll = 4;           // pixels a statistics thread loads at once
constexpr int kMaxUps = 4;           // ops/kfpn_fuse.py::_refusal holds the same limits
constexpr int kMaxChannels = 1024;   // shared memory of a statistics block <= 40 KB
constexpr int64_t kMaxImageValues = (int64_t{1} << 31) - 1;  // hw * channels: 32-bit offsets
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

struct Ups {
  const void* p[kMaxUps];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[kVec]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[kVec]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// sum * exp2((m - to) * log2e): a partial (m, sum) rescaled to the max `to`;
// 0 for a partial that saw no pixel (m = -inf)
__device__ __forceinline__ float rescaled(float m, float sum, float to) {
  return m == -CUDART_INF_F ? 0.f : sum * ex2((m - to) * kLog2e);
}

// grid (kCluster, batch, n_ups * slices), block (channels / slices / kVec)
// * lanes threads; dynamic shared memory (2 * lanes + 2) * channels / slices
// floats. Block z = (map, channel slice); the cluster's blocks split the
// pixels of one image.
template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kStatsThreads)
stats_kernel(Ups ups, float* __restrict__ stats, int batch, int channels, int hw, int slices) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int width = channels / slices;  // the block's channels
  const int groups = width / kVec;
  const int lanes = blockDim.x / groups;
  const int tid = threadIdx.x, g = tid % groups, lane = tid / groups;
  const int level = blockIdx.z / slices, first = (blockIdx.z % slices) * width, b = blockIdx.y;
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t p0 = static_cast<int64_t>(hw) * rank / kCluster;
  const int64_t p1 = static_cast<int64_t>(hw) * (rank + 1) / kCluster;
  const T* src = static_cast<const T*>(ups.p[level]) + static_cast<int64_t>(b) * hw * channels + first + g * kVec;

  float m[kVec], s[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    m[c] = -CUDART_INF_F;
    s[c] = 0.f;
  }
  int64_t px = p0 + lane;
  for (; px + (kUnroll - 1) * lanes < p1; px += kUnroll * lanes) {
    float x[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load8(src + (px + u * lanes) * channels, x[u]);
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      float mx = m[c];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, x[u][c]);
      float acc = s[c] * ex2((m[c] - mx) * kLog2e);  // m = -inf: 0 * 0
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += ex2((x[u][c] - mx) * kLog2e);
      s[c] = acc;
      m[c] = mx;
    }
  }
  for (; px < p1; px += lanes) {
    float x[kVec];
    load8(src + px * channels, x);
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const float mx = fmaxf(m[c], x[c]);
      s[c] = s[c] * ex2((m[c] - mx) * kLog2e) + ex2((x[c] - mx) * kLog2e);
      m[c] = mx;
    }
  }

  // the block's lanes, lane by lane: smem[lane][c] maxima, then sums, then
  // the block's own partial (max, sum) per channel
  float* lane_m = smem;
  float* lane_s = smem + lanes * width;
  float* part = smem + 2 * lanes * width;
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    lane_m[lane * width + g * kVec + c] = m[c];
    lane_s[lane * width + g * kVec + c] = s[c];
  }
  __syncthreads();
  for (int c = tid; c < width; c += blockDim.x) {
    float mx = -CUDART_INF_F;
    for (int q = 0; q < lanes; ++q) mx = fmaxf(mx, lane_m[q * width + c]);
    float sum = 0.f;
    for (int q = 0; q < lanes; ++q) sum += rescaled(lane_m[q * width + c], lane_s[q * width + c], mx);
    part[c] = mx;
    part[width + c] = sum;
  }
  cluster.sync();  // every block's partial is in its shared memory

  // this block finishes channels [rank * per, (rank + 1) * per) of its
  // slice over the cluster's partials, block 0 first
  const int per = width / kCluster;
  for (int c = rank * per + tid; c < (rank + 1) * per; c += blockDim.x) {
    float mx = -CUDART_INF_F;
    for (int q = 0; q < kCluster; ++q) mx = fmaxf(mx, cluster.map_shared_rank(part, q)[c]);
    float sum = 0.f;
    for (int q = 0; q < kCluster; ++q) {
      const float* r = cluster.map_shared_rank(part, q);
      sum += rescaled(r[c], r[width + c], mx);
    }
    const int64_t at = (static_cast<int64_t>(level) * batch + b) * channels + first + c;
    stats[at] = mx;
    stats[static_cast<int64_t>(gridDim.z / slices) * batch * channels + at] = log2f(sum);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// grid (blocks_x, batch), block (channels / kVec) * lanes threads; the
// blocks of an image stride over its pixels.
template <typename T, int N>
__global__ void __launch_bounds__(kApplyThreads)
apply_kernel(const T* __restrict__ x0, Ups ups, const float* __restrict__ stats, T* __restrict__ out,
             int batch, int channels, int hw) {
  const int groups = channels / kVec;
  const int lanes = blockDim.x / groups;
  const int g = threadIdx.x % groups, lane = threadIdx.x / groups;
  const int b = blockIdx.y;
  float m[N][kVec], lg[N][kVec];
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const int64_t at = (static_cast<int64_t>(l) * batch + b) * channels + g * kVec;
    load8(stats + at, m[l]);
    load8(stats + static_cast<int64_t>(N) * batch * channels + at, lg[l]);
  }
  // offsets within the image in 32 bits (hw * channels < 2^31, checked at
  // launch): with 64-bit ones the bf16 kernel of three maps spilled
  const int64_t image = static_cast<int64_t>(b) * hw * channels;
  x0 += image;
  out += image;
  for (int px = blockIdx.x * lanes + lane; px < hw; px += gridDim.x * lanes) {
    const int off = px * channels + g * kVec;
    float acc[kVec], u[N][kVec];
    load8(x0 + off, acc);
#pragma unroll
    for (int l = 0; l < N; ++l) load8(static_cast<const T*>(ups.p[l]) + image + off, u[l]);
#pragma unroll
    for (int l = 0; l < N; ++l) {
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        acc[c] = fmaf(u[l][c], ex2(fmaf(u[l][c] - m[l][c], kLog2e, -lg[l][c])), acc[c]);
      }
    }
    store8(out + off, acc);
  }
}

template <typename T, int N>
int launch(const void* x0, Ups ups, float* stats, void* out, int batch, int channels, int hw, int slices,
           int blocks_x, cudaStream_t stream) {
  const int width = channels / slices, groups = width / kVec;
  const int lanes = kStatsThreads / groups;
  const size_t smem = static_cast<size_t>(2 * lanes + 2) * width * sizeof(float);
  stats_kernel<T><<<dim3(kCluster, batch, N * slices), groups * lanes, smem, stream>>>(ups, stats, batch, channels,
                                                                                      hw, slices);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int apply_groups = channels / kVec;
  apply_kernel<T, N><<<dim3(blocks_x, batch), apply_groups * (kApplyThreads / apply_groups), 0, stream>>>(
      static_cast<const T*>(x0), ups, stats, static_cast<T*>(out), batch, channels, hw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const void* x0, Ups ups, int n_ups, float* stats, void* out, int batch, int channels, int hw,
             int slices, int blocks_x, cudaStream_t stream) {
  switch (n_ups) {
    case 1: return launch<T, 1>(x0, ups, stats, out, batch, channels, hw, slices, blocks_x, stream);
    case 2: return launch<T, 2>(x0, ups, stats, out, batch, channels, hw, slices, blocks_x, stream);
    case 3: return launch<T, 3>(x0, ups, stats, out, batch, channels, hw, slices, blocks_x, stream);
    case 4: return launch<T, 4>(x0, ups, stats, out, batch, channels, hw, slices, blocks_x, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The two launches on `stream`: statistics of up0..up{n_ups-1} into `stats`
// (2, n_ups, batch, channels) float32 (the maxima, then log2 of the sums of
// exponentials), then z into `out`. Every map is
// (batch, hw, channels) in memory, hw * channels < 2^31, 16-byte aligned, of
// `dtype` (0 float32, 1 bfloat16). `slices`: the channel slices of a statistics
// block (channels / slices a multiple of kVec); `blocks_x`: the apply
// blocks of an image. Returns cudaGetLastError() after each launch as an
// int (0 = launched), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int kfpn_fuse_launch(const void* x0, const void* up0, const void* up1, const void* up2,
                                const void* up3, int n_ups, float* stats, void* out, int batch, int channels,
                                int hw, int dtype, int slices, int blocks_x, cudaStream_t stream) {
  if (batch <= 0 || hw <= 0) return 0;
  if (n_ups < 1 || n_ups > kMaxUps || channels <= 0 || channels % kVec != 0 || channels > kMaxChannels ||
      slices <= 0 || channels % (slices * kVec) != 0 || blocks_x <= 0 || batch > 65535 ||
      static_cast<int64_t>(hw) * channels > kMaxImageValues) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Ups ups = {{up0, up1, up2, up3}};
  switch (dtype) {
    case kFloat32:
      return launch_n<float>(x0, ups, n_ups, stats, out, batch, channels, hw, slices, blocks_x, stream);
    case kBFloat16:
      return launch_n<__nv_bfloat16>(x0, ups, n_ups, stats, out, batch, channels, hw, slices, blocks_x, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
