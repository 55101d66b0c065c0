// Modulated deformable convolution (DCNv2) forward for Hopper (sm_90a), one launch a layer:
//
//     y[b, h, w, o] = sum_k sum_c W[o, k, c] * m_k * bilinear(x[b, :, :, c], (h, w) + p_k + dp_k)
//
// over the 3x3 taps k = 3i + j at p_k = (i - 1, j - 1): stride 1, padding 1, dilation 1, one deformable
// group, no bias (Zhu et al., arXiv:1811.11168; mmcv's ModulatedDeformConv2dPack, as FCOS3D's
// ResNet-101-DCN runs it in every 3x3 conv of its layer3 and layer4). x is channels_last, (B, H, W, C_in) in
// memory; om, the offset conv's raw output, (B, H, W, 27): (dy_k, dx_k) at channels (2k, 2k + 1), then 9
// mask logits, which this kernel passes through a sigmoid; W is (C_out, 3, 3, C_in), a channels_last conv
// weight; y is (B, H, W, C_out). One dtype, bfloat16 or float32. A sample reads 0 where its position lies
// outside (-1, H) x (-1, W), and each bilinear corner that falls outside the map reads 0.
//
// Replaces no TPU kernel: the JAX package has no deformable convolution. It was added because no PyTorch
// operation computes DCNv2 (the card's machine has no torchvision), and the composition of gathers and a
// convolution (ops/dcn.py::dcn_reference) writes and reads nine copies of each input map a layer.
//
// What bounds it: operations. It is an implicit GEMM of M = B x H x W output pixels, N = C_out,
// K = 9 x C_in: 2 x 9 x C_in x C_out x B x H x W operations (ops/dcn.py::dcn_flops), 78.5 GFLOP for each
// of ResNet-101-DCN's 23 layer3 convs at b32 x 256 channels x 26 x 80 (1280x416 at stride 16) and for each
// of its 3 layer4 convs (512 channels, 13 x 40): 2.04 TFLOP a b32 call, 2.06 ms at the bf16 tensor cores'
// 989 TFLOP/s. The bytes it must move are x, om and W read once and y written once (69 MB a layer3 conv
// in bf16, 21 us at 3.35 TB/s): far under the operations' time, so it is compute-bound. The gathered
// corner reads (four a sample) hit L2, where the 34 MB input map stays.
//
// Design (a first design, right and simple; wgmma, TMA and persistence are later work):
// - A block computes a 128-pixel x 128-channel tile of y with 8 warps, 64 x 32 each, on mma.sync
//   m16n8k16 (bf16 in, fp32 accumulators) in bf16; in fp32 each thread computes 8 x 8 outputs with FFMA
//   (exact fp32 products, no TF32).
// - K runs tap by tap, 32 input channels a step. The A tile (128 pixels x 32 channels) is gathered: for
//   each tap a thread computes, for its two pixels, the four corners' offsets and their bilinear weights
//   times the mask in fp32 once, then at every step loads the corners' 8-channel vectors (16 bytes in
//   bf16: each corner one contiguous, coalesced load of a pixel's channels), sums them under those
//   weights in fp32, rounds once to the dtype and stores the vector to shared memory. The B tile (the
//   weights, K contiguous) arrives by cp.async.
// - Two stages: the next step's corner loads and weight copies are issued before the current step's MMAs
//   and stored after them, so the gather's latency hides behind the tensor cores; one barrier a step.
// - Shared-memory rows are padded (80 bytes in bf16) so that each fragment load of a warp touches 32
//   distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output pixels of a block
constexpr int kBN = 128;       // output channels of a block
constexpr int kBK = 32;        // input channels of one K step: a slice of one tap
constexpr int kThreads = 256;  // 8 warps
constexpr int kVec = 8;        // channels of one gathered vector
constexpr int kOcts = kBK / kVec;                             // vectors across a step's channels
constexpr int kRowsPerThread = kBM * kOcts / kThreads;        // pixels a thread gathers: 2
constexpr int kRowStep = kThreads / kOcts;                    // between a thread's pixels: 64
constexpr int kTaps = 9;
constexpr int kOffsetChannels = 27;
constexpr int64_t kMaxValues = (int64_t{1} << 31) - 1;        // 32-bit element offsets

enum DType { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kStride = kBK + 8;  // elements a shared row: 80 bytes
  using Raw = uint4;                       // 8 channels
  static constexpr int kRawPerVec = 1;
};
template <>
struct Tile<float> {
  static constexpr int kStride = kBK + 4;  // 144 bytes
  using Raw = float4;                      // 4 channels
  static constexpr int kRawPerVec = 2;
};

template <typename T>
constexpr int smem_bytes() {
  return 2 * (kBM + kBN) * Tile<T>::kStride * static_cast<int>(sizeof(T));  // A and B, two stages
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Sample {
  int off[4];  // element offset of each bilinear corner's channels, -1 where the corner reads 0
  float w[4];  // its bilinear weight times the mask
};

// The four corners of tap `tap` of output pixel `pix` (a row of the GEMM), in fp32 from the offsets.
template <typename T>
__device__ __forceinline__ void tap_sample(const T* __restrict__ om, int pix, int m_total, int H, int W, int C,
                                           int tap, Sample& s) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s.off[c] = -1;
    s.w[c] = 0.f;
  }
  if (pix >= m_total) return;
  const int hw = H * W;
  const int b = pix / hw;
  const int r = pix - b * hw;
  const int h = r / W;
  const int w = r - h * W;
  const T* o = om + static_cast<int64_t>(pix) * kOffsetChannels;
  const float py = static_cast<float>(h - 1 + tap / 3) + to_float(o[2 * tap]);
  const float px = static_cast<float>(w - 1 + tap % 3) + to_float(o[2 * tap + 1]);
  const float mask = 1.f / (1.f + expf(-to_float(o[18 + tap])));
  if (!(py > -1.f && px > -1.f && py < static_cast<float>(H) && px < static_cast<float>(W))) return;
  const float fy = floorf(py), fx = floorf(px);
  const int y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
  const float ly = py - fy, lx = px - fx;
  const float wt[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx, ly * (1.f - lx), ly * lx};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int yy = y0 + (c >> 1), xx = x0 + (c & 1);
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      s.off[c] = ((b * H + yy) * W + xx) * C;
      s.w[c] = wt[c] * mask;
    }
  }
}

template <typename T>
struct Gathered {
  typename Tile<T>::Raw raw[kRowsPerThread][4][Tile<T>::kRawPerVec];
};

// Issue the corner loads of a step: channels [cbase, cbase + 8) of each corner of the thread's pixels.
template <typename T>
__device__ __forceinline__ void gather_load(const T* __restrict__ x, const Sample (&s)[kRowsPerThread], int cbase,
                                            Gathered<T>& g) {
  using Raw = typename Tile<T>::Raw;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const Raw* p = reinterpret_cast<const Raw*>(x + (s[r].off[c] < 0 ? 0 : s[r].off[c] + cbase));
#pragma unroll
      for (int v = 0; v < Tile<T>::kRawPerVec; ++v) g.raw[r][c][v] = s[r].off[c] < 0 ? Raw{} : __ldg(p + v);
    }
  }
}

__device__ __forceinline__ void unpack(const uint4 (&raw)[1], float (&f)[kVec]) {
  const uint32_t u[4] = {raw[0].x, raw[0].y, raw[0].z, raw[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);  // bf16 to fp32 is exact: the high half of the word
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const float4 (&raw)[2], float (&f)[kVec]) {
  f[0] = raw[0].x, f[1] = raw[0].y, f[2] = raw[0].z, f[3] = raw[0].w;
  f[4] = raw[1].x, f[5] = raw[1].y, f[6] = raw[1].z, f[7] = raw[1].w;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // round to nearest even, as torch's cast
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, const float (&f)[kVec]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

__device__ __forceinline__ void store_vec(float* dst, const float (&f)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// Sum each pixel's corners under their weights in fp32, round once, store the vector to the A tile.
template <typename T>
__device__ __forceinline__ void gather_store(const Gathered<T>& g, const Sample (&s)[kRowsPerThread], T* a_tile,
                                             int tid) {
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float f[kVec];
      unpack(g.raw[r][c], f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(s[r].w[c], f[e], acc[e]);
    }
    store_vec(a_tile + (tid / kOcts + r * kRowStep) * Tile<T>::kStride + (tid % kOcts) * kVec, acc);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The B tile of a step: 128 output channels x 32 K values (K contiguous), from W's rows of K = 9 C_in.
template <typename T>
__device__ __forceinline__ void load_b(const T* __restrict__ w, T* b_tile, int n0, int k0, int K, int tid) {
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunksPerRow = kBK / kPerChunk;
#pragma unroll
  for (int i = tid; i < kBN * kChunksPerRow; i += kThreads) {
    const int n = i / kChunksPerRow, ch = i % kChunksPerRow;
    cp_async16(b_tile + n * Tile<T>::kStride + ch * kPerChunk,
               w + static_cast<int64_t>(n0 + n) * K + k0 + ch * kPerChunk);
  }
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16: warp (wm, wn) owns rows wm*64 + [0, 64) and columns wn*32 + [0, 32): 4 x 4 m16n8 fragments,
// accumulator (mi * 4 + ni) * 4 + e.
__device__ __forceinline__ void compute(const __nv_bfloat16* a_tile, const __nv_bfloat16* b_tile, float (&acc)[64],
                                        int tid) {
  constexpr int S = Tile<__nv_bfloat16>::kStride;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const __nv_bfloat16* p = a_tile + (wm * 64 + mi * 16 + g) * S + kk + t * 2;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * S);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * S + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* q = b_tile + (wn * 32 + ni * 8 + g) * S + kk + t * 2;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(q);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(q + 8);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc + (mi * 4 + ni) * 4, a[mi], b[ni]);
    }
  }
}

// fp32: thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j, accumulator i * 8 + j.
__device__ __forceinline__ void compute(const float* a_tile, const float* b_tile, float (&acc)[64], int tid) {
  constexpr int S = Tile<float>::kStride;
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll 4
  for (int k = 0; k < kBK; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = a_tile[(ty + 16 * i) * S + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = b_tile[(tx + 16 * j) * S + k];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(a[i], b[j], acc[i * 8 + j]);
    }
  }
}

__device__ __forceinline__ void epilogue(const float (&acc)[64], __nv_bfloat16* __restrict__ y, int m0, int n0,
                                         int m_total, int c_out, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + t * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        const float* c = acc + (mi * 4 + ni) * 4 + half * 2;
        if (row < m_total)
          *reinterpret_cast<__nv_bfloat162*>(y + static_cast<int64_t>(row) * c_out + col) =
              __floats2bfloat162_rn(c[0], c[1]);
      }
    }
  }
}

__device__ __forceinline__ void epilogue(const float (&acc)[64], float* __restrict__ y, int m0, int n0, int m_total,
                                         int c_out, int tid) {
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) y[static_cast<int64_t>(row) * c_out + n0 + tx + 16 * j] = acc[i * 8 + j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dcn_forward_kernel(const T* __restrict__ x, const T* __restrict__ om,
                                                               const T* __restrict__ w, T* __restrict__ y,
                                                               int m_total, int H, int W, int C, int c_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = Tile<T>::kStride;
  T* a_tiles = reinterpret_cast<T*>(smem);  // [2][kBM][S]
  T* b_tiles = a_tiles + 2 * kBM * S;       // [2][kBN][S]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = kTaps * C;
  const int steps_per_tap = C / kBK;
  const int steps = kTaps * steps_per_tap;
  const int cvec = (tid % kOcts) * kVec;
  int pix[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) pix[r] = m0 + tid / kOcts + r * kRowStep;
  Sample smp[kRowsPerThread];
  Gathered<T> g;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) tap_sample(om, pix[r], m_total, H, W, C, 0, smp[r]);
  load_b(w, b_tiles, n0, 0, K, tid);
  cp_async_commit();
  gather_load(x, smp, cvec, g);
  gather_store(g, smp, a_tiles, tid);

  for (int ks = 0; ks < steps; ++ks) {
    cp_async_wait_all();
    __syncthreads();  // step ks's tiles are in; step ks - 1's are no longer read
    const int buf = ks & 1;
    const bool more = ks + 1 < steps;
    if (more) {
      const int tap = (ks + 1) / steps_per_tap;
      const int c0 = (ks + 1 - tap * steps_per_tap) * kBK;
      if (c0 == 0) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) tap_sample(om, pix[r], m_total, H, W, C, tap, smp[r]);
      }
      load_b(w, b_tiles + (buf ^ 1) * kBN * S, n0, tap * C + c0, K, tid);
      cp_async_commit();
      gather_load(x, smp, c0 + cvec, g);
    }
    compute(a_tiles + buf * kBM * S, b_tiles + buf * kBN * S, acc, tid);
    if (more) gather_store(g, smp, a_tiles + (buf ^ 1) * kBM * S, tid);
  }
  epilogue(acc, y, m0, n0, m_total, c_out, tid);
}

template <typename T>
int launch(const void* x, const void* om, const void* w, void* y, int batch, int H, int W, int C, int c_out,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(dcn_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_total = batch * H * W;
  const dim3 grid((m_total + kBM - 1) / kBM, c_out / kBN);
  dcn_forward_kernel<T><<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x), static_cast<const T*>(om),
                                                           static_cast<const T*>(w), static_cast<T*>(y), m_total,
                                                           H, W, C, c_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ops/dcn.py::modulated_deform_conv checks the same limits first and raises with a message.
extern "C" int dcn_forward_launch(const void* x, const void* om, const void* w, void* y, int batch, int H, int W,
                                  int C, int c_out, int dtype, cudaStream_t stream) {
  if (batch <= 0 || H <= 0 || W <= 0) return 0;
  const int64_t widest = C > c_out ? (C > kOffsetChannels ? C : kOffsetChannels) : c_out;
  if (C <= 0 || C % kBK != 0 || c_out <= 0 || c_out % kBN != 0 || c_out / kBN > 65535 ||
      static_cast<int64_t>(batch) * H * W * widest > kMaxValues) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case kFloat32: return launch<float>(x, om, w, y, batch, H, W, C, c_out, stream);
    case kBFloat16: return launch<__nv_bfloat16>(x, om, w, y, batch, H, W, C, c_out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
