// int8 activation quantize and int8 x int8 -> int32 convolution for Hopper
// (sm_90a), the two device functions of the port's int8 serving path.
//
// Replaces no TPU kernel: the JAX package runs its quantized convolution as
// XLA's conv_general_dilated on int8 operands with int32 accumulation
// (rtm3d_tpu/nn/quant.py:254-262), and PyTorch has no int8 convolution on
// CUDA. The functions, as rtm3d_tpu/nn/quant.py::_quantized_conv computes
// them:
//   quantize:  xq[n, h, w, c] = clip(round_half_even(x[n, c, h, w] / s[c]), -127, 127)
//              for c < C, and 0 for C <= c < Cp (the channels the conv reads);
//   conv_s8:   acc[m, co] = sum_k A[m, k] * B[co, k] (int32, exact), an implicit
//              GEMM: m = (n, ho, wo), k = (r, c, ci), A[m, k] the input tap
//              xq[n, ho*s - p + r*d, wo*s - p + c*d, ci] (0 outside the frame),
//              B[co, k] = wq[co, r, c, ci]; then the epilogue
//              y[m, co] = float(acc) * out_scale[co] + bias[co], cast to the
//              input's type (fp32 or bf16).
// Both are bit-equal to rtm3d_tpu_torch/ops/int8_conv.py's plain versions:
// IEEE division (__fdiv_rn; build without --use_fast_math) and rounding to
// the nearest even (__float2int_rn) in quantize; integer sums are exact in
// any order; the epilogue rounds after the product and after the sum
// (__fmul_rn, __fadd_rn: no FMA contraction), as the plain version does.
//
// What bounds them on this card: quantize moves bytes (4 or 2 in, 1 out per
// element). conv_s8 at the main path's shapes is bound by int8 operations
// (2 * M * Cout * K against 1,979 TOP/s dense) for the 3x3 convs and by
// bytes for the 1x1s and the stem (ops/int8_conv.py::conv_s8_ops,
// ::conv_s8_bytes).
//
// Design (a first, simple kernel that is right; wgmma and TMA are later
// work):
// - A block of 128 threads (4 warps) computes a 128 x 64 tile of the output
//   (128 output pixels by 64 output channels), stepping over K 32 bytes at a
//   time. Each warp owns 64 x 32 of it: 4 x 4 tiles of
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, 64 int32 accumulators
//   a thread.
// - The A tile (128 pixels x 32 taps) and the B tile (64 channels x 32
//   taps) are staged in shared memory, rows 48 bytes apart so that the
//   fragment reads of a warp (8 rows x 4 words) fall in 32 distinct banks.
//   Two buffers: the next step's global loads are issued into registers
//   before the mma of this step and stored after it, one barrier a step.
// - The input is read in place from the NHWC int8 tensor quantize wrote
//   (channels padded to Cp). Each thread owns one output pixel of the tile
//   and decodes its (n, ho, wo) once. Where Cp % 16 == 0 a K chunk of 16
//   taps is one (r, c) and 16 contiguous channels: one 16-byte load. The
//   stem (Cp = 4) reads 4-byte quads. Weights are (Cout, Kp) rows, zero past
//   K = KH * KW * Cp, Kp a multiple of 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileM = 128;  // output pixels of a block
constexpr int kTileN = 64;   // output channels of a block
constexpr int kTileK = 32;   // taps (bytes) of one step, one mma deep
constexpr int kRow = 48;     // shared-memory row stride in bytes

struct ConvArgs {
  const int8_t* x;         // (N, H, W, Cp)
  const int8_t* w;         // (Cout, Kp)
  const float* out_scale;  // (Cout,)
  const float* bias;       // (Cout,) or null
  void* y;                 // (N, Ho, Wo, Cout)
  int n, h, w_in, cp, cout, kh, kw, stride, pad, dil, ho, wo, k, kp;
  int64_t m;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(256) quantize_kernel(const T* __restrict__ x, int64_t sn, int64_t sc,
                                                       int64_t sh, int64_t sw, int C, int H, int W,
                                                       const float* __restrict__ scale, int quads,
                                                       int64_t total, char4* __restrict__ out) {
  // one thread writes 4 consecutive output channels of one pixel
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = i / quads;
    const int q = static_cast<int>(i - p * quads);
    const int wi = static_cast<int>(p % W);
    const int64_t t = p / W;
    const int hi = static_cast<int>(t % H);
    const int64_t ni = t / H;
    const T* base = x + ni * sn + hi * sh + wi * sw;
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = q * 4 + j;
      int r = 0;
      if (c < C) {
        r = __float2int_rn(__fdiv_rn(to_float(base[c * sc]), scale[c]));
        r = min(max(r, -127), 127);
      }
      v[j] = r;
    }
    out[i] = make_char4(static_cast<signed char>(v[0]), static_cast<signed char>(v[1]),
                        static_cast<signed char>(v[2]), static_cast<signed char>(v[3]));
  }
}

__device__ __forceinline__ void mma_s8(int* c, const int* a, const int* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A and B chunks one thread loads for one step, in registers: its
// pixel's 32 taps (two 16-byte pieces, or 8 quads packed in two int4) and
// one 16-byte half of one channel's 32 weights.
struct Stage {
  int4 a[2];
  int4 b;
};

template <int kVec>
__device__ __forceinline__ void load_stage(const ConvArgs& p, int kt, bool m_ok, int64_t x_img,
                                           int hbase, int wbase, int64_t co, Stage& st,
                                           int b_half) {
  const int k_base = kt * kTileK;
  if (kVec == 16) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int k0 = k_base + v * 16;
      int4 val = make_int4(0, 0, 0, 0);
      if (m_ok && k0 < p.k) {
        const int rc = k0 / p.cp;
        const int ci = k0 - rc * p.cp;
        const int r = rc / p.kw;
        const int c = rc - r * p.kw;
        const int hi = hbase + r * p.dil;
        const int wi = wbase + c * p.dil;
        if (hi >= 0 && hi < p.h && wi >= 0 && wi < p.w_in) {
          val = *reinterpret_cast<const int4*>(
              p.x + x_img + (static_cast<int64_t>(hi) * p.w_in + wi) * p.cp + ci);
        }
      }
      st.a[v] = val;
    }
  } else {
    int quad[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k0 = k_base + q * 4;
      int val = 0;
      if (m_ok && k0 < p.k) {
        const int rc = k0 / p.cp;
        const int ci = k0 - rc * p.cp;
        const int r = rc / p.kw;
        const int c = rc - r * p.kw;
        const int hi = hbase + r * p.dil;
        const int wi = wbase + c * p.dil;
        if (hi >= 0 && hi < p.h && wi >= 0 && wi < p.w_in) {
          val = *reinterpret_cast<const int*>(
              p.x + x_img + (static_cast<int64_t>(hi) * p.w_in + wi) * p.cp + ci);
        }
      }
      quad[q] = val;
    }
    st.a[0] = make_int4(quad[0], quad[1], quad[2], quad[3]);
    st.a[1] = make_int4(quad[4], quad[5], quad[6], quad[7]);
  }
  int4 bv = make_int4(0, 0, 0, 0);
  if (co < p.cout) {
    bv = *reinterpret_cast<const int4*>(p.w + co * p.kp + k_base + b_half * 16);
  }
  st.b = bv;
}

template <int kVec, typename OutT>
__global__ void __launch_bounds__(kThreads) conv_s8_kernel(const ConvArgs p) {
  __shared__ __align__(16) int8_t smem_a[2][kTileM * kRow];
  __shared__ __align__(16) int8_t smem_b[2][kTileN * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 1, warp_n = warp & 1;

  // this thread's output pixel for the A loads
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kTileM + tid;
  const bool m_ok = m < p.m;
  int64_t x_img = 0;
  int hbase = 0, wbase = 0;
  if (m_ok) {
    const int wo = static_cast<int>(m % p.wo);
    const int64_t r = m / p.wo;
    const int ho = static_cast<int>(r % p.ho);
    const int64_t ni = r / p.ho;
    x_img = ni * p.h * p.w_in * p.cp;
    hbase = ho * p.stride - p.pad;
    wbase = wo * p.stride - p.pad;
  }
  // this thread's output channel and 16-byte half for the B loads
  const int b_row = tid >> 1, b_half = tid & 1;
  const int64_t co_load = static_cast<int64_t>(blockIdx.y) * kTileN + b_row;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = p.kp / kTileK;
  Stage st;
  auto put = [&](int buf) {
    int8_t* arow = smem_a[buf] + tid * kRow;
    *reinterpret_cast<int4*>(arow) = st.a[0];
    *reinterpret_cast<int4*>(arow + 16) = st.a[1];
    *reinterpret_cast<int4*>(smem_b[buf] + b_row * kRow + b_half * 16) = st.b;
  };
  load_stage<kVec>(p, 0, m_ok, x_img, hbase, wbase, co_load, st, b_half);
  put(0);
  __syncthreads();

  for (int kt = 0; kt < steps; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < steps) load_stage<kVec>(p, kt + 1, m_ok, x_img, hbase, wbase, co_load, st, b_half);
    const int8_t* As = smem_a[buf];
    const int8_t* Bs = smem_b[buf];
    int bf[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* brow = Bs + (warp_n * 32 + j * 8 + g) * kRow + t * 4;
      bf[j][0] = *reinterpret_cast<const int*>(brow);
      bf[j][1] = *reinterpret_cast<const int*>(brow + 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int8_t* arow = As + (warp_m * 64 + i * 16 + g) * kRow + t * 4;
      int af[4];
      af[0] = *reinterpret_cast<const int*>(arow);
      af[1] = *reinterpret_cast<const int*>(arow + 8 * kRow);
      af[2] = *reinterpret_cast<const int*>(arow + 16);
      af[3] = *reinterpret_cast<const int*>(arow + 8 * kRow + 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af, bf[j]);
    }
    if (kt + 1 < steps) put(buf ^ 1);
    __syncthreads();
  }

  // epilogue: c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g + 8
  OutT* y = static_cast<OutT*>(p.y);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int64_t co = static_cast<int64_t>(blockIdx.y) * kTileN + warp_n * 32 + j * 8 + t * 2 + e;
      if (co >= p.cout) continue;
      const float scale = p.out_scale[co];
      const float b = p.bias != nullptr ? p.bias[co] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int64_t row =
              static_cast<int64_t>(blockIdx.x) * kTileM + warp_m * 64 + i * 16 + g + half * 8;
          if (row >= p.m) continue;
          float v = __fmul_rn(__int2float_rn(acc[i][j][half * 2 + e]), scale);
          if (p.bias != nullptr) v = __fadd_rn(v, b);
          store(y + row * p.cout + co, v);
        }
      }
    }
  }
}

template <int kVec, typename OutT>
int launch_conv(const ConvArgs& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((p.m + kTileM - 1) / kTileM),
                  static_cast<unsigned>((p.cout + kTileN - 1) / kTileN));
  conv_s8_kernel<kVec, OutT><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// quantize: x a float (dtype 0) or bf16 (dtype 1) tensor (N, C, H, W) read
// through its element strides, scale (C,) float32, out (N, H, W, cp) int8
// contiguous, cp % 4 == 0 and cp >= C. Returns cudaGetLastError() as an int
// (0 = launched) or cudaErrorInvalidValue for arguments it does not take.
extern "C" int int8_quantize_launch(const void* x, int dtype, int64_t sn, int64_t sc, int64_t sh,
                                    int64_t sw, int n, int c, int h, int w, const float* scale,
                                    int cp, void* out, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  if (c <= 0 || cp < c || cp % 4 != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int quads = cp / 4;
  const int64_t total = static_cast<int64_t>(n) * h * w * quads;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  char4* o = static_cast<char4*>(out);
  if (dtype == 0) {
    quantize_kernel<float><<<blocks, threads, 0, stream>>>(static_cast<const float*>(x), sn, sc, sh, sw,
                                                           c, h, w, scale, quads, total, o);
  } else {
    quantize_kernel<__nv_bfloat16><<<blocks, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), sn, sc, sh, sw, c, h, w, scale, quads, total, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// conv_s8: x (N, H, W, cp) int8 contiguous, 16-byte aligned; w (cout, kp)
// int8, kp % 32 == 0 and kp >= kh * kw * cp, zero past kh * kw * cp;
// out_scale (cout,) float32; bias (cout,) float32 or null; y (N, ho, wo,
// cout) float32 (out_dtype 0) or bf16 (1). cp % 16 == 0 takes 16-byte loads,
// cp % 4 == 0 (the stem) 4-byte loads. Returns as int8_quantize_launch.
extern "C" int int8_conv_launch(const void* x, const void* w, const float* out_scale, const float* bias,
                                void* y, int out_dtype, int n, int h, int win, int cp, int cout, int kh,
                                int kw, int stride, int pad, int dil, int ho, int wo, int kp,
                                cudaStream_t stream) {
  ConvArgs p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out_scale = out_scale;
  p.bias = bias;
  p.y = y;
  p.n = n;
  p.h = h;
  p.w_in = win;
  p.cp = cp;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.dil = dil;
  p.ho = ho;
  p.wo = wo;
  p.k = kh * kw * cp;
  p.kp = kp;
  p.m = static_cast<int64_t>(n) * ho * wo;
  if (p.m == 0 || cout == 0) return 0;
  if (cp <= 0 || cp % 4 != 0 || kp % kTileK != 0 || kp < p.k || stride <= 0 || dil <= 0 || kh <= 0 ||
      kw <= 0 || (out_dtype != 0 && out_dtype != 1) ||
      (reinterpret_cast<uintptr_t>(x) % 16) != 0 || (reinterpret_cast<uintptr_t>(w) % 16) != 0 ||
      (p.m + kTileM - 1) / kTileM > 0x7fffffff || (cout + kTileN - 1) / kTileN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec16 = cp % 16 == 0;
  if (out_dtype == 0) {
    return vec16 ? launch_conv<16, float>(p, stream) : launch_conv<4, float>(p, stream);
  }
  return vec16 ? launch_conv<16, __nv_bfloat16>(p, stream) : launch_conv<4, __nv_bfloat16>(p, stream);
}
