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
// element). conv_s8 is bound by int8 operations (2 * M * Cout * K against
// 1,979 TOP/s dense) for the 3x3 convs at 64 channels and more, and by bytes
// for the 1x1s and the thin full-resolution convs, whose bf16 output
// outweighs their work (ops/int8_conv.py::conv_s8_ops, ::conv_s8_bytes).
//
// conv_s8's design:
// - Tensor cores through wgmma.mma_async m64nNk32.s32.s8.s8, A and B from
//   shared memory, both K-major (the only layout wgmma takes for s8), in
//   the 128-byte swizzle; int32 accumulators in registers.
// - A block of 384 threads: two consumer warpgroups, each 64 output pixels
//   by the N tile, and one producer warpgroup. A tile is 128 output pixels
//   by N output channels; N, the variant's N tile, is Cout rounded up to 16,
//   32, 64, 128 or 256, so a thin conv wastes no tensor core on channels it
//   does not have. For N 256 setmaxnreg moves registers from the producer
//   (56) to the consumers (224: 128 accumulators a thread).
// - Persistent blocks: as many as the card holds at once (one an SM at N 128
//   and 256, two at N 32 and 64, three at N 16), each walking the tiles
//   tile, tile + gridDim.x, ...; the producer runs ahead into the next tile
//   while the consumers write the last one out.
// - A ring in dynamic shared memory of 4 stages (3 at N 16 and 64, to keep
//   more blocks on an SM), each one K chunk of 128 bytes: the A tile (128
//   pixels x 128 bytes, 16 KB) and the B tile (N channels x 128 bytes), with
//   a full and an empty mbarrier a stage.
// - B, the packed weights (Cout, Kp), always comes by TMA from a 2-D tensor
//   map (box 128 x N, 128-byte swizzle; rows past Cout and bytes past Kp
//   fill with zeros).
// - A comes one of three ways, the variant's "load" (chosen from the shape
//   by ops/int8_conv.py::conv_variant and checked here again):
//   * tma: stride 1 and Cp % 128 == 0 (the header's and the backbone's wide
//     convs, 96% of the operations). A TMA tiled 4-D map over the NHWC int8
//     input fetches, for one tap (r, c) and 128 channels, a box of bh output
//     rows by bw output columns of one image at (ci0, wo0 - p + c*d,
//     ho0 - p + r*d, n). Coordinates outside the frame, negative ones
//     included, fill with zeros, so the padding and the dilated header's
//     6-pixel halo cost nothing. The tile is bh x bw = 128 output pixels
//     shaped to the output rows (bw 64 for Wo 320, 8 for Wo 40).
//   * gather16: Cp % 16 == 0 otherwise (stride 2, 16-64 channels, channel
//     counts such as 320 and 448). Each producer thread owns one output pixel
//     of the tile, decodes it once, and copies its 16-byte pieces of each K
//     chunk with cp.async (zero-filled outside the frame) into the swizzled
//     row wgmma reads; each piece's tap and channel come from a table in
//     shared memory, so the pieces' addresses do not chain.
//   * gather4: Cp % 4 == 0 otherwise (the 3-channel stem, padded to 4): as
//     gather16 with 4-byte pieces.
//   A gather thread arrives on the stage's full barrier through
//   cp.async.mbarrier.arrive, when its copies have landed; the consumers make
//   them visible to the tensor cores' async proxy (fence.proxy.async).
// - The last K chunk runs only the 32-byte steps up to Kp (Kp a multiple of
//   32, from ops/int8_conv.py::pack_weight); pieces past K are not gathered
//   (B is zero there).
// - The epilogue converts, scales and adds the bias in registers and stages
//   the tile in shared memory, 128 bytes of each row at a time (in the
//   128-byte swizzle, so the fragment stores hit distinct banks), in two
//   buffers; a TMA store writes each staged pass out while the next is
//   staged, the ragged M and Cout edges clipped by the tensor map. Where
//   Cout * itemsize % 16 != 0 (no tensor map can take the rows) the staged
//   tile goes out element by element.
// - A launch the card refuses (shared memory, a tensor map it cannot encode)
//   returns its error; ops/int8_conv.py raises RuntimeError on it.
//
// quantize's design: for the dense channels_last input every served conv
// gets (an NCHW view of NHWC memory, C % 16 == 0) the input is a (pixels, C)
// matrix; a thread owns 16 channels, holds their 16 scales in registers, and
// per pixel reads 32 or 64 bytes and writes one 16-byte store; no division
// of indices. Any other layout takes a strided path: a block row of pixels
// (n, h) from the grid, w from the thread, 4 channels a 4-byte store.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kTileM = 128;                 // output pixels of a block
constexpr int kChunk = 128;                 // K bytes of one ring stage
constexpr int kTileA = kTileM * kChunk;     // 16 KB
constexpr int kMaxPieces = 512;             // the gather's pieces of K it can take (its table's entries)

enum Load { kTma = 0, kGather16 = 1, kGather4 = 2 };

struct ConvArgs {
  const int8_t* x;         // (N, H, W, Cp)
  const float* out_scale;  // (Cout,)
  const float* bias;       // (Cout,) or null
  void* y;                 // (N, Ho, Wo, Cout)
  int load;
  int h, w_in, cp, cout, kh, kw, stride, pad, dil, ho, wo, kp, m;
  int bh, bw, tiles_h, tiles_w;  // tma: the M tile's output rows and columns
  int k_tiles;                   // K chunks: ceil(Kp / 128)
  int tiles_n, tiles;            // N tiles, and M tiles x N tiles (M tile = tile / tiles_n)
  int k;                         // KH * KW * Cp: the taps past it are not gathered
  int store_tma;                 // the epilogue writes by TMA (Cout * itemsize % 16 == 0)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, "
      "%6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// wait until at most N bulk stores of this thread still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// cp.async of 16 or 4 bytes; src_bytes 0 fills the destination with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// an arrival on the barrier once this thread's cp.async copies so far are
// done, counted among the arrivals the barrier was initialised to expect
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// shared memory written through the generic proxy (cp.async), seen by this
// thread, made visible to its async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(int* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row atoms 1024 bytes apart (stride byte offset 64 x 16), leading
// byte offset unused (1), layout type 1 (B128) in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// D (64 x N, int32) += A (64 x 32 s8) * B (N x 32 s8)^T; d holds the thread's
// N / 2 accumulators: d[4j + 2h + e] at row 16 * warp + lane / 4 + 8h,
// column 8j + 2 (lane % 4) + e
template <int N>
struct Mma;

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
          "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
          "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
          "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
          "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<256> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
          "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
          "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
          "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]),
          "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
          "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]),
          "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),
          "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]),
          "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]),
          "+r"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// Shared memory by N tile and output type: the ring of kStages stages (4;
// 3 at N 64 and N 16, which keeps two and three blocks on an SM: the thin
// full-resolution convs need the gather threads); two staging buffers of the
// output tile, kPass columns at a time (rows of 32, 64 or 128 bytes; 128 in
// the 128-byte swizzle), written out by TMA while the next pass is staged;
// the stage barriers; and the gather's table of its pieces' taps.
template <int BN, typename OutT>
struct Ring {
  static constexpr int kStages = (BN == 64 || BN == 16) ? 3 : 4;
  static constexpr int kStageBytes = kTileA + BN * kChunk;
  static constexpr int kEsize = static_cast<int>(sizeof(OutT));
  static constexpr int kPass = BN * kEsize < 128 ? BN : 128 / kEsize;
  static constexpr int kRowBytes = kPass * kEsize;
  static constexpr bool kSwizzled = kRowBytes == 128;
  static constexpr int kOutBytes = kTileM * kRowBytes;  // one staging buffer
  static constexpr int kBarriers = kStages * kStageBytes + 2 * kOutBytes;
  static constexpr int kTable = kBarriers + 2 * kStages * 8;
  static constexpr int kSmem = kTable + kMaxPieces * 4;
};

// the byte of a staging buffer that holds byte b of row ``row``: rows of
// kRowBytes, in the 128-byte swizzle (the TMA store's) when they are 128
template <typename R>
__device__ __forceinline__ int staged(int row, int b) {
  if (R::kSwizzled) return row * 128 + ((((b >> 4) ^ row) & 7) << 4) + (b & 15);
  return row * R::kRowBytes + b;
}

// the output pixel of row ``row`` of M tile ``m_idx``; false past the ragged M edge
__device__ __forceinline__ bool tile_pixel(const ConvArgs& p, int m_idx, int row, int64_t& pix) {
  if (p.load == kTma) {
    const int per_img = p.tiles_h * p.tiles_w;
    const int img = m_idx / per_img;
    const int t = m_idx - img * per_img;
    const int th = t / p.tiles_w;
    const int rr = row / p.bw;
    const int ho = th * p.bh + rr;
    const int wo = (t - th * p.tiles_w) * p.bw + (row - rr * p.bw);
    pix = (static_cast<int64_t>(img) * p.ho + ho) * p.wo + wo;
    return ho < p.ho && wo < p.wo;
  }
  const int m = m_idx * kTileM + row;
  pix = m;
  return m < p.m;
}

// The gather producer: each of the 128 threads owns one output pixel of
// the tile (row t), copies its pieces of each K chunk (PIECE bytes: 16 for
// Cp % 16 == 0, 4 for the stem) into the swizzled row wgmma reads, and
// arrives on the stage's full barrier when its copies have landed
// (cp.async.mbarrier.arrive), so it never waits for its own copies; thread
// 0 also brings the weights by TMA. Each piece's tap offsets and channel
// come from a table in shared memory the warpgroup fills once: the pieces'
// addresses are independent of each other, with no chain of increments.
template <int BN, typename OutT, int PIECE>
__device__ __forceinline__ void gather(const CUtensorMap* map_w, const ConvArgs& p, uint8_t* smem, uint32_t ring,
                                       uint32_t full, uint32_t empty) {
  using R = Ring<BN, OutT>;
  const int t = threadIdx.x - kConsumers;
  // piece e (K bytes e * PIECE on): r * dil (bits 24-31), c * dil (16-23), ci (0-15)
  uint32_t* table = reinterpret_cast<uint32_t*>(smem + R::kTable);
  const int pieces = (p.k + PIECE - 1) / PIECE;
  for (int e = t; e < pieces; e += 128) {
    const int k = e * PIECE, tap = k / p.cp, r = tap / p.kw;
    table[e] = (static_cast<uint32_t>(r * p.dil) << 24) | (static_cast<uint32_t>((tap - r * p.kw) * p.dil) << 16) |
               static_cast<uint32_t>(k - tap * p.cp);
  }
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
  const uint32_t a_row = t * kChunk;
  const int swz = t & 7;
  int g = 0;  // K chunks loaded over all the block's tiles: the ring's position
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m_idx = tile / p.tiles_n, n0 = (tile - m_idx * p.tiles_n) * BN;
    const int m = m_idx * kTileM + t;
    int hbase = -(1 << 20), wbase = 0;  // a pixel past M reads nothing
    const int8_t* img = p.x;
    if (m < p.m) {
      const int hw = p.ho * p.wo;
      const int ni = m / hw;
      const int rem = m - ni * hw;
      const int ho = rem / p.wo;
      hbase = ho * p.stride - p.pad;
      wbase = (rem - ho * p.wo) * p.stride - p.pad;
      img += ni * (p.h * p.w_in * p.cp);  // the wrapper keeps the input under 2^31 bytes
    }
    for (int kt = 0; kt < p.k_tiles; ++kt, ++g) {
      const int s = g % R::kStages;
      mbar_wait(empty + 8 * s, ((g / R::kStages) & 1) ^ 1);
      const uint32_t a = ring + s * R::kStageBytes + a_row;
      if (t == 0) {
        mbar_arrive_tx(full + 8 * s, BN * kChunk);
        tma_load_2d(ring + s * R::kStageBytes + kTileA, map_w, full + 8 * s, kt * kChunk, n0);
      }
      // pieces past K are not copied: B is zero there, so their products
      // are 0 whatever the stage holds
      const int e0 = kt * (kChunk / PIECE);
      const int n = min(kChunk / PIECE, pieces - e0);
#pragma unroll 8
      for (int q = 0; q < kChunk / PIECE; ++q) {
        if (q >= n) break;
        const uint32_t e = table[e0 + q];
        const int hi = hbase + static_cast<int>(e >> 24);
        const int wi = wbase + static_cast<int>((e >> 16) & 0xFF);
        const bool ok = static_cast<unsigned>(hi) < static_cast<unsigned>(p.h) &&
                        static_cast<unsigned>(wi) < static_cast<unsigned>(p.w_in);
        const int8_t* src = ok ? img + (hi * p.w_in + wi) * p.cp + static_cast<int>(e & 0xFFFF) : p.x;
        if (PIECE == 16) {
          cp_async16(a + ((q ^ swz) << 4), src, ok ? 16 : 0);
        } else {
          cp_async4(a + (((q >> 2) ^ swz) << 4) + ((q & 3) << 2), src, ok ? 4 : 0);
        }
      }
      cp_async_arrive(full + 8 * s);
    }
  }
}

// The producer warpgroup walks the block's tiles (tile, tile + gridDim.x,
// ...) and their K chunks; ``g`` counts the chunks over all of them, the
// ring's position. It runs ahead into the next tile while the consumers
// write the last one out.
template <int BN, typename OutT>
__device__ __forceinline__ void produce(const CUtensorMap* map_x, const CUtensorMap* map_w, const ConvArgs& p,
                                        uint8_t* smem, uint32_t ring, uint32_t full, uint32_t empty) {
  using R = Ring<BN, OutT>;
  const int t = threadIdx.x - kConsumers;
  int g = 0;
  if (p.load == kTma) {
    if (t != 0) return;
    const int per_img = p.tiles_h * p.tiles_w;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m_idx = tile / p.tiles_n, n0 = (tile - m_idx * p.tiles_n) * BN;
      const int img = m_idx / per_img;
      const int tt = m_idx - img * per_img;
      const int th = tt / p.tiles_w;
      const int ho0 = th * p.bh - p.pad, wo0 = (tt - th * p.tiles_w) * p.bw - p.pad;
      int r = 0, c = 0, ci = 0;  // the chunk's tap and first channel (Cp % 128 == 0: one tap a chunk)
      for (int kt = 0; kt < p.k_tiles; ++kt, ++g) {
        const int s = g % R::kStages;
        mbar_wait(empty + 8 * s, ((g / R::kStages) & 1) ^ 1);
        const uint32_t a = ring + s * R::kStageBytes;
        mbar_arrive_tx(full + 8 * s, R::kStageBytes);
        tma_load_4d(a, map_x, full + 8 * s, ci, wo0 + c * p.dil, ho0 + r * p.dil, img);
        tma_load_2d(a + kTileA, map_w, full + 8 * s, kt * kChunk, n0);
        ci += kChunk;
        if (ci == p.cp) {
          ci = 0;
          if (++c == p.kw) {
            c = 0;
            ++r;
          }
        }
      }
    }
    return;
  }
  if (p.load == kGather16) {
    gather<BN, OutT, 16>(map_w, p, smem, ring, full, empty);
  } else {
    gather<BN, OutT, 4>(map_w, p, smem, ring, full, empty);
  }
}

// The consumer warpgroups: per tile the K chunks' products into int32
// registers, then the epilogue through the staging buffer.
template <int BN, typename OutT>
__device__ __forceinline__ void consume(const CUtensorMap* map_y, const ConvArgs& p, uint8_t* smem, uint32_t full,
                                        uint32_t empty) {
  using R = Ring<BN, OutT>;
  constexpr int kEsize = static_cast<int>(sizeof(OutT));
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const uint32_t ring = smem_u32(smem);
  uint8_t* out = smem + R::kStages * R::kStageBytes;
  uint8_t* y = static_cast<uint8_t*>(p.y);
  const int row0 = wg * 64 + warp * 16 + (lane >> 2);
  int g = 0, pg = 0;  // K chunks and output passes over the block's tiles
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m_idx = tile / p.tiles_n, n0 = (tile - m_idx * p.tiles_n) * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_regs<BN / 2>(acc);
    for (int kt = 0; kt < p.k_tiles; ++kt, ++g) {
      const int s = g % R::kStages;
      mbar_wait(full + 8 * s, (g / R::kStages) & 1);
      if (p.load != kTma) fence_proxy_async();  // the gather's cp.async writes, for wgmma
      const uint32_t a = ring + s * R::kStageBytes + wg * (64 * kChunk);
      const uint32_t b = ring + s * R::kStageBytes + kTileA;
      const int left = p.kp - kt * kChunk;  // K bytes from this chunk on: a whole chunk, or the last 32-96
      wgmma_fence();
      if (left >= kChunk) {
#pragma unroll
        for (int ks = 0; ks < kChunk / 32; ++ks) Mma<BN>::run(acc, sw128_desc(a + 32 * ks), sw128_desc(b + 32 * ks));
      } else {
#pragma unroll
        for (int ks = 0; ks < kChunk / 32 - 1; ++ks) {
          if (32 * ks < left) Mma<BN>::run(acc, sw128_desc(a + 32 * ks), sw128_desc(b + 32 * ks));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: release its stage
      if (kt > 0) mbar_arrive(empty + 8 * ((g - 1) % R::kStages));
    }
    wgmma_wait<0>();
    mbar_arrive(empty + 8 * ((g - 1) % R::kStages));
    fence_regs<BN / 2>(acc);

    // the tile's origin for the TMA store: (column, pixel) or (column, wo, ho, image)
    int o1 = m_idx * kTileM, o2 = 0, o3 = 0;
    if (p.load == kTma) {
      const int per_img = p.tiles_h * p.tiles_w;
      o3 = m_idx / per_img;
      const int tt = m_idx - o3 * per_img;
      o2 = tt / p.tiles_w;
      o1 = (tt - o2 * p.tiles_w) * p.bw;
      o2 *= p.bh;
    }
#pragma unroll
    for (int c0 = 0; c0 < BN; c0 += R::kPass) {
      if (n0 + c0 >= p.cout) break;
      uint8_t* buf = out + (pg & 1) * R::kOutBytes;
      // the store that last read this buffer, two passes ago, is done with it
      if (tid == 0) bulk_wait_read<1>();
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
      for (int j = c0 / 8; j < (c0 + R::kPass) / 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        const int co = n0 + col;
        float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
        if (co < p.cout) {
          s0 = p.out_scale[co];
          if (p.bias != nullptr) b0 = p.bias[co];
        }
        if (co + 1 < p.cout) {
          s1 = p.out_scale[co + 1];
          if (p.bias != nullptr) b1 = p.bias[co + 1];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s0);
          float v1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s1);
          if (p.bias != nullptr) {
            v0 = __fadd_rn(v0, b0);
            v1 = __fadd_rn(v1, b1);
          }
          store2(reinterpret_cast<OutT*>(buf + staged<R>(row0 + 8 * h, (col - c0) * kEsize)), v0, v1);
        }
      }
      fence_proxy_async();  // the staged tile, for the TMA store's reads
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      if (p.store_tma) {
        if (tid == 0) {
          if (p.load == kTma) {
            tma_store_4d(map_y, smem_u32(buf), n0 + c0, o1, o2, o3);
          } else {
            tma_store_2d(map_y, smem_u32(buf), n0 + c0, o1);
          }
          bulk_commit();
        }
      } else {  // rows not 16-byte multiples: element by element
        const int nv = min(R::kPass, p.cout - n0 - c0);
        for (int i = tid; i < kTileM * nv; i += kConsumers) {
          const int row = i / nv, col = i - row * nv;
          int64_t pix;
          if (!tile_pixel(p, m_idx, row, pix)) continue;
          *reinterpret_cast<OutT*>(y + (pix * p.cout + n0 + c0 + col) * kEsize) =
              *reinterpret_cast<const OutT*>(buf + staged<R>(row, col * kEsize));
        }
      }
      ++pg;
    }
  }
  if (tid == 0) bulk_wait_read<0>();  // shared memory stays until the last store has read it
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, BN == 16 ? 3 : (BN <= 64 ? 2 : 1))
    conv_s8_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_y, const ConvArgs p) {
  using R = Ring<BN, OutT>;
  // the ring and the swizzled staging buffers need 1024-byte alignment (the
  // swizzle works on address bits 4-9); dynamic shared memory starts there
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + R::kBarriers;
  const uint32_t empty = full + 8 * R::kStages;
  if (threadIdx.x == 0) {
    if (ring & 1023) __trap();
    for (int s = 0; s < R::kStages; ++s) {
      // tma: one arrival with the bytes; gather: each producer thread's
      // copies, and thread 0 once more with the weights' bytes
      mbar_init(full + 8 * s, p.load == kTma ? 1 : 129);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (BN == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    produce<BN, OutT>(&map_x, &map_w, p, smem, ring, full, empty);
  } else {
    if (BN == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    consume<BN, OutT>(&map_y, p, smem, full, empty);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a tiled map; 0 or the encoder's error
int encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int BN, typename OutT>
int launch_conv(ConvArgs& p, const void* w, cudaStream_t stream) {
  // per device, once: the shared memory attribute and the blocks one SM holds
  static int blocks[64] = {};
  constexpr int smem = Ring<BN, OutT>::kSmem;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (blocks[dev] == 0) {
    err = cudaFuncSetAttribute(conv_s8_kernel<BN, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_s8_kernel<BN, OutT>, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    blocks[dev] = sms * per_sm;
  }
  using R = Ring<BN, OutT>;
  const CUtensorMapDataType out_type =
      sizeof(OutT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle out_swizzle = R::kSwizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const cuuint64_t es = sizeof(OutT);
  p.store_tma = (static_cast<cuuint64_t>(p.cout) * es) % 16 == 0;
  CUtensorMap map_x, map_w, map_y;
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.kp), static_cast<cuuint64_t>(p.cout)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.kp)};
    const cuuint32_t box[2] = {kChunk, BN};
    const int e = encode_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != 0) return e;
  }
  map_y = map_w;  // unread unless store_tma
  int tiles_m;
  if (p.load == kTma) {
    const int n = p.m / (p.ho * p.wo);
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.cp), static_cast<cuuint64_t>(p.w_in),
                                static_cast<cuuint64_t>(p.h), static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(p.cp), static_cast<cuuint64_t>(p.w_in) * p.cp,
                                   static_cast<cuuint64_t>(p.h) * p.w_in * p.cp};
    const cuuint32_t box[4] = {kChunk, static_cast<cuuint32_t>(p.bw), static_cast<cuuint32_t>(p.bh), 1};
    int e = encode_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != 0) return e;
    if (p.store_tma) {
      const cuuint64_t ydims[4] = {static_cast<cuuint64_t>(p.cout), static_cast<cuuint64_t>(p.wo),
                                   static_cast<cuuint64_t>(p.ho), static_cast<cuuint64_t>(n)};
      const cuuint64_t ystrides[3] = {p.cout * es, p.wo * p.cout * es, static_cast<cuuint64_t>(p.ho) * p.wo * p.cout * es};
      const cuuint32_t ybox[4] = {static_cast<cuuint32_t>(R::kPass), static_cast<cuuint32_t>(p.bw),
                                  static_cast<cuuint32_t>(p.bh), 1};
      e = encode_map(&map_y, out_type, p.y, 4, ydims, ystrides, ybox, out_swizzle);
      if (e != 0) return e;
    }
    tiles_m = n * p.tiles_h * p.tiles_w;
  } else {
    map_x = map_w;  // unread
    if (p.store_tma) {
      const cuuint64_t ydims[2] = {static_cast<cuuint64_t>(p.cout), static_cast<cuuint64_t>(p.m)};
      const cuuint64_t ystrides[1] = {p.cout * es};
      const cuuint32_t ybox[2] = {static_cast<cuuint32_t>(R::kPass), kTileM};
      const int e = encode_map(&map_y, out_type, p.y, 2, ydims, ystrides, ybox, out_swizzle);
      if (e != 0) return e;
    }
    tiles_m = (p.m + kTileM - 1) / kTileM;
  }
  p.tiles_n = (p.cout + BN - 1) / BN;
  const int64_t tiles = static_cast<int64_t>(tiles_m) * p.tiles_n;
  if (tiles >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  // persistent blocks: as many as the card holds at once, each walking its tiles
  const unsigned grid = static_cast<unsigned>(tiles < blocks[dev] ? tiles : blocks[dev]);
  conv_s8_kernel<BN, OutT><<<grid, kThreads, smem, stream>>>(map_x, map_w, map_y, p);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  const __nv_bfloat162* h0 = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* h1 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f0 = __bfloat1622float2(h0[i]);
    const float2 f1 = __bfloat1622float2(h1[i]);
    v[2 * i] = f0.x;
    v[2 * i + 1] = f0.y;
    v[8 + 2 * i] = f1.x;
    v[8 + 2 * i + 1] = f1.y;
  }
}

__device__ __forceinline__ void load16(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int quantize_one(float x, float s) {
  return min(max(__float2int_rn(__fdiv_rn(x, s)), -127), 127);
}

// dense channels_last input as (P, C) rows, C % 16 == 0: threadIdx.x is a
// group of 16 channels (blockDim.x == C / 16), threadIdx.y and the grid
// stride walk the pixels
template <typename T>
__global__ void __launch_bounds__(256) quantize_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                                            int c, int64_t pixels, int8_t* __restrict__ out) {
  const int c0 = threadIdx.x * 16;
  float s[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(scale + c0) + i);
    s[4 * i] = f.x;
    s[4 * i + 1] = f.y;
    s[4 * i + 2] = f.z;
    s[4 * i + 3] = f.w;
  }
  for (int64_t px = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y; px < pixels;
       px += static_cast<int64_t>(gridDim.x) * blockDim.y) {
    float v[16];
    load16(x + px * c + c0, v);
    uint32_t packed[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        word |= (static_cast<uint32_t>(quantize_one(v[4 * i + j], s[4 * i + j])) & 0xFFu) << (8 * j);
      }
      packed[i] = word;
    }
    *reinterpret_cast<uint4*>(out + px * c + c0) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// any strides: blockIdx.z = n, blockIdx.y = h, the thread's w; 4 channels a store
template <typename T>
__global__ void __launch_bounds__(256) quantize_strided_kernel(const T* __restrict__ x, int64_t sn, int64_t sc,
                                                               int64_t sh, int64_t sw, int c, int h, int w,
                                                               const float* __restrict__ scale, int cp,
                                                               char4* __restrict__ out) {
  const int wi = blockIdx.x * blockDim.x + threadIdx.x;
  if (wi >= w) return;
  const int hi = blockIdx.y, ni = blockIdx.z;
  const T* base = x + ni * sn + hi * sh + wi * sw;
  char4* o = out + ((static_cast<int64_t>(ni) * h + hi) * w + wi) * (cp / 4);
  for (int q = 0; q < cp / 4; ++q) {
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = q * 4 + j;
      v[j] = ch < c ? quantize_one(to_float(base[ch * sc]), scale[ch]) : 0;
    }
    o[q] = make_char4(static_cast<signed char>(v[0]), static_cast<signed char>(v[1]), static_cast<signed char>(v[2]),
                      static_cast<signed char>(v[3]));
  }
}

template <typename T>
int launch_quantize(const T* x, int64_t sn, int64_t sc, int64_t sh, int64_t sw, int n, int c, int h, int w,
                    const float* scale, int cp, int8_t* out, cudaStream_t stream) {
  const int64_t pixels = static_cast<int64_t>(n) * h * w;
  // pixel (n, h, w) at ((n * H + h) * W + w) * C, channels contiguous (a size-1 dimension's stride is free)
  const bool dense = cp == c && c % 16 == 0 && c / 16 <= 256 && sc == 1 && (w == 1 || sw == c) &&
                     (h == 1 || sh == static_cast<int64_t>(w) * c) && (n == 1 || sn == static_cast<int64_t>(h) * w * c) &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  if (dense) {
    const int gx = c / 16;
    const int gy = 256 / gx > 0 ? 256 / gx : 1;
    const int64_t want = (pixels + gy - 1) / gy;
    const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
    quantize_rows_kernel<T><<<blocks, dim3(gx, gy), 0, stream>>>(x, scale, c, pixels, out);
  } else {
    if (h > 65535 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>((w + 127) / 128), h, n);
    quantize_strided_kernel<T><<<grid, 128, 0, stream>>>(x, sn, sc, sh, sw, c, h, w, scale, cp,
                                                         reinterpret_cast<char4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch(int bn, ConvArgs& p, const void* w, cudaStream_t stream) {
  switch (bn) {
    case 16:
      return launch_conv<16, OutT>(p, w, stream);
    case 32:
      return launch_conv<32, OutT>(p, w, stream);
    case 64:
      return launch_conv<64, OutT>(p, w, stream);
    case 128:
      return launch_conv<128, OutT>(p, w, stream);
    default:
      return launch_conv<256, OutT>(p, w, stream);
  }
}

template <typename OutT>
int smem_of(int bn) {
  switch (bn) {
    case 16:
      return Ring<16, OutT>::kSmem;
    case 32:
      return Ring<32, OutT>::kSmem;
    case 64:
      return Ring<64, OutT>::kSmem;
    case 128:
      return Ring<128, OutT>::kSmem;
    case 256:
      return Ring<256, OutT>::kSmem;
    default:
      return -1;
  }
}

}  // namespace

// quantize: x a float (dtype 0) or bf16 (dtype 1) tensor (N, C, H, W) read
// through its element strides, scale (C,) float32, out (N, H, W, cp) int8
// contiguous, cp % 4 == 0 and cp >= C. Returns cudaGetLastError() as an int
// (0 = launched) or cudaErrorInvalidValue for arguments it does not take.
extern "C" int int8_quantize_launch(const void* x, int dtype, int64_t sn, int64_t sc, int64_t sh, int64_t sw, int n,
                                    int c, int h, int w, const float* scale, int cp, void* out, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  if (c <= 0 || cp < c || cp % 4 != 0 || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int8_t* o = static_cast<int8_t*>(out);
  if (dtype == 0) return launch_quantize(static_cast<const float*>(x), sn, sc, sh, sw, n, c, h, w, scale, cp, o, stream);
  return launch_quantize(static_cast<const __nv_bfloat16*>(x), sn, sc, sh, sw, n, c, h, w, scale, cp, o, stream);
}

// conv_s8: x (N, H, W, cp) int8 contiguous, 16-byte aligned, N * H * W * cp
// < 2^31; w (cout, kp) int8, kp % 32 == 0 and kp >= kh * kw * cp, zero past
// kh * kw * cp; out_scale (cout,) float32; bias (cout,) float32 or null; y
// (N, ho, wo, cout) float32 (out_dtype 0) or bf16 (1), 16-byte aligned. The
// variant (ops/int8_conv.py::conv_variant): load 0 (tma: stride 1, cp % 128
// == 0, kp == kh * kw * cp, bh * bw == 128), 1 (gather16: cp % 16 == 0) or 2
// (gather4), a gather of at most kMaxPieces pieces of K with taps under 256
// apart; bn the N tile (16, 32, 64, 128 or 256). Returns as
// int8_quantize_launch; a variant that does not fit the shape is
// cudaErrorInvalidValue.
extern "C" int int8_conv_launch(const void* x, const void* w, const float* out_scale, const float* bias, void* y,
                                int out_dtype, int n, int h, int win, int cp, int cout, int kh, int kw, int stride,
                                int pad, int dil, int ho, int wo, int kp, int load, int bn, int bh, int bw,
                                cudaStream_t stream) {
  ConvArgs p;
  p.x = static_cast<const int8_t*>(x);
  p.out_scale = out_scale;
  p.bias = bias;
  p.y = y;
  p.load = load;
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
  p.kp = kp;
  const int64_t m = static_cast<int64_t>(n) * ho * wo;
  if (m == 0 || cout == 0) return 0;
  const int64_t k = static_cast<int64_t>(kh) * kw * cp;
  const bool fits =
      n > 0 && h > 0 && win > 0 && ho > 0 && wo > 0 && cp > 0 && cp % 4 == 0 && kp % 32 == 0 && kp >= k &&
      stride > 0 && dil > 0 && kh > 0 && kw > 0 && pad >= 0 && (out_dtype == 0 || out_dtype == 1) &&
      static_cast<int64_t>(n) * h * win * cp < (int64_t(1) << 31) && m < (int64_t(1) << 31) &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0 && (bn == 16 || bn == 32 || bn == 64 || bn == 128 || bn == 256) &&
      (cout + bn - 1) / bn <= 65535 &&
      ((load == kTma && stride == 1 && cp % kChunk == 0 && kp == k && bh > 0 && bw > 0 && bh * bw == kTileM) ||
       (((load == kGather16 && cp % 16 == 0) || load == kGather4) &&
        (k + (load == kGather16 ? 15 : 3)) / (load == kGather16 ? 16 : 4) <= kMaxPieces && (kh - 1) * dil < 256 &&
        (kw - 1) * dil < 256 && cp < 65536));
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  p.m = static_cast<int>(m);
  p.k = static_cast<int>(k);
  p.k_tiles = (kp + kChunk - 1) / kChunk;
  p.bh = load == kTma ? bh : 1;
  p.bw = load == kTma ? bw : kTileM;
  p.tiles_h = (ho + p.bh - 1) / p.bh;
  p.tiles_w = (wo + p.bw - 1) / p.bw;
  return out_dtype == 0 ? launch<float>(bn, p, w, stream) : launch<__nv_bfloat16>(bn, p, w, stream);
}

// the dynamic shared memory of the conv kernel with N tile bn, for the
// wrapper's variant record
extern "C" int int8_conv_smem_bytes(int bn, int out_dtype) {
  return out_dtype == 0 ? smem_of<float>(bn) : smem_of<__nv_bfloat16>(bn);
}
