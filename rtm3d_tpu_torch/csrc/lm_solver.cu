// Levenberg-Marquardt 3D box recovery for Hopper (sm_90a): one thread per
// detection, the whole fixed-iteration loop in one launch.
//
// Replaces rtm3d_tpu/ops/lm_solver.py::_lm_kernel (the Pallas TPU kernel
// launched by lm_solve_pallas). Same objective and update as that kernel and
// as decode/solve3d.py::_lm_batch: the reprojection residuals of the 8 box
// corners with the z + 1e-4 guard, the closed-form 16x8 Jacobian, J^T J and
// J^T r plus the optional dimension prior, damping A_pp(1+lambda)+1e-9, an
// unpivoted 8x8 Gauss-Jordan solve, accept-if-better, lambda x0.33 (floor
// 1e-9) or x3 (cap 1e6). Returns x and the pure reprojection cost.
//
// What bounds it: fp32 arithmetic on the CUDA cores. Each detection costs
// about 2.2k operations per iteration (counted term by term in
// rtm3d_tpu_torch/ops/lm_solver.py::lm_flops) against 148 bytes of input and
// output for the whole solve, so the card's fp32 rate, not its memory, is
// the bound.
//
// Design, right before fast:
// - One thread per detection. x, lambda, the cost, the 16 targets and the
//   8x8 normal equations live in registers; the iteration loop runs in the
//   kernel. Every loop over corners, parameters and the elimination is
//   unrolled with compile-time indices, so A never leaves registers and the
//   Jacobian's structural zeros cost nothing.
// - Inputs are structure-of-arrays (uv (16,M), x0 (8,M), kp (4,M)), so
//   neighbouring threads load neighbouring addresses.
// - The ragged edge is bounds-checked: no pad lanes (the TPU kernel needed
//   finite pad lanes, lm_solver.py:163-169).
// - fp32 throughout with IEEE division: build without --use_fast_math.
//   Reduced precision in the normal equations strands the solver at cost
//   ~1e3 (rtm3d_tpu/decode/solve3d.py:144-147). nvcc's default FMA
//   contraction rounds differently from the CPU, so agreement with the plain
//   version is judged with a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kZGuard = 1e-4f;  // aimFun's additive z guard
constexpr int kThreads = 128;

// corner sign pattern * 0.5 (solve3d.COR): x ++++----, y ++--++--, z +-+-+-+-
__device__ __forceinline__ float sign_x(int j) { return j < 4 ? 0.5f : -0.5f; }
__device__ __forceinline__ float sign_y(int j) { return (j & 3) < 2 ? 0.5f : -0.5f; }
__device__ __forceinline__ float sign_z(int j) { return (j & 1) == 0 ? 0.5f : -0.5f; }

// Which Jacobian entries are not structurally zero, bit p for parameter p of
// [s, c, l, h, w, X, Y, Z]: du/dh = du/dY = 0, dv/dX = 0.
constexpr unsigned kJuNonzero = 0xB7u;  // p = 0, 1, 2, 4, 5, 7
constexpr unsigned kJvNonzero = 0xDFu;  // p = 0, 1, 2, 3, 4, 6, 7

struct Camera {
  float fx, fy, cx, cy;
};

// Sum of squared pixel residuals of the 8 projected corners.
__device__ __forceinline__ float reproj_cost(const float (&x)[8], const float (&u)[8],
                                             const float (&v)[8], const Camera& cam) {
  const float lc = x[2] * x[1], ws = x[4] * x[0], ls = x[2] * x[0], wc = x[4] * x[1];
  float cost = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float a = sign_x(j), bc = sign_y(j), b = sign_z(j);
    const float xc = a * lc + b * ws + x[5];
    const float yc = bc * x[3] + x[6];
    const float z = -a * ls + b * wc + x[7] + kZGuard;
    const float ru = cam.fx * xc / z + cam.cx - u[j];
    const float rv = cam.fy * yc / z + cam.cy - v[j];
    cost += ru * ru + rv * rv;
  }
  return cost;
}

__device__ __forceinline__ float total_cost(const float (&x)[8], const float (&u)[8],
                                            const float (&v)[8], const Camera& cam,
                                            const float (&dim0)[3], float prior_weight) {
  float c = reproj_cost(x, u, v, cam);
  if (prior_weight > 0.f) {
    float p = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d = x[2 + k] - dim0[k];
      p += d * d;
    }
    c += prior_weight * p;
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
lm_kernel(const float* __restrict__ uv, const float* __restrict__ x0,
          const float* __restrict__ kp, float* __restrict__ x_out,
          float* __restrict__ cost_out, int64_t m, int iters, float lam0,
          float prior_weight) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;

  float u[8], v[8], x[8], dim0[3];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u[j] = uv[j * m + i];
    v[j] = uv[(8 + j) * m + i];
    x[j] = x0[j * m + i];
  }
  const Camera cam{kp[i], kp[m + i], kp[2 * m + i], kp[3 * m + i]};
#pragma unroll
  for (int k = 0; k < 3; ++k) dim0[k] = x[2 + k];  // per-class prior == init dims

  float lam = lam0;
  float cost = total_cost(x, u, v, cam, dim0, prior_weight);

  for (int it = 0; it < iters; ++it) {
    // normal equations A = J^T J (upper triangle first), g = J^T r
    float A[8][8], g[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      g[p] = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) A[p][q] = 0.f;
    }
    const float s = x[0], c = x[1], l = x[2], h = x[3], w = x[4];
    const float lc = l * c, ws = w * s, ls = l * s, wc = w * c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = sign_x(j), bc = sign_y(j), b = sign_z(j);
      const float xc = a * lc + b * ws + x[5];
      const float yc = bc * h + x[6];
      const float z = -a * ls + b * wc + x[7] + kZGuard;
      const float ru = cam.fx * xc / z + cam.cx - u[j];
      const float rv = cam.fy * yc / z + cam.cy - v[j];
      const float iz = 1.f / z;
      const float pu = xc * iz, pv = yc * iz;
      const float fxz = cam.fx * iz, fyz = cam.fy * iz;
      const float a_l = a * l, b_w = b * w, a_c = a * c, a_s = a * s, b_s = b * s, b_c = b * c;
      // J[p] = f * (d(xc|yc)/dp - d(zc)/dp * (xc|yc)/z) / z
      float Ju[8], Jv[8];
      Ju[0] = fxz * (b_w + a_l * pu);
      Ju[1] = fxz * (a_l - b_w * pu);
      Ju[2] = fxz * (a_c + a_s * pu);
      Ju[3] = 0.f;
      Ju[4] = fxz * (b_s - b_c * pu);
      Ju[5] = fxz;
      Ju[6] = 0.f;
      Ju[7] = -fxz * pu;
      Jv[0] = fyz * (a_l * pv);
      Jv[1] = -fyz * (b_w * pv);
      Jv[2] = fyz * (a_s * pv);
      Jv[3] = fyz * bc;
      Jv[4] = -fyz * (b_c * pv);
      Jv[5] = 0.f;
      Jv[6] = fyz;
      Jv[7] = -fyz * pv;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if ((kJuNonzero >> p) & 1u) g[p] += Ju[p] * ru;
        if ((kJvNonzero >> p) & 1u) g[p] += Jv[p] * rv;
#pragma unroll
        for (int q = p; q < 8; ++q) {
          if ((kJuNonzero >> p) & (kJuNonzero >> q) & 1u) A[p][q] += Ju[p] * Ju[q];
          if ((kJvNonzero >> p) & (kJvNonzero >> q) & 1u) A[p][q] += Jv[p] * Jv[q];
        }
      }
    }
    if (prior_weight > 0.f) {
      // dimension prior: selector rows add w on the (l, h, w) diagonal and
      // w * (dim - dim0) to the gradient
#pragma unroll
      for (int p = 2; p < 5; ++p) {
        A[p][p] += prior_weight;
        g[p] += prior_weight * (x[p] - dim0[p - 2]);
      }
    }
    const float damp = 1.f + lam;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      A[p][p] = A[p][p] * damp + 1e-9f;
#pragma unroll
      for (int q = p + 1; q < 8; ++q) A[q][p] = A[p][q];
    }

    // Gauss-Jordan without pivoting (A is damped SPD). Columns <= k are
    // never read after step k, so only columns > k are updated.
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float piv = A[k][k];
      const float inv = 1.f / (fabsf(piv) > 1e-12f ? piv : 1e-12f);
#pragma unroll
      for (int j = k + 1; j < 8; ++j) A[k][j] *= inv;
      g[k] *= inv;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r == k) continue;
        const float coef = A[r][k];
#pragma unroll
        for (int j = k + 1; j < 8; ++j) A[r][j] -= coef * A[k][j];
        g[r] -= coef * g[k];
      }
    }

    float x_new[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) x_new[p] = x[p] - g[p];
    const float cost_new = total_cost(x_new, u, v, cam, dim0, prior_weight);
    if (cost_new < cost) {  // false for NaN: a NaN step is rejected
#pragma unroll
      for (int p = 0; p < 8; ++p) x[p] = x_new[p];
      cost = cost_new;
      lam = fmaxf(lam * 0.33f, 1e-9f);
    } else {
      lam = fminf(lam * 3.f, 1e6f);
    }
  }

#pragma unroll
  for (int p = 0; p < 8; ++p) x_out[p * m + i] = x[p];
  cost_out[i] = reproj_cost(x, u, v, cam);  // acceptance stays reprojection-only
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() as an int (0 = launched).
extern "C" int lm_solve_launch(const float* uv, const float* x0, const float* kp,
                               float* x_out, float* cost_out, int64_t m, int iters,
                               float lam0, float prior_weight, cudaStream_t stream) {
  if (m <= 0) return 0;
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  lm_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      uv, x0, kp, x_out, cost_out, m, iters, lam0, prior_weight);
  return static_cast<int>(cudaGetLastError());
}
