// Levenberg-Marquardt 3D box recovery for Hopper (sm_90a): one thread per
// detection, the whole fixed-iteration loop in one launch.
//
// Replaces rtm3d_tpu/ops/lm_solver.py::_lm_kernel (the Pallas TPU kernel
// launched by lm_solve_pallas). Same objective and update as that kernel and
// as decode/solve3d.py::_lm_batch: the reprojection residuals of the 8 box
// corners with the z + 1e-4 guard, the closed-form 16x8 Jacobian, J^T J and
// J^T r plus the optional dimension prior, damping A_pp(1+lambda)+1e-9, an
// unpivoted solve of the damped 8x8 system, accept-if-better, lambda x0.33
// (floor 1e-9) or x3 (cap 1e6). Returns x and the pure reprojection cost.
//
// What bounds it: fp32 arithmetic on the CUDA cores. Each detection costs
// about 1k operations per iteration (counted term by term from this file
// in rtm3d_tpu_torch/ops/lm_solver.py::lm_flops) against 148 bytes of input
// and output for the whole solve, so the card's fp32 rate, not its memory,
// is the bound. At the detect path's sizes (25,600 and 38,400 detections)
// every warp is resident at once and the time follows the instructions a
// detection needs, so the design spends as few as it can.
//
// Design:
// - One thread per detection, in the grid ops/lm_solver.py::
//   lm_launch_geometry gives; this file checks that it covers M. Splitting a
//   detection's corners over 2 or 4 lanes of a warp, with shuffle sums and a
//   redundant solve, measured slower at every block size (PERF.md): the
//   kernel is bound by issue, not latency, and more lanes add instructions.
//   A thread's answer depends on its own detection's inputs alone.
// - One projection per corner and iteration. The trial point's projections
//   (1/z and the normalised image point) are kept and become the next
//   iteration's when the step is accepted; a rejected step keeps the old
//   ones. The normal equations never project again, and a pair of corners
//   that share their depth costs one IEEE reciprocal an iteration.
// - The normal equations come from 27 moment sums over the corners instead
//   of the 13-entry Jacobian and its 62 products per corner (see Moment
//   below): 85 operations a corner pair and 167 to assemble A and g, where
//   the Jacobian took 159 a corner.
// - The solve eliminates on the upper triangle only (A is symmetric and,
//   damped, positive definite, which the unpivoted elimination already
//   assumed) and back-substitutes: 8 reciprocals and 316 other operations
//   where Gauss-Jordan took 8 divisions and 540 (lm_flops' count). Its
//   pivots are Gauss-Jordan's, with the same guard.
// - x, lambda, the cost, the targets, the projections, the sums and A stay
//   in registers; every loop over corners, parameters and the elimination
//   is unrolled with compile-time indices, so structural zeros cost
//   nothing. Inputs are structure-of-arrays (uv (16,M), x0 (8,M), kp (4,M)),
//   so neighbouring threads load neighbouring addresses.
// - fp32 throughout with IEEE reciprocals: build without --use_fast_math.
//   Reduced precision in the normal equations strands the solver at cost
//   ~1e3 (rtm3d_tpu/decode/solve3d.py:144-147). The reciprocal, FMA
//   contraction and the order of the sums round differently from the plain
//   version, so agreement with it is judged with a tolerance, not bit for
//   bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kZGuard = 1e-4f;  // aimFun's additive z guard
constexpr int kMaxThreads = 256;
constexpr int kPairs = 4;  // corner pairs that share a depth

// Corner j of solve3d.COR has signs (a, bc, b) = +-1/2 on (x, y, z), in the
// order x ++++----, y ++--++--, z +-+-+-+-, so j = 4 ix + 2 iy + iz with
// index 0 for +1/2. x_c, z_c and so 1/z depend on (a, b) alone: the corners
// j and j + 2 (bc = +1/2, -1/2) share them. The kernel walks the 4 pairs
// ("combos" cb = 2 ix + iz) and the two corners of each.
__device__ __forceinline__ int corner(int cb, int iy) { return 4 * (cb >> 1) + 2 * iy + (cb & 1); }
__device__ __forceinline__ float combo_a(int cb) { return cb < 2 ? 0.5f : -0.5f; }
__device__ __forceinline__ float combo_b(int cb) { return (cb & 1) == 0 ? 0.5f : -0.5f; }

struct Camera {
  float fx, fy;
};

// What a corner pair's projection at x leaves for the normal equations.
struct Proj {
  float iz, pu;  // 1/z and x/z, shared by the pair
  float pv[2];   // y/z of the corners with bc = +1/2 and -1/2
};

// Projects the corner pairs at x; returns their squared residuals.
// du = cx - u and dv = cy - v, so a residual is one FMA from the projection.
__device__ __forceinline__ float project(const float (&x)[8], const float (&du)[kPairs][2],
                                         const float (&dv)[kPairs][2], const Camera& cam,
                                         Proj (&pr)[kPairs]) {
  const float lc = x[2] * x[1], ws = x[4] * x[0], ls = x[2] * x[0], wc = x[4] * x[1];
  const float yc[2] = {0.5f * x[3] + x[6], -0.5f * x[3] + x[6]};
  float cost = 0.f;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const float xc = combo_a(k) * lc + combo_b(k) * ws + x[5];
    const float z = -combo_a(k) * ls + combo_b(k) * wc + x[7] + kZGuard;
    const float iz = 1.f / z;
    pr[k].iz = iz;
    pr[k].pu = xc * iz;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      pr[k].pv[i] = yc[i] * iz;
      const float ru = fmaf(cam.fx, pr[k].pu, du[k][i]);
      const float rv = fmaf(cam.fy, pr[k].pv[i], dv[k][i]);
      cost += ru * ru + rv * rv;
    }
  }
  return cost;
}

__device__ __forceinline__ float prior_cost(const float (&x)[8], const float (&dim0)[3],
                                            float prior_weight) {
  float p = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float d = x[2 + k] - dim0[k];
    p += d * d;
  }
  return prior_weight * p;
}

// The normal equations as moment sums. With T = a R + b S - e_Z, a corner's
// Jacobian rows are
//   Ju = fxz (a P + b Q + e_X) + fxz pu T,   Jv = fyz (bc e_h + e_Y) + fyz pv T
// (fxz = fx/z, pu = x/z, pv = y/z; a, b, bc the corner's signs), where
// P = l e_c + c e_l, Q = w e_s + s e_w, R = l e_s + s e_l, S = -w e_c - c e_w
// hold the pose and not the corner. As a^2 = b^2 = bc^2 = 1/4, J^T J and
// J^T r over the corners are fixed combinations of 27 sign-weighted sums of
// per-corner scalars: F = fxz^2, G = F pu, K = F pu^2 + fyz^2 pv^2,
// Fv = fyz^2, Gv = Fv pv, U = fxz ru, V = fyz rv, Qr = U pu + V pv (the
// sum of bc Fv is 0: a pair's two corners cancel). A corner pair adds to the
// sums at once, in 85 operations where a corner's 13 Jacobian entries and
// their 62 products take 159, and A and g are assembled from the sums once
// an iteration.
enum Moment {
  kF1, kFa, kFb, kFab, kG1, kGa, kGb, kGab, kK1, kKa, kKb, kKab,
  kFv1, kGv1, kGva, kGvb, kGvbc, kGvabc, kGvbbc,
  kU1, kUa, kUb, kV1, kVbc, kQ1, kQa, kQb, kMoments
};
// the non-zero entries of P, Q, R, S, bit p for parameter p
constexpr unsigned kP = 0x06u, kQ = 0x11u, kR = 0x05u, kS = 0x12u;

// A += c X X^T on the upper triangle; NX marks X's non-zero entries.
template <unsigned NX>
__device__ __forceinline__ void add_outer(float (&A)[8][8], float c, const float (&X)[8]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (!((NX >> p) & 1u)) continue;
    const float cx = c * X[p];
#pragma unroll
    for (int q = p; q < 8; ++q) {
      if ((NX >> q) & 1u) A[p][q] += cx * X[q];
    }
  }
}

// A += c (X Y^T + Y X^T) on the upper triangle.
template <unsigned NX, unsigned NY>
__device__ __forceinline__ void add_sym(float (&A)[8][8], float c, const float (&X)[8],
                                        const float (&Y)[8]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (!((NX >> p) & 1u)) continue;
    const float cx = c * X[p];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (!((NY >> q) & 1u)) continue;
      if (p < q) A[p][q] += cx * Y[q];
      else if (p > q) A[q][p] += cx * Y[q];
      else A[p][p] += (cx + cx) * Y[p];
    }
  }
}

// A += c (X e_k^T + e_k X^T) on the upper triangle; X is 0 at k.
template <unsigned NX, int k>
__device__ __forceinline__ void add_sym_unit(float (&A)[8][8], float c, const float (&X)[8]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (!((NX >> p) & 1u)) continue;
    if (p < k) A[p][k] += c * X[p];
    else A[k][p] += c * X[p];
  }
}

__global__ void __launch_bounds__(kMaxThreads)
lm_kernel(const float* __restrict__ uv, const float* __restrict__ x0,
          const float* __restrict__ kp, float* __restrict__ x_out,
          float* __restrict__ cost_out, int64_t m, int iters, float lam0,
          float prior_weight) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;

  float x[8], dim0[3];
#pragma unroll
  for (int p = 0; p < 8; ++p) x[p] = x0[p * m + i];
#pragma unroll
  for (int k = 0; k < 3; ++k) dim0[k] = x[2 + k];  // per-class prior == init dims
  const Camera cam{kp[i], kp[m + i]};
  const float cx = kp[2 * m + i], cy = kp[3 * m + i];
  float du[kPairs][2], dv[kPairs][2];
#pragma unroll
  for (int cb = 0; cb < kPairs; ++cb) {
#pragma unroll
    for (int iy = 0; iy < 2; ++iy) {
      const int j = corner(cb, iy);
      du[cb][iy] = cx - uv[j * m + i];
      dv[cb][iy] = cy - uv[(8 + j) * m + i];
    }
  }
  const bool prior = prior_weight > 0.f;

  Proj pr[kPairs];
  float rcost = project(x, du, dv, cam, pr);
  float cost = prior ? rcost + prior_cost(x, dim0, prior_weight) : rcost;
  float lam = lam0;

#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // the moment sums, from the projections at x: per corner pair, the sums
    // over its two corners (bc = +1/2, -1/2), with the pair's factor 2 and
    // the 1/2 of bc in the weights
    float mo[kMoments];
#pragma unroll
    for (int n = 0; n < kMoments; ++n) mo[n] = 0.f;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const float pu = pr[k].pu, pv0 = pr[k].pv[0], pv1 = pr[k].pv[1];
      const float ru0 = fmaf(cam.fx, pu, du[k][0]), ru1 = fmaf(cam.fx, pu, du[k][1]);
      const float rv0 = fmaf(cam.fy, pv0, dv[k][0]), rv1 = fmaf(cam.fy, pv1, dv[k][1]);
      const float fxz = cam.fx * pr[k].iz, fyz = cam.fy * pr[k].iz;
      const float F = fxz * fxz, Fv = fyz * fyz, G = F * pu;
      const float Ks = (G + G) * pu + Fv * (pv0 * pv0 + pv1 * pv1);
      const float Gvs = Fv * (pv0 + pv1), Gvd = Fv * (pv0 - pv1);
      const float Us = fxz * (ru0 + ru1), Vs = fyz * (rv0 + rv1), Vd = fyz * (rv0 - rv1);
      const float Qs = pu * Us + fyz * (rv0 * pv0 + rv1 * pv1);
      const float a = combo_a(k), b = combo_b(k), ab = a * b;
      mo[kF1] += 2.f * F;
      mo[kFa] += (2.f * a) * F;
      mo[kFb] += (2.f * b) * F;
      mo[kFab] += (2.f * ab) * F;
      mo[kG1] += 2.f * G;
      mo[kGa] += (2.f * a) * G;
      mo[kGb] += (2.f * b) * G;
      mo[kGab] += (2.f * ab) * G;
      mo[kK1] += Ks;
      mo[kKa] += a * Ks;
      mo[kKb] += b * Ks;
      mo[kKab] += ab * Ks;
      mo[kFv1] += 2.f * Fv;
      mo[kGv1] += Gvs;
      mo[kGva] += a * Gvs;
      mo[kGvb] += b * Gvs;
      mo[kGvbc] += 0.5f * Gvd;
      mo[kGvabc] += (0.5f * a) * Gvd;
      mo[kGvbbc] += (0.5f * b) * Gvd;
      mo[kU1] += Us;
      mo[kUa] += a * Us;
      mo[kUb] += b * Us;
      mo[kV1] += Vs;
      mo[kVbc] += 0.5f * Vd;
      mo[kQ1] += Qs;
      mo[kQa] += a * Qs;
      mo[kQb] += b * Qs;
    }

    // A = J^T J (upper triangle) and g = J^T r from the sums
    float A[8][8], g[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
#pragma unroll
      for (int q = 0; q < 8; ++q) A[p][q] = 0.f;
    }
    const float s = x[0], c = x[1], l = x[2], w = x[4];
    const float P[8] = {0.f, l, c, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float Q[8] = {w, 0.f, 0.f, 0.f, s, 0.f, 0.f, 0.f};
    const float R[8] = {l, 0.f, s, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float S[8] = {0.f, -w, 0.f, 0.f, -c, 0.f, 0.f, 0.f};
    const float F4 = 0.25f * mo[kF1], G4 = 0.25f * mo[kG1], K4 = 0.25f * mo[kK1];
    add_outer<kP>(A, F4, P);
    add_outer<kQ>(A, F4, Q);
    add_outer<kR>(A, K4, R);
    add_outer<kS>(A, K4, S);
    add_sym<kP, kQ>(A, mo[kFab], P, Q);
    add_sym<kR, kS>(A, mo[kKab], R, S);
    add_sym<kP, kR>(A, G4, P, R);
    add_sym<kQ, kS>(A, G4, Q, S);
    add_sym<kP, kS>(A, mo[kGab], P, S);
    add_sym<kQ, kR>(A, mo[kGab], Q, R);
    add_sym_unit<kP, 5>(A, mo[kFa], P);
    add_sym_unit<kQ, 5>(A, mo[kFb], Q);
    add_sym_unit<kR, 5>(A, mo[kGa], R);
    add_sym_unit<kS, 5>(A, mo[kGb], S);
    add_sym_unit<kP, 7>(A, -mo[kGa], P);
    add_sym_unit<kQ, 7>(A, -mo[kGb], Q);
    add_sym_unit<kR, 7>(A, -mo[kKa], R);
    add_sym_unit<kS, 7>(A, -mo[kKb], S);
    add_sym_unit<kR, 3>(A, mo[kGvabc], R);
    add_sym_unit<kS, 3>(A, mo[kGvbbc], S);
    add_sym_unit<kR, 6>(A, mo[kGva], R);
    add_sym_unit<kS, 6>(A, mo[kGvb], S);
    A[5][5] += mo[kF1];
    A[3][3] += 0.25f * mo[kFv1];
    A[6][6] += mo[kFv1];
    A[7][7] += mo[kK1];
    A[5][7] -= mo[kG1];
    A[3][7] -= mo[kGvbc];
    A[6][7] -= mo[kGv1];
    g[0] = mo[kUb] * w + mo[kQa] * l;
    g[1] = mo[kUa] * l - mo[kQb] * w;
    g[2] = mo[kUa] * c + mo[kQa] * s;
    g[3] = mo[kVbc];
    g[4] = mo[kUb] * s - mo[kQb] * c;
    g[5] = mo[kU1];
    g[6] = mo[kV1];
    g[7] = -mo[kQ1];
    if (prior) {
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
    for (int p = 0; p < 8; ++p) A[p][p] = A[p][p] * damp + 1e-9f;

    // Unpivoted elimination on the upper triangle (A is symmetric, so row
    // i's factor A[i][k] / A[k][k] reads A[k][i]), then back-substitution.
    float inv_piv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float piv = A[k][k];
      inv_piv[k] = 1.f / (fabsf(piv) > 1e-12f ? piv : 1e-12f);
#pragma unroll
      for (int row = k + 1; row < 8; ++row) {
        const float f = A[k][row] * inv_piv[k];
#pragma unroll
        for (int col = row; col < 8; ++col) A[row][col] -= f * A[k][col];
        g[row] -= f * g[k];
      }
    }
    float step[8], x_new[8];
#pragma unroll
    for (int row = 7; row >= 0; --row) {
      float acc = g[row];
#pragma unroll
      for (int col = row + 1; col < 8; ++col) acc -= A[row][col] * step[col];
      step[row] = acc * inv_piv[row];
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) x_new[p] = x[p] - step[p];

    Proj pn[kPairs];
    const float rcost_new = project(x_new, du, dv, cam, pn);
    const float cost_new = prior ? rcost_new + prior_cost(x_new, dim0, prior_weight) : rcost_new;
    const bool accept = cost_new < cost;  // false for NaN: a NaN step is rejected
#pragma unroll
    for (int p = 0; p < 8; ++p) x[p] = accept ? x_new[p] : x[p];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) pr[k] = accept ? pn[k] : pr[k];
    rcost = accept ? rcost_new : rcost;
    cost = accept ? cost_new : cost;
    lam = accept ? fmaxf(lam * 0.33f, 1e-9f) : fminf(lam * 3.f, 1e6f);
  }

#pragma unroll
  for (int p = 0; p < 8; ++p) x_out[p * m + i] = x[p];
  cost_out[i] = rcost;  // acceptance stays reprojection-only
}

}  // namespace

extern "C" int lm_max_threads() { return kMaxThreads; }

// Launch `blocks` x `threads`, one thread per detection, on `stream`;
// returns cudaGetLastError() as an int (0 = launched), or
// cudaErrorInvalidValue for a grid that does not cover m detections in
// whole warps.
extern "C" int lm_solve_launch(const float* uv, const float* x0, const float* kp,
                               float* x_out, float* cost_out, int64_t m, int iters,
                               float lam0, float prior_weight, int blocks, int threads,
                               cudaStream_t stream) {
  if (m <= 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0 || blocks <= 0 ||
      static_cast<int64_t>(blocks) * threads < m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lm_kernel<<<blocks, threads, 0, stream>>>(uv, x0, kp, x_out, cost_out, m, iters, lam0,
                                            prior_weight);
  return static_cast<int>(cudaGetLastError());
}
