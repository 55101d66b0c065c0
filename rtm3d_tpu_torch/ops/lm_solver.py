"""The Levenberg-Marquardt 3D solver: CUDA kernel wrapper and plain version.

``lm_solve`` launches ``csrc/lm_solver.cu``, the hand-written Hopper kernel
that replaces ``rtm3d_tpu/ops/lm_solver.py::_lm_kernel`` (the Pallas TPU
kernel): the whole fixed-iteration LM loop, one thread per detection in the
grid ``lm_launch_geometry`` gives. It is bound by fp32 arithmetic
(``lm_flops``), not by memory (``lm_bytes``); see the source's note for the
design.

Layout, as the TPU kernel's: detections along the last axis,
  uv  (16, M)  target pixels (u rows 0..7, v rows 8..15)
  x0  (8, M)   initial [sin, cos, l, h, w, X, Y, Z]
  kp  (4, M)   fx, fy, cx, cy
returning x (8, M) and the pure reprojection cost (1, M).

``lm_solve_reference`` is the plain PyTorch version (``decode/solve3d.py::
_lm_batch`` on the same layout). ``lm_solve`` takes it for CPU tensors only;
on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from rtm3d_tpu_torch.decode.solve3d import _lm_batch
from rtm3d_tpu_torch.utils import kernel_build

# Operations per detection, counted from csrc/lm_solver.cu with add, sub,
# mul, div and reciprocal as 1 and FMA as 2 (compares, selects, negations and
# the corners' constant signs as 0).
_FLOPS_PAIR_PROJECT = (
    9  # x_c, z: shared by a corner pair
    + 2  # 1/z, x/z
    + 2 * (1 + 4 + 4)  # per corner: y/z; ru, rv (one FMA each); ru^2 + rv^2 into the cost
)
_FLOPS_PROJECT = 4 + 4 + 4 * _FLOPS_PAIR_PROJECT  # project(): 4 hoisted products, the 2 y_c
_FLOPS_PRIOR_COST = 3 * 3 + 2  # prior_cost() and its add to the cost
_FLOPS_PAIR_NORMAL = (
    8  # ru, rv of both corners from the kept projection
    + 2 + 3  # fx/z, fy/z; F, Fv, G
    + 7 + 2 + 2  # Ks; Gvs, Gvd
    + 2 + 2 + 2 + 6  # Us, Vs, Vd; Qs
    + 5 + 2 * 22  # the 27 moment sums: 5 plain, 22 weighted
)
_FLOPS_ASSEMBLE = (
    3  # F1/4, G1/4, K1/4
    + 4 * 8  # c X X^T for X = P, Q, R, S (2 products, 3 FMAs each)
    + 2 * 10 + 4 * 11  # c (X Y^T + Y X^T) for 6 pairs, 4 of them sharing an entry
    + 12 * 4  # c (X e_k^T + e_k X^T): 2 FMAs each
    + 8  # the unit-vector terms
    + 4 * 3  # g's 4 pose entries
)
_FLOPS_SOLVE = (
    sum(1 + sum(1 + 2 * (8 - row) + 2 for row in range(k + 1, 8)) for k in range(8))  # elimination
    + 2 * 28 + 8  # back-substitution
)
_FLOPS_ITER = (
    4 * _FLOPS_PAIR_NORMAL + _FLOPS_ASSEMBLE  # normal equations
    + 17  # damping
    + _FLOPS_SOLVE
    + 8  # x - step
    + _FLOPS_PROJECT  # the projections and cost at the new x
    + 1  # lambda update
)
_FLOPS_ITER_PRIOR = 3 + 3 * 3 + _FLOPS_PRIOR_COST  # the prior in A, g and the cost
_FLOPS_ONCE = 16 + _FLOPS_PROJECT  # cx - u, cy - v; the projections at x0


def lm_flops(m: int, iters: int, prior_weight: float) -> int:
    """fp32 operations of one ``lm_solve`` call on ``m`` detections."""
    prior = prior_weight > 0
    per_iter = _FLOPS_ITER + (_FLOPS_ITER_PRIOR if prior else 0)
    once = _FLOPS_ONCE + (_FLOPS_PRIOR_COST if prior else 0)
    return m * (iters * per_iter + once)


def lm_bytes(m: int) -> int:
    """Bytes one call must move: each input read once, each output written once."""
    return m * (16 + 8 + 4 + 8 + 1) * 4


def lm_solve_reference(uv, x0, kp, iters: int = 40, lam0: float = 1e-3, prior_weight: float = 0.0):
    """Plain PyTorch version of the kernel, on any device."""
    M = uv.shape[1]
    uv_aos = uv.reshape(2, 8, M).permute(2, 1, 0)  # (M, 8, 2)
    K = torch.zeros((M, 3, 3), dtype=torch.float32, device=uv.device)
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = kp[0], kp[1], kp[2], kp[3]
    K[:, 2, 2] = 1.0
    x, cost = _lm_batch(uv_aos.float(), x0.T.float(), K, iters, lam0, prior_weight)
    return x.T.contiguous(), cost[None]


# Launch geometry. csrc/lm_solver.cu takes blocks of 32 to 256 threads, one
# thread per detection. An H100 SXM has 132 SMs: the default where no card
# is asked.
H100_SMS = 132
LM_BLOCK_THREADS = tuple(range(32, 257, 32))  # the block sizes tried


def busiest_sm_share(blocks: int, sms: int = H100_SMS) -> float:
    """Blocks on the busiest SM over the mean, for ``blocks`` equal blocks
    dealt round-robin over ``sms`` SMs."""
    return math.ceil(blocks / sms) / (blocks / sms)


def lm_launch_geometry(m: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(blocks, threads) of a launch on ``m`` detections, one thread each:
    the block of ``LM_BLOCK_THREADS`` whose grid puts the least on the
    busiest of ``sms`` SMs (the smallest block of those that tie)."""
    m = max(int(m), 1)
    grids = [(-(-m // t), t) for t in LM_BLOCK_THREADS]
    return min(grids, key=lambda g: (busiest_sm_share(g[0], sms), g[1]))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernel_build.load("lm_solver")
    fn = lib.lm_solve_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def lm_solve(uv, x0, kp, iters: int = 40, lam0: float = 1e-3, prior_weight: float = 0.0):
    """LM solve of M detections. CPU tensors take ``lm_solve_reference``;
    CUDA tensors launch the kernel on the current stream (or raise)."""
    tensors = {"uv": (uv, 16), "x0": (x0, 8), "kp": (kp, 4)}
    M = uv.shape[-1]
    for name, (t, rows) in tensors.items():
        if t.dim() != 2 or t.shape[0] != rows or t.shape[1] != M:
            raise ValueError(f"lm_solve: {name} must be ({rows}, {M}), got {tuple(t.shape)}")
    devices = {t.device for t, _ in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"lm_solve: inputs on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return lm_solve_reference(uv, x0, kp, iters, lam0, prior_weight)
    if device.type != "cuda":
        raise ValueError(f"lm_solve: no kernel for device {device}")
    for name, (t, _) in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"lm_solve: {name} must be contiguous float32, got {t.dtype}")
    x = torch.empty((8, M), dtype=torch.float32, device=device)
    cost = torch.empty((1, M), dtype=torch.float32, device=device)
    if M == 0:
        return x, cost
    blocks, threads = lm_launch_geometry(M, _sm_count(device.index))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().lm_solve_launch(
            uv.data_ptr(), x0.data_ptr(), kp.data_ptr(), x.data_ptr(), cost.data_ptr(),
            M, int(iters), float(lam0), float(prior_weight), blocks, threads, stream,
        )
    if err != 0:
        raise RuntimeError(f"lm_solver kernel launch failed: CUDA error {err}")
    lm_solve.launches += 1
    return x, cost


lm_solve.launches = 0  # kernel launches since the last reset
