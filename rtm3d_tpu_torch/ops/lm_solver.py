"""The Levenberg-Marquardt 3D solver: CUDA kernel wrapper and plain version.

``lm_solve`` launches ``csrc/lm_solver.cu``, the hand-written Hopper kernel
that replaces ``rtm3d_tpu/ops/lm_solver.py::_lm_kernel`` (the Pallas TPU
kernel): the whole fixed-iteration LM loop, one thread per detection. It is
bound by fp32 arithmetic (``lm_flops``), not by memory (``lm_bytes``); see
the source's note for the design.

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

import torch

from rtm3d_tpu_torch.decode.solve3d import _lm_batch
from rtm3d_tpu_torch.utils import kernel_build

# Operations per detection, counted from csrc/lm_solver.cu with add, sub,
# mul and div as 1 and FMA as 2 (compares, selects and negations as 0).
_FLOPS_REPROJ = 4 + 8 * 23  # reproj_cost: 4 hoisted products, 23 per corner
_FLOPS_PRIOR_COST = 3 * 3 + 2  # the prior term of total_cost
_FLOPS_CORNER = (
    11  # xc, yc, z
    + 8  # ru, rv (one divide each)
    + 5  # 1/z, xc/z, yc/z, fx/z, fy/z
    + 6  # sign products a*l, b*w, a*c, a*s, b*s, b*c
    + 13 + 10  # the 13 non-zero Jacobian entries
    + 2 * 13  # g += J^T r over the 13 non-zero entries
    + 2 * (21 + 28)  # J^T J: 21 Ju and 28 Jv products on or above the diagonal
)
_FLOPS_ITER = (
    4 + 8 * _FLOPS_CORNER  # normal equations
    + 17  # damping
    + sum(1 + 15 * (8 - k) for k in range(8))  # Gauss-Jordan, columns > k only
    + 8  # x - step
    + _FLOPS_REPROJ  # the cost at the new x
    + 1  # lambda update
)
_FLOPS_ITER_PRIOR = 3 + 3 * 3 + _FLOPS_PRIOR_COST  # the prior in A, g and the cost


def lm_flops(m: int, iters: int, prior_weight: float) -> int:
    """fp32 operations of one ``lm_solve`` call on ``m`` detections."""
    prior = prior_weight > 0
    per_iter = _FLOPS_ITER + (_FLOPS_ITER_PRIOR if prior else 0)
    once = 2 * _FLOPS_REPROJ + (_FLOPS_PRIOR_COST if prior else 0)
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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernel_build.load("lm_solver")
    fn = lib.lm_solve_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
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
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.lm_solve_launch(
            uv.data_ptr(), x0.data_ptr(), kp.data_ptr(), x.data_ptr(), cost.data_ptr(),
            M, int(iters), float(lam0), float(prior_weight), stream,
        )
    if err != 0:
        raise RuntimeError(f"lm_solver kernel launch failed: CUDA error {err}")
    lm_solve.launches += 1
    return x, cost


lm_solve.launches = 0  # kernel launches since the last reset
