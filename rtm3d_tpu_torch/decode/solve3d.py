"""Batched geometric 3D box recovery: vectorised Levenberg-Marquardt.

Port of ``rtm3d_tpu/decode/solve3d.py:32-289``. The reference recovers
(Ry, dimensions, location) per detection with scipy L-BFGS-B
(utils/model_utils.py:264-312). Here the same 8-unknown reprojection
objective x = [sin t, cos t, l, h, w, X, Y, Z] (aimFun, model_utils.py:155-177,
with its z + 1e-4 guard) is minimised by a fixed-iteration LM loop over all
detections of the batch at once.

``_residuals_batch``, ``_jacobian_batch``, ``_gauss_jordan_solve`` and
``_lm_batch`` are the plain PyTorch formulation; they are the building blocks
of the kernel's plain version (``ops/lm_solver.py::lm_solve_reference``).
``solve_bbox3d`` goes through ``ops/lm_solver.py::lm_solve``, which launches
the CUDA kernel for CUDA tensors and runs ``_lm_batch`` for CPU tensors.

Acceptance matches the reference: final cost < RESIDUAL_THRESH (0.1)
(model_utils.py:298), surfaced as a mask instead of a dynamic filter.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

# corner sign pattern * 0.5, shape (3, 8) (model_utils.py:275-281)
_signs = []
for _i in (1, -1):
    for _j in (1, -1):
        for _k in (1, -1):
            _signs.append((_i, _j, _k))
COR = np.array(_signs, dtype=np.float32).T * 0.5  # (3, 8)

_Z_GUARD = 1e-4  # aimFun's additive z guard (model_utils.py:162)


def _residuals_batch(x, K, uv):
    """x: (M, 8); K: (M, 3, 3); uv: (M, 8, 2). Returns (r (M, 16), aux)."""
    cor = torch.as_tensor(COR, device=x.device)
    a, bc, b = cor[0][None], cor[1][None], cor[2][None]  # (1, 8) each
    s, c, l, h, w = x[:, 0:1], x[:, 1:2], x[:, 2:3], x[:, 3:4], x[:, 4:5]
    X, Y, Z = x[:, 5:6], x[:, 6:7], x[:, 7:8]
    xc = a * l * c + b * w * s + X  # (M, 8)
    yc = bc * h + Y
    zc = -a * l * s + b * w * c + Z
    z = zc + _Z_GUARD
    fx = K[:, 0, 0][:, None]
    fy = K[:, 1, 1][:, None]
    cx = K[:, 0, 2][:, None]
    cy = K[:, 1, 2][:, None]
    ru = fx * xc / z + cx - uv[..., 0]
    rv = fy * yc / z + cy - uv[..., 1]
    r = torch.cat([ru, rv], dim=-1)  # (M, 16)
    return r, (xc, yc, z, a, bc, b, fx, fy, s, c, l, h, w)


def _jacobian_batch(aux):
    """Closed-form J (M, 16, 8) for the residual layout above."""
    xc, yc, z, a, bc, b, fx, fy, s, c, l, h, w = aux
    zero = torch.zeros_like(xc)
    one = torch.ones_like(xc)
    # partials of xc / yc / zc wrt [s, c, l, h, w, X, Y, Z] — each (M, 8)
    dxc = [b * w, a * l, a * c, zero, b * s, one, zero, zero]
    dyc = [zero, zero, zero, bc + zero, zero, zero, one, zero]
    dzc = [-a * l, b * w, -a * s, zero, b * c, zero, zero, one]
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    ju = [fx * (dx * z - dz * xc) * inv_z2 for dx, dz in zip(dxc, dzc)]
    jv = [fy * (dy * z - dz * yc) * inv_z2 for dy, dz in zip(dyc, dzc)]
    Ju = torch.stack(ju, dim=-1)  # (M, 8, 8) params last
    Jv = torch.stack(jv, dim=-1)
    return torch.cat([Ju, Jv], dim=1)  # (M, 16, 8)


def _gauss_jordan_solve(A, b):
    """Solve A x = b for batched SPD (M, 8, 8) via unrolled Gauss-Jordan —
    no pivoting (A is LM-damped SPD), all ops (M,)-vectorised."""
    n = A.shape[-1]
    for k in range(n):
        piv = A[:, k, k:k + 1]  # (M, 1)
        inv = 1.0 / torch.where(piv.abs() > 1e-12, piv, torch.full_like(piv, 1e-12))
        rowk = A[:, k, :] * inv  # (M, n)
        bk = b[:, k:k + 1] * inv  # (M, 1)
        not_k = torch.ones(n, dtype=A.dtype, device=A.device)
        not_k[k] = 0.0
        coef = A[:, :, k] * not_k[None, :]  # (M, n): zero for row k
        A = A - coef[:, :, None] * rowk[:, None, :]
        A[:, k, :] = rowk
        b = b - coef * bk
        b[:, k] = bk[:, 0]
    return b


def _lm_batch(uv, x0, K, iters: int, lam0: float = 1e-3, prior_weight: float = 0.0):
    """Vectorised LM over (M,) detections. Returns (x (M, 8), reproj_cost (M,)).

    ``prior_weight`` adds sqrt(w)*(dim - dim0) residuals anchoring the
    dimensions to the per-class prior (dim0 = x0[2:5]); weight 0 is the
    reference's objective. The returned cost is always reprojection-only
    (model_utils.py:298 semantics). J^T J is an fp32 einsum: reduced
    precision in the normal equations strands the solver at cost ~1e3
    (recorded at rtm3d_tpu/decode/solve3d.py:144-147)."""
    dim0 = x0[:, 2:5]
    sw = math.sqrt(prior_weight) if prior_weight > 0 else 0.0
    M = x0.shape[0]
    eye = torch.eye(8, dtype=x0.dtype, device=x0.device)

    def reproj_cost(x):
        r, _ = _residuals_batch(x, K, uv)
        return (r * r).sum(dim=-1)

    def cost_of(x):
        c = reproj_cost(x)
        if prior_weight > 0:
            c = c + prior_weight * ((x[:, 2:5] - dim0) ** 2).sum(dim=-1)
        return c

    x = x0
    lam = torch.full((M,), lam0, dtype=x0.dtype, device=x0.device)
    cost = cost_of(x0)
    for _ in range(iters):
        r, aux = _residuals_batch(x, K, uv)
        J = _jacobian_batch(aux)  # (M, 16, 8)
        if prior_weight > 0:
            # 3 extra rows: d/dx of sqrt(w)*(x[2:5]-dim0) — constant selectors
            rp = sw * (x[:, 2:5] - dim0)  # (M, 3)
            Jp = torch.zeros((M, 3, 8), dtype=r.dtype, device=r.device)
            Jp[:, 0, 2] = sw
            Jp[:, 1, 3] = sw
            Jp[:, 2, 4] = sw
            r = torch.cat([r, rp], dim=1)
            J = torch.cat([J, Jp], dim=1)
        JtJ = torch.einsum("mij,mik->mjk", J, J)
        g = torch.einsum("mij,mi->mj", J, r)
        diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)  # (M, 8)
        A = JtJ + (lam[:, None] * diag + 1e-9)[:, None, :] * eye[None]
        step = _gauss_jordan_solve(A, g)
        x_new = x - step
        cost_new = cost_of(x_new)
        better = cost_new < cost
        x = torch.where(better[:, None], x_new, x)
        cost = torch.where(better, cost_new, cost)
        lam = torch.where(
            better, torch.clamp(lam * 0.33, min=1e-9), torch.clamp(lam * 3.0, max=1e6)
        )
    return x, reproj_cost(x)


def solve_bbox3d(
    v_proj: torch.Tensor,
    cls: torch.Tensor,
    K: torch.Tensor,
    dim_ref,
    ref_loc,
    iters: int = 40,
    prior_weight: float = 0.0,
    solver=None,
) -> Dict[str, torch.Tensor]:
    """Recover 3D boxes for a fixed block of detections.

    v_proj: (..., 8, 2) regressed vertex pixels; cls: (...,) int;
    K: (..., 3, 3) per-detection intrinsics; dim_ref: (C, 3) (h, w, l) priors;
    ref_loc: (3,) initial location (detect.py:74 uses [0, -0.5, 20]).

    Returns dict ry (...,), dim (..., 3) (h,w,l), loc (..., 3), cost (...,).
    ``loc`` Y is the box CENTER; KITTI bottom-center output adds h/2.
    ``cost`` is always the best PURE-reprojection cost (the reference's
    acceptance quantity), even when ``prior_weight`` > 0 regularises the
    returned ry/dim/loc. Runs on the device of ``v_proj``: the LM kernel on
    CUDA, the plain LM on the CPU. ``solver`` takes ``ops/lm_solver.py::
    lm_solve``'s place (its plain version, ``lm_solve_reference``, for
    one: the JAX ``use_pallas=False``).
    """
    from rtm3d_tpu_torch.ops.lm_solver import lm_solve

    lm_solve = solver or lm_solve

    dev = v_proj.device
    batch_shape = tuple(cls.shape)
    uv = v_proj.reshape(-1, 8, 2).float()
    cc = cls.reshape(-1).long()
    Kf = K.reshape(-1, 3, 3).float()
    dim_ref = torch.as_tensor(dim_ref, dtype=torch.float32, device=dev)
    ref_loc = torch.as_tensor(ref_loc, dtype=torch.float32, device=dev)
    d0 = dim_ref[cc.clamp(0, dim_ref.shape[0] - 1)]  # (M, 3) h, w, l
    M = cc.shape[0]

    # the kernel's layout: structure-of-arrays, detections along the last
    # axis — uv rows 0..7 are u, 8..15 are v; kp rows are fx, fy, cx, cy
    uv_k = uv.permute(2, 1, 0).reshape(16, M)
    kp_k = torch.stack([Kf[:, 0, 0], Kf[:, 1, 1], Kf[:, 0, 2], Kf[:, 1, 2]], dim=0)

    def make_x0(cos0):  # (8, M)
        return torch.cat(
            [
                torch.zeros((1, M), dtype=torch.float32, device=dev),  # sin = 0
                torch.full((1, M), cos0, dtype=torch.float32, device=dev),
                d0[:, 2][None],  # l
                d0[:, 0][None],  # h
                d0[:, 1][None],  # w
                ref_loc[:, None].expand(3, M),
            ],
            dim=0,
        )

    def stacked_solve(x0_list, pw):
        """Solve from every init at prior weight ``pw`` and keep, per
        detection, the solution with the lowest REPROJECTION cost."""
        n = len(x0_list)
        xk, ck = lm_solve(
            uv_k.repeat(1, n).contiguous(),
            torch.cat(x0_list, dim=1).contiguous(),
            kp_k.repeat(1, n).contiguous(),
            iters=iters,
            prior_weight=pw,
        )
        xs = xk.reshape(8, n, M)
        cs = ck.reshape(n, M)
        best = cs.argmin(dim=0)  # (M,)
        x = torch.gather(xs, 1, best[None, None, :].expand(8, 1, M))[:, 0]  # (8, M)
        return x, cs.amin(dim=0)

    # Dual orientation init: the objective has deep local minima near the
    # pi-flipped yaw; the reference's single (sin=0, cos=1) init gets stuck
    # there. Run both orientations and keep the better fit.
    inits = [make_x0(1.0), make_x0(-1.0)]
    x, cost = stacked_solve(inits, prior_weight)
    if prior_weight > 0:
        # acceptance mirrors the reference gate — the PURE reprojection
        # objective's final cost; the regularised solution seeds a third
        # init so the pure cost is never above the regularised one
        _, cost = stacked_solve(inits + [x], 0.0)

    ry = torch.atan2(x[0], x[1])
    # a (sin, cos) radius rho != 1 is a rho-scaling of (l, w) under the
    # normalised rotation: fold it into the in-plane dims
    rho = torch.sqrt(x[0] ** 2 + x[1] ** 2)
    dim = torch.stack([x[3], x[4] * rho, x[2] * rho], dim=-1)  # (h, w, l)
    loc = x[5:8].T
    return {
        "ry": ry.reshape(batch_shape),
        "dim": dim.reshape(batch_shape + (3,)),
        "loc": loc.reshape(batch_shape + (3,)),
        "cost": cost.reshape(batch_shape),
    }
