"""Heatmap decode and the 3D solve, plain PyTorch.

Decode (reference: models/model.py:29-98, utils/model_utils.py:17-26):
sigmoid, 3x3 peak suppression, exact top-K over class x pixel, the
16-channel vertex offsets and the sub-pixel centre offset at each peak.

The 3D solve (reference: utils/model_utils.py:155-177 and 264-312, solved
as in the port's plain version, ``decode/solve3d.py::_lm_batch``, frozen
here): per detection the 8 unknowns [sin t, cos t, l, h, w, X, Y, Z]
minimise the reprojection of the 8 corners onto the regressed vertices,
with the z + 1e-4 guard, by a fixed-iteration Levenberg-Marquardt loop,
from two yaw inits (cos = 1 and -1), a dimension prior of weight
``DIM_PRIOR_WEIGHT`` and a third init from the regularised solution; the
cost kept is the pure reprojection's, and a detection is accepted when its
score passes ``SCORE_THRESH`` and its cost is under ``RESIDUAL_THRESH``.
``dtype`` is float32 for the reference, bfloat16 for the control.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

COR = torch.tensor([[i, j, k] for i in (1, -1) for j in (1, -1) for k in (1, -1)], dtype=torch.float32).T * 0.5
Z_GUARD = 1e-4


def heatmap(logits_kf: torch.Tensor):
    """(sigmoid scores, the same with non-peaks zeroed), NCHW float32."""
    hm = torch.sigmoid(logits_kf.float())
    hmax = F.max_pool2d(hm, 3, stride=1, padding=1)
    return hm, torch.where(hmax == hm, hm, 0.0)


def decode(logits, score_thresh: float, topk: int, down: float) -> dict:
    """Fixed (B, K) detections from the 4 NCHW logit maps."""
    kf, vc, mo, _ = (x.float() for x in logits)
    B, C, H, W = kf.shape
    _, peaks = heatmap(kf)
    scores, idx = torch.topk(peaks.reshape(B, C * H * W), topk, dim=1)
    cls = idx // (H * W)
    pix = idx % (H * W)
    y, x = pix // W, pix % W

    def at(fmap):
        flat = fmap.reshape(B, fmap.shape[1], H * W)
        return torch.gather(flat, 2, pix[:, None, :].expand(B, fmap.shape[1], topk)).transpose(1, 2)

    centers = torch.stack([x, y], -1).float() + torch.sigmoid(at(mo))
    v_proj = (at(vc).reshape(B, topk, 8, 2) + centers[:, :, None, :]) * down
    return {"cls": cls.to(torch.int32), "scores": scores, "valid": scores > score_thresh,
            "m_proj": centers * down, "v_proj": v_proj,
            "bbox2d": torch.cat([v_proj.amin(2), v_proj.amax(2)], -1)}


def _residuals(x, fx, fy, cx, cy, uv):
    cor = COR.to(x)
    a, bc, b = cor[0][None], cor[1][None], cor[2][None]
    s, c, l, h, w = x[:, 0:1], x[:, 1:2], x[:, 2:3], x[:, 3:4], x[:, 4:5]
    xc = a * l * c + b * w * s + x[:, 5:6]
    yc = bc * h + x[:, 6:7]
    z = -a * l * s + b * w * c + x[:, 7:8] + Z_GUARD
    r = torch.cat([fx * xc / z + cx - uv[..., 0], fy * yc / z + cy - uv[..., 1]], -1)
    return r, (xc, yc, z, a, bc, b, s, c, l, w)


def _jacobian(aux, fx, fy):
    xc, yc, z, a, bc, b, s, c, l, w = aux
    zero, one = torch.zeros_like(xc), torch.ones_like(xc)
    dxc = [b * w, a * l, a * c, zero, b * s, one, zero, zero]
    dyc = [zero, zero, zero, bc + zero, zero, zero, one, zero]
    dzc = [-a * l, b * w, -a * s, zero, b * c, zero, zero, one]
    iz = 1.0 / z
    iz2 = iz * iz
    ju = torch.stack([fx * (dx * z - dz * xc) * iz2 for dx, dz in zip(dxc, dzc)], -1)
    jv = torch.stack([fy * (dy * z - dz * yc) * iz2 for dy, dz in zip(dyc, dzc)], -1)
    return torch.cat([ju, jv], 1)  # (M, 16, 8)


def _solve(A, g):
    """Gauss-Jordan without pivoting on the damped (SPD) normal equations."""
    n = A.shape[-1]
    for k in range(n):
        piv = A[:, k, k:k + 1]
        inv = 1.0 / torch.where(piv.abs() > 1e-12, piv, torch.full_like(piv, 1e-12))
        rowk, gk = A[:, k, :] * inv, g[:, k:k + 1] * inv
        coef = A[:, :, k].clone()
        coef[:, k] = 0.0
        A = A - coef[:, :, None] * rowk[:, None, :]
        A[:, k, :] = rowk
        g = g - coef * gk
        g[:, k] = gk[:, 0]
    return g


def lm(uv, x0, kp, iters: int, prior_weight: float, lam0: float = 1e-3):
    """uv (M, 8, 2), x0 (M, 8), kp (M, 4) fx fy cx cy -> (x (M, 8), pure
    reprojection cost (M,)), in the inputs' dtype."""
    fx, fy, cx, cy = (kp[:, i:i + 1] for i in range(4))
    dim0 = x0[:, 2:5]
    sw = math.sqrt(prior_weight) if prior_weight > 0 else 0.0
    M = x0.shape[0]
    eye = torch.eye(8, dtype=x0.dtype, device=x0.device)

    def reproj(x):
        r, _ = _residuals(x, fx, fy, cx, cy, uv)
        return (r * r).sum(-1)

    def cost_of(x):
        c = reproj(x)
        return c + prior_weight * ((x[:, 2:5] - dim0) ** 2).sum(-1) if prior_weight > 0 else c

    x, lam, cost = x0, torch.full((M,), lam0, dtype=x0.dtype, device=x0.device), cost_of(x0)
    for _ in range(iters):
        r, aux = _residuals(x, fx, fy, cx, cy, uv)
        J = _jacobian(aux, fx, fy)
        if prior_weight > 0:
            Jp = torch.zeros((M, 3, 8), dtype=r.dtype, device=r.device)
            Jp[:, 0, 2] = Jp[:, 1, 3] = Jp[:, 2, 4] = sw
            r = torch.cat([r, sw * (x[:, 2:5] - dim0)], 1)
            J = torch.cat([J, Jp], 1)
        JtJ = torch.einsum("mij,mik->mjk", J, J)
        g = torch.einsum("mij,mi->mj", J, r)
        diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)
        A = JtJ + (lam[:, None] * diag + 1e-9)[:, None, :] * eye[None]
        x_new = x - _solve(A, g)
        cost_new = cost_of(x_new)
        better = cost_new < cost
        x = torch.where(better[:, None], x_new, x)
        cost = torch.where(better, cost_new, cost)
        lam = torch.where(better, torch.clamp(lam * 0.33, min=1e-9), torch.clamp(lam * 3.0, max=1e6))
    return x, reproj(x)


def solve3d(v_proj, cls, K, conf_detector: dict, dtype=torch.float32) -> dict:
    """ry, dim (h, w, l), loc (box centre) and cost, shaped as ``cls``."""
    shape = tuple(cls.shape)
    dev = v_proj.device
    uv = v_proj.reshape(-1, 8, 2).to(dtype)
    cc = cls.reshape(-1).long()
    Kf = K.reshape(-1, 3, 3).to(dtype)
    kp = torch.stack([Kf[:, 0, 0], Kf[:, 1, 1], Kf[:, 0, 2], Kf[:, 1, 2]], -1)
    dim_ref = torch.as_tensor(np.asarray(conf_detector["dim_ref"], np.float32), device=dev).to(dtype)
    d0 = dim_ref[cc.clamp(0, dim_ref.shape[0] - 1)]
    M = cc.shape[0]
    loc0 = torch.as_tensor(np.asarray(conf_detector["REF_LOC"], np.float32), device=dev).to(dtype)
    iters = int(conf_detector["SOLVER_ITERS"])
    pw = float(conf_detector["DIM_PRIOR_WEIGHT"])

    def init(cos0):
        return torch.cat([torch.zeros((M, 1), dtype=dtype, device=dev), torch.full((M, 1), cos0, dtype=dtype, device=dev),
                          d0[:, 2:3], d0[:, 0:1], d0[:, 1:2], loc0[None].expand(M, 3)], 1)

    def best_of(inits, weight):
        n = len(inits)
        xs, cs = lm(uv.repeat(n, 1, 1), torch.cat(inits, 0), kp.repeat(n, 1), iters, weight)
        xs, cs = xs.reshape(n, M, 8), cs.reshape(n, M)
        best = cs.argmin(0)
        return xs[best, torch.arange(M, device=dev)], cs.amin(0)

    inits = [init(1.0), init(-1.0)]
    x, cost = best_of(inits, pw)
    if pw > 0:
        _, cost = best_of(inits + [x], 0.0)
    x, cost = x.float(), cost.float()
    rho = torch.sqrt(x[:, 0] ** 2 + x[:, 1] ** 2)
    return {"ry": torch.atan2(x[:, 0], x[:, 1]).reshape(shape),
            "dim": torch.stack([x[:, 3], x[:, 4] * rho, x[:, 2] * rho], -1).reshape(shape + (3,)),
            "loc": x[:, 5:8].reshape(shape + (3,)), "cost": cost.reshape(shape)}


def detect(logits, K, conf: dict, lm_dtype=torch.float32) -> dict:
    """The whole decode and solve of a batch, the program's output keys."""
    d = conf["config"]["DETECTOR"]
    det = decode(logits, float(d["SCORE_THRESH"]), int(d["TOPK_CANDIDATES"]),
                 float(conf["config"]["MODEL"]["DOWN_SAMPLE"]))
    topk = det["cls"].shape[1]
    det.update(solve3d(det["v_proj"], det["cls"], K[:, None].expand(K.shape[0], topk, 3, 3), d, lm_dtype))
    det["accepted"] = det["valid"] & (det["cost"] < float(d["RESIDUAL_THRESH"]))
    return det
