"""The reference serving pipeline, the port's own copy.

What ``tools/ap_parity.py::_detect_torch`` (:807-861) runs as the "torch"
leg of the real-data protocol: the reference's detect.py:47-88 plus
model_utils.py:264-312, restated as

- ``reference_decode``: a per-image loop with dynamic filtering (sigmoid,
  3x3 max-pool peaks, top-K over the flattened ``c*H*W + y*W + x`` order,
  the score threshold, the centre and vertex offsets): the port's copy of
  ``tests/test_decode_parity.py::_torch_reference_decode`` (:17);
- ``reference_solve``: one scipy L-BFGS-B fit of (sin, cos, l, h, w, X, Y,
  Z) to a detection's 8 vertices, started from the class's dimension prior
  and ``REF_LOC`` (unconstrained: L-BFGS-B ignores the constraint set the
  reference passes), then the solver's gauge fix: the port's copy of
  ``tests/test_detect_parity.py::_scipy_reference_solve`` (:43-72), with
  K, the priors and ``REF_LOC`` as arguments (the config's
  ``DETECTOR.dim_ref`` and ``REF_LOC``) where the test reads module
  constants;
- ``reference_rows``: one frame through the network in fp32 on the host,
  the decode and a solve per detection, as the KITTI writer's rows.

It serves the port's own model: the port keeps the reference's parameter
names and layout, so the port model with a checkpoint's weights is the
reference network with them. scipy is imported where the solve runs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rtm3d_tpu_torch.decode.solve3d import COR

Z_GUARD = 1e-4  # aimFun's additive z guard (model_utils.py:162)


def reference_decode(logits_nchw, score_thresh: float, topk: int, down: float = 4.0) -> list:
    """Per-image dicts of ``cls``, ``scores``, ``centers`` (input pixels)
    and ``verts`` (K, 8, 2) of the peaks above ``score_thresh`` among the
    ``topk`` best, from the 4 NCHW logit maps of a batch."""
    main_kf, offset_fr_main, main_offset, _ = [torch.as_tensor(x) for x in logits_nchw]
    out = []
    for i in range(main_kf.shape[0]):
        hm = torch.sigmoid(main_kf[i])
        hmax = F.max_pool2d(hm.unsqueeze(0), 3, stride=1, padding=1).squeeze(0)
        hm = hm * (hmax == hm).float()
        _, H, W = hm.shape
        scores, indices = torch.topk(hm.view(-1), topk)
        keep = scores > score_thresh
        scores, indices = scores[keep], indices[keep]
        if len(indices) == 0:
            out.append({"cls": np.zeros((0,), np.int64), "scores": np.zeros((0,), np.float32),
                        "centers": np.zeros((0, 2), np.float32), "verts": np.zeros((0, 8, 2), np.float32)})
            continue
        cls = indices // (H * W)
        xy = indices % (H * W)
        y = (xy // W).float()
        x = (xy % W).float()
        offs = offset_fr_main[i][:, y.long(), x.long()].view(-1, 2, len(x)).permute(0, 2, 1)  # (8, N, 2)
        sub = torch.sigmoid(main_offset[i][:, y.long(), x.long()])
        centers = torch.stack([x + sub[0], y + sub[1]], dim=-1)  # (N, 2)
        verts = (offs.permute(1, 0, 2) + centers.view(-1, 1, 2)) * down
        out.append({"cls": cls.numpy(), "scores": scores.numpy(), "centers": (centers * down).numpy(),
                    "verts": verts.numpy()})
    return out


def reference_solve(cls_id: int, verts, K, dim_ref, ref_loc) -> dict:
    """The reference 3D recovery of one detection: ``cost`` (the
    reprojection SSE), ``ry``, ``dim`` (h, w, l) and ``loc`` (the box
    centre), from its (8, 2) vertices and the (3, 3) ``K``; ``dim_ref``
    (classes, 3) holds (h, w, l) priors, ``ref_loc`` the initial
    location."""
    from scipy.optimize import minimize

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    uv = np.asarray(verts, np.float64)

    def fun(x):
        s, c, l, h, w, X, Y, Z = x
        xc = COR[0] * l * c + COR[2] * w * s + X
        yc = COR[1] * h + Y
        zc = -COR[0] * l * s + COR[2] * w * c + Z + Z_GUARD
        ru = fx * xc / zc + cx - uv[:, 0]
        rv = fy * yc / zc + cy - uv[:, 1]
        return float(np.sum(ru * ru + rv * rv))

    d = np.asarray(dim_ref, np.float32)[int(cls_id)]
    x0 = np.array([0.0, 1.0, d[2], d[0], d[1], *np.asarray(ref_loc, np.float32)], np.float64)
    x = minimize(fun, x0, method="L-BFGS-B", options={"maxiter": 15000}).x
    rho = float(np.hypot(x[0], x[1]))  # the solver's gauge fix (solve3d.py)
    return {"cost": float(fun(x)), "ry": float(np.arctan2(x[0], x[1])),
            "dim": np.array([x[3], x[4] * rho, x[2] * rho]), "loc": x[5:8].copy()}


def reference_rows(net, image: np.ndarray, K: np.ndarray, cfg) -> dict:
    """One normalised (H, W, 3) float32 frame through ``net`` (fp32, on the
    host, eval mode), the decode and a solve per detection: the KITTI
    writer's fields as (1, n, ...) arrays, ``accepted`` the residual
    acceptance (``cost < DETECTOR.RESIDUAL_THRESH``)."""
    with torch.no_grad():
        logits = net(torch.as_tensor(np.ascontiguousarray(image.transpose(2, 0, 1)[None]), dtype=torch.float32))
    # contiguous: a channels_last network (a trained one) gives strided logits
    dec = reference_decode(tuple(np.ascontiguousarray(t.numpy()) for t in logits),
                           float(cfg.DETECTOR.SCORE_THRESH), int(cfg.DETECTOR.TOPK_CANDIDATES),
                           float(cfg.MODEL.DOWN_SAMPLE))[0]
    res_thresh = float(cfg.DETECTOR.RESIDUAL_THRESH)
    rows = {"cls": [], "scores": [], "accepted": [], "bbox2d": [], "ry": [], "dim": [], "loc": []}
    for k in range(len(dec["cls"])):
        v = dec["verts"][k]
        sol = reference_solve(int(dec["cls"][k]), v, K, cfg.DETECTOR.dim_ref, cfg.DETECTOR.REF_LOC)
        rows["cls"].append(int(dec["cls"][k]))
        rows["scores"].append(float(dec["scores"][k]))
        rows["accepted"].append(bool(sol["cost"] < res_thresh))
        rows["bbox2d"].append([v[:, 0].min(), v[:, 1].min(), v[:, 0].max(), v[:, 1].max()])
        rows["ry"].append(sol["ry"])
        rows["dim"].append(sol["dim"].tolist())
        rows["loc"].append(sol["loc"].tolist())
    shapes = {"cls": (), "scores": (), "accepted": (), "bbox2d": (4,), "ry": (), "dim": (3,), "loc": (3,)}
    return {k: np.asarray(v, np.float64 if k not in ("cls", "accepted") else None).reshape((1, len(v)) + shapes[k])
            for k, v in rows.items()}
