"""Detection drawings (reference: utils/visual_utils.py:46-251).

The port's copy of ``rtm3d_tpu/utils/visual.py``: 2D and 3D boxes,
keypoints, the three-row comparison panel, the bird's-eye view and the
target heatmap overlay (``cli/stats.py --vis-targets``). Headless:
helpers draw into numpy images in place and callers write them to files.
Every cv2 call goes through
``data/image_io.py``; the 3D corners come from this module's numpy
``corners_3d`` (the numpy path of ``rtm3d_tpu/geometry/projection.py:
60-96``), since ``geometry/projection.py`` is the port's torch path.
"""

from __future__ import annotations

import numpy as np

from rtm3d_tpu_torch.data import image_io

# edge order for the 12 box edges through the 8 projected corners
# (reference visual_utils.py:99,134)
OUTLINE = [0, 1, 3, 2, 0, 4, 5, 7, 6, 4, 5, 1, 3, 7, 6, 2]

_COLORS = [(0, 255, 0), (255, 128, 0), (0, 128, 255)]

# corner sign order of the reference loops for i in [1,-1]: for j in [1,-1]:
# for k in [1,-1] (model_utils.py:102-111), plus the center
_CORNER_SIGNS = np.array(
    [[i, j, k] for i in (1, -1) for j in (1, -1) for k in (1, -1)] + [[0, 0, 0]], np.float32
).T  # (3, 9)


def corners_3d(dimension, location, ry, bottom_center: bool = False) -> np.ndarray:
    """3D corners of yaw-rotated boxes in numpy, (..., 3, 9): 8 corners +
    center. dimension (..., 3) = (h, w, l); location (..., 3); ry (...,).
    ``bottom_center=True`` reads location as the KITTI bottom-face center."""
    dimension, location, ry = np.asarray(dimension), np.asarray(location), np.asarray(ry)
    signs = _CORNER_SIGNS.astype(dimension.dtype)
    half = np.stack([dimension[..., 2], dimension[..., 0], dimension[..., 1]], axis=-1) * 0.5
    s, c = np.sin(ry), np.cos(ry)
    zeros, ones = np.zeros_like(s), np.ones_like(s)
    R = np.stack([np.stack([c, zeros, s], -1), np.stack([zeros, ones, zeros], -1),
                  np.stack([-s, zeros, c], -1)], -2)
    rotated = np.matmul(R, half[..., :, None] * signs)
    center = location
    if bottom_center:
        zero = np.zeros_like(dimension[..., 0])
        center = location + np.stack([zero, -dimension[..., 0] * 0.5, zero], axis=-1)
    return rotated + center[..., :, None]


def draw_bbox2d(img, bboxes, classes=None, scores=None, names=None):
    for i, b in enumerate(np.asarray(bboxes).astype(int)):
        c = _COLORS[int(classes[i]) % 3] if classes is not None else (0, 255, 0)
        image_io.rectangle(img, (b[0], b[1]), (b[2], b[3]), c, 1)
        if scores is not None:
            label = f"{names[int(classes[i])] if names else ''} {float(scores[i]):.2f}"
            image_io.put_text(img, label, (b[0], max(b[1] - 2, 8)), image_io.FONT_PLAIN, 0.8, c, 1)
    return img


def draw_bbox3d_from_vertices(
    img, verts, color=(0, 255, 255), thickness=1, fill_front=False, label=None
):
    """verts: (8, 2) projected corners in the reference sign order.

    fill_front paints the front face (corners 0,1,3,2) translucently —
    0.7 x image + 0.3 x fill, the reference's blend (visual_utils.py:
    cv_draw_bbox_3d front_mark/rate). label draws a filled text tag at the
    box's top-left projected corner."""
    v = np.asarray(verts).astype(int)
    if fill_front:
        overlay = img.copy()
        image_io.fill_poly(overlay, v[[0, 1, 3, 2]], color)
        image_io.blend(img, overlay, 0.3)
    for i in range(len(OUTLINE) - 1):
        a, b = OUTLINE[i], OUTLINE[i + 1]
        image_io.line(img, tuple(v[a]), tuple(v[b]), color, thickness)
    if label:
        tl = max(thickness, 1)
        t_size = image_io.text_size(label, image_io.FONT_SIMPLEX, tl / 3, tl)
        c1 = (int(v[:, 0].min()), int(v[:, 1].min()))
        c2 = (c1[0] + t_size[0], c1[1] - t_size[1] - 3)
        image_io.rectangle(img, c1, c2, color, -1, image_io.LINE_AA)
        image_io.put_text(img, label, (c1[0], c1[1] - 2), image_io.FONT_SIMPLEX, tl / 3, (225, 255, 255),
                          tl, image_io.LINE_AA)
    return img


def draw_bbox3d(
    img, dim, loc, ry, K, color=(0, 255, 255), bottom_center=False, **kw
):
    """Project (dim, loc, ry) through K and draw (visual_utils.py:60-73).
    Pass bottom_center=True for KITTI-convention locations. Extra kwargs
    (fill_front, label, thickness) forward to draw_bbox3d_from_vertices."""
    pts = corners_3d(
        np.asarray(dim)[None], np.asarray(loc)[None], np.asarray([ry]), bottom_center
    )[0]
    proj = K @ pts
    uv = (proj[:2] / np.maximum(proj[2:3], 1e-6)).T[:8]
    return draw_bbox3d_from_vertices(img, uv, color, **kw)


def draw_birdview(boxes, img_size=400, max_range=50.0, gts=None):
    """Bird's-eye-view canvas with rotated box footprints
    (reference: visual_utils.py:165-197). boxes: iterable of
    (x, z, w, l, ry) tuples in camera coords; gts drawn in a second colour.
    Returns a BGR image: camera at bottom-center, z up."""
    img = np.full((img_size, img_size, 3), 30, np.uint8)

    def to_px(x, z):
        px = int(img_size / 2 + x / max_range * img_size / 2)
        py = int(img_size - z / max_range * img_size)
        return px, py

    for group, color in ((gts or [], (90, 90, 90)), (boxes, (0, 255, 255))):
        for x, z, w, l, ry in group:
            c, s = np.cos(ry), np.sin(ry)
            dx = np.array([l / 2, l / 2, -l / 2, -l / 2])
            dz = np.array([w / 2, -w / 2, -w / 2, w / 2])
            rx = c * dx + s * dz
            rz = -s * dx + c * dz
            pts = np.array([to_px(x + a, z + b) for a, b in zip(rx, rz)], np.int32)
            image_io.polylines(img, pts, True, color, 1)
    image_io.fill_circle(img, to_px(0, 0), 3, (255, 255, 255))
    return img


def draw_keypoints(img, points, color=(0, 0, 255)):
    for p in np.asarray(points).astype(int):
        image_io.fill_circle(img, tuple(p), 2, color)
    return img


def denormalize(img, mean, std):
    """Invert the Normalize transform for display (detect.py:50-52)."""
    out = (img * np.asarray(std) + np.asarray(mean)) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def compose_detection_panel(base_img, det, bi, K, names, gt=None):
    """Three-row comparison panel, half-resized — the reference detect
    display (detect.py:64-104: src / src_vertex / src_vertex_regress
    stacked with np.concatenate then cv2.resize //2):

      row 1: main keypoints + labelled 2D boxes
      row 2: solver 3D boxes (translucent front face + class:score tag),
             with ground-truth boxes underneath in gray when ``gt`` is
             given (dim, loc, ry) KITTI bottom-center tuples
      row 3: 3D boxes drawn directly from the regressed vertex projections
    """
    acc = np.asarray(det["accepted"][bi])
    idx = np.where(acc)[0]
    row1, row2, row3 = base_img.copy(), base_img.copy(), base_img.copy()

    if len(idx):
        draw_bbox2d(
            row1, det["bbox2d"][bi][idx], det["cls"][bi][idx],
            det["scores"][bi][idx], names,
        )
        draw_keypoints(row1, det["m_proj"][bi][idx])
    if gt is not None:
        for dim, loc, ry in gt:
            draw_bbox3d(row2, dim, loc, ry, K, color=(128, 128, 128),
                        bottom_center=True)
    for i in idx:
        cls_i = int(det["cls"][bi][i])
        color = _COLORS[cls_i % 3]
        label = f"{names[cls_i]}:{float(det['scores'][bi][i]):.2f}"
        draw_bbox3d(
            row2, det["dim"][bi][i], det["loc"][bi][i], det["ry"][bi][i], K,
            color=color, fill_front=True, label=label, thickness=2,
        )
        draw_bbox3d_from_vertices(
            row3, det["v_proj"][bi][i], color=color, fill_front=True,
            thickness=2, label=names[cls_i],
        )
    panel = np.concatenate([row1, row2, row3], axis=0)
    return image_io.resize_linear(panel, (panel.shape[1] // 2, panel.shape[0] // 2))


def draw_heatmap_overlay(img, m_hm, alpha=0.5):
    """Blend the per-class center heatmap over the (denormalised uint8)
    input frame and mark peak pixels: the headless equivalent of the
    reference's target-inspection tool (tests/test_dataset_reader.py:
    38-76), as ``rtm3d_tpu/utils/visual.py:152-178`` draws it.

    img: (H, W, 3) uint8; m_hm: (H/d, W/d, C) in [0, 1], the JAX package's
    NHWC layout (the port's targets are NCHW: transpose one image's map).
    Returns uint8."""
    H, W = img.shape[:2]
    hm = np.asarray(m_hm, np.float32)
    C = hm.shape[-1]
    color = np.zeros((hm.shape[0], hm.shape[1], 3), np.float32)
    for c in range(C):
        col = np.array(_COLORS[c % len(_COLORS)], np.float32)
        color += hm[..., c : c + 1] * col[None, None]
    color = image_io.resize_linear(np.clip(color, 0, 255), (W, H))
    out = np.clip(img.astype(np.float32) * (1 - alpha) + color * alpha, 0, 255).astype(np.uint8)
    d = H / hm.shape[0]
    for c in range(C):
        ys, xs = np.where(hm[..., c] >= 1.0)
        for y, x in zip(ys, xs):
            image_io.fill_circle(out, (int(x * d + d / 2), int(y * d + d / 2)), 3, _COLORS[c % len(_COLORS)])
    return out
