"""KITTI AP evaluation: AP2D / AP-BEV / AP3D with R40 (or R11) interpolation.

The port's copy of ``rtm3d_tpu/eval/ap.py``; the reference computes no
metric at all ("test" is eval-mode loss only, SURVEY.md §6). Official-devkit
semantics: greedy score-ordered matching per class with valid-gt preference
over ignored gt, difficulty buckets by bbox height / occlusion / truncation,
neighbour-class ignores (Van for Car, Person_sitting for Pedestrian),
DontCare-region absorption (intersection / detection area), detections
smaller than the difficulty's minimum height treated as ignored, and AOS on
the bbox matching. Rotated-box overlap is a Sutherland-Hodgman polygon clip;
3D IoU = BEV intersection x height overlap.

Matching runs once per (class, metric, difficulty): each detection's
(score, outcome) comes from one score-ordered greedy pass, and the PR curve
from cumulative sums over those events.

The det x gt BEV intersection matrices come from the port's host C++
library, ``csrc/geometry.cc`` (built by ``utils/kernel_build.py`` into
``_build/`` at first use). A failed build raises: the JAX package warns and
drops to Python, which takes minutes at val scale. ``impl="plain"`` runs
the pure-Python clipper instead, the plain version the library is held to.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# difficulty: (min bbox height px, max occlusion, max truncation)
DIFFICULTY = {
    "easy": (40.0, 0, 0.15),
    "moderate": (25.0, 1, 0.30),
    "hard": (25.0, 2, 0.50),
}

MIN_OVERLAP = {  # per metric, class group: (Car, Pedestrian/Cyclist)
    "bbox": (0.7, 0.5),
    "bev": (0.7, 0.5),
    "3d": (0.7, 0.5),
}


def _clip_polygon(poly: np.ndarray, edge_p1, edge_p2) -> np.ndarray:
    """Clip polygon by the half-plane left of edge p1->p2 (Sutherland-Hodgman)."""
    out = []
    n = len(poly)
    ex, ey = edge_p2[0] - edge_p1[0], edge_p2[1] - edge_p1[1]

    def inside(p):
        return ex * (p[1] - edge_p1[1]) - ey * (p[0] - edge_p1[0]) <= 1e-12

    def intersect(a, b):
        dx, dy = b[0] - a[0], b[1] - a[1]
        denom = ex * dy - ey * dx
        if abs(denom) < 1e-12:
            return b
        t = (ex * (edge_p1[1] - a[1]) - ey * (edge_p1[0] - a[0])) / denom
        return (a[0] + t * dx, a[1] + t * dy)

    for i in range(n):
        cur, nxt = poly[i], poly[(i + 1) % n]
        if inside(cur):
            out.append(tuple(cur))
            if not inside(nxt):
                out.append(intersect(cur, nxt))
        elif inside(nxt):
            out.append(intersect(cur, nxt))
    return np.array(out) if out else np.zeros((0, 2))


def _poly_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def _bev_corners(box) -> np.ndarray:
    """box: (x, z, w, l, ry) -> (4, 2) corners in the BEV (x, z) plane."""
    x, z, w, l, ry = box
    c, s = np.cos(ry), np.sin(ry)
    dx = np.array([l / 2, l / 2, -l / 2, -l / 2])
    dz = np.array([w / 2, -w / 2, -w / 2, w / 2])
    rx = c * dx + s * dz
    rz = -s * dx + c * dz
    return np.stack([x + rx, z + rz], axis=-1)


def bev_overlap(box_a, box_b) -> float:
    """Intersection area of two rotated BEV rectangles."""
    pa, pb = _bev_corners(box_a), _bev_corners(box_b)
    poly = pa
    for i in range(4):
        poly = _clip_polygon(poly, pb[i], pb[(i + 1) % 4])
        if len(poly) == 0:
            return 0.0
    return _poly_area(poly)


def iou_2d(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def iou_bev(a, b) -> float:
    """a, b: (x, z, w, l, ry)."""
    inter = bev_overlap(a, b)
    ua = a[2] * a[3] + b[2] * b[3] - inter
    return inter / ua if ua > 0 else 0.0


def iou_3d(a, b) -> float:
    """a, b: dicts with loc (x,y,z: y = bottom), dim (h,w,l), ry."""
    bev_a = (a["loc"][0], a["loc"][2], a["dim"][1], a["dim"][2], a["ry"])
    bev_b = (b["loc"][0], b["loc"][2], b["dim"][1], b["dim"][2], b["ry"])
    inter_bev = bev_overlap(bev_a, bev_b)
    ya1, ya0 = a["loc"][1], a["loc"][1] - a["dim"][0]
    yb1, yb0 = b["loc"][1], b["loc"][1] - b["dim"][0]
    ih = max(0.0, min(ya1, yb1) - max(ya0, yb0))
    inter = inter_bev * ih
    va = a["dim"][0] * a["dim"][1] * a["dim"][2]
    vb = b["dim"][0] * b["dim"][1] * b["dim"][2]
    union = va + vb - inter
    return inter / union if union > 0 else 0.0


def parse_kitti_line(line: str, with_score: bool) -> Dict:
    p = line.split()
    d = {
        "type": p[0],
        "truncated": float(p[1]),
        "occluded": int(float(p[2])),
        "alpha": float(p[3]),
        "bbox": np.array([float(v) for v in p[4:8]]),
        "dim": np.array([float(v) for v in p[8:11]]),  # h, w, l
        "loc": np.array([float(v) for v in p[11:14]]),
        "ry": float(p[14]),
    }
    d["score"] = float(p[15]) if with_score and len(p) > 15 else 1.0
    return d


def _overlap(metric: str, det: Dict, gt: Dict) -> float:
    if metric == "bbox":
        return iou_2d(det["bbox"], gt["bbox"])
    if metric == "bev":
        return iou_bev(
            (det["loc"][0], det["loc"][2], det["dim"][1], det["dim"][2], det["ry"]),
            (gt["loc"][0], gt["loc"][2], gt["dim"][1], gt["dim"][2], gt["ry"]),
        )
    return iou_3d(det, gt)


# ---------------------------------------------------------------------------
# Batched overlap matrices: the host C++ library, or its plain version
# ---------------------------------------------------------------------------

IMPLS = ("cpp", "plain")
_GEOM_LIB: Optional[ctypes.CDLL] = None


def _geometry() -> ctypes.CDLL:
    """``csrc/geometry.cc``, built at first use; raises if it does not build."""
    global _GEOM_LIB
    if _GEOM_LIB is None:
        from rtm3d_tpu_torch.utils import kernel_build

        lib = kernel_build.load_host("geometry")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.bev_intersection_matrix.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64, f32p]
        lib.bev_intersection_matrix.restype = None
        _GEOM_LIB = lib
    return _GEOM_LIB


def bev_intersection_matrix(a: np.ndarray, b: np.ndarray, impl: str = "cpp") -> np.ndarray:
    """(na,5) x (nb,5) boxes (x, z, w, l, ry) -> (na, nb) float32
    intersection areas, by the C++ library or (``impl="plain"``) the
    pure-Python clipper."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} is not one of {IMPLS}")
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    na, nb = len(a), len(b)
    out = np.zeros((na, nb), np.float32)
    if na == 0 or nb == 0:
        return out
    if impl == "cpp":
        _geometry().bev_intersection_matrix(a, na, b, nb, out)
        return out
    for i in range(na):
        for j in range(nb):
            out[i, j] = bev_overlap(a[i], b[j])
    return out


def _bev5(objs: List[Dict]) -> np.ndarray:
    return np.array(
        [[o["loc"][0], o["loc"][2], o["dim"][1], o["dim"][2], o["ry"]] for o in objs],
        np.float32,
    ).reshape(-1, 5)


def iou_2d_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(na,4) x (nb,4) xyxy boxes -> (na, nb) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    ix = np.clip(
        np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0]),
        0, None,
    )
    iy = np.clip(
        np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1]),
        0, None,
    )
    inter = ix * iy
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def overlap_matrix(metric: str, dets: List[Dict], gts: List[Dict], impl: str = "cpp") -> np.ndarray:
    """All det x gt overlaps of one image in one shot."""
    D, G = len(dets), len(gts)
    if D == 0 or G == 0:
        return np.zeros((D, G), np.float64)
    if metric == "bbox":
        return iou_2d_matrix(
            np.array([o["bbox"] for o in dets], np.float64),
            np.array([o["bbox"] for o in gts], np.float64),
        )
    a, b = _bev5(dets), _bev5(gts)
    inter_bev = bev_intersection_matrix(a, b, impl).astype(np.float64)
    if metric == "bev":
        area_a = (a[:, 2] * a[:, 3]).astype(np.float64)
        area_b = (b[:, 2] * b[:, 3]).astype(np.float64)
        union = area_a[:, None] + area_b[None, :] - inter_bev
        return np.where(union > 0, inter_bev / np.maximum(union, 1e-12), 0.0)
    # 3d: BEV intersection x vertical overlap (loc y = box bottom)
    ha = np.array([o["dim"][0] for o in dets], np.float64)
    hb = np.array([o["dim"][0] for o in gts], np.float64)
    y1a = np.array([o["loc"][1] for o in dets], np.float64)
    y1b = np.array([o["loc"][1] for o in gts], np.float64)
    ih = np.clip(
        np.minimum(y1a[:, None], y1b[None, :])
        - np.maximum((y1a - ha)[:, None], (y1b - hb)[None, :]),
        0, None,
    )
    inter = inter_bev * ih
    va = ha * a[:, 2].astype(np.float64) * a[:, 3].astype(np.float64)
    vb = hb * b[:, 2].astype(np.float64) * b[:, 3].astype(np.float64)
    union = va[:, None] + vb[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


# classes whose gt boxes are "ignored neighbours" when evaluating a class:
# detections matching them count neither TP nor FP (official devkit rule)
NEIGHBOR_CLASSES = {
    "Car": ("Van",),
    "Pedestrian": ("Person_sitting",),
    "Cyclist": (),
}


def evaluate_ap(
    gts: List[List[Dict]],
    dets: List[List[Dict]],
    class_name: str = "Car",
    metric: str = "3d",
    difficulty: str = "moderate",
    with_aos: bool = False,
    min_overlap: float | None = None,
    min_height: float | None = None,
    recall_points: int = 40,
    impl: str = "cpp",
) -> float | Tuple[float, float]:
    """AP_R40 over a dataset. gts/dets: per image lists of parsed objects.

    recall_points selects the recall grid: 40 (the official devkit since
    2019-10-08, linspace(1/40, 1, 40)) or 11 (the legacy devkit grid
    linspace(0, 1, 11) that the upstream RTM3D paper's Tab. 1-4 val numbers
    use — needed to compare against the paper's published AP directly).

    Official-devkit semantics: gt of the class splits into valid (difficulty
    bucket) vs ignored (harder difficulty, or neighbour class: Van for Car,
    Person_sitting for Pedestrian); ignored gt and DontCare regions absorb
    matching detections without counting TP or FP; detections shorter than
    the difficulty's minimum bbox height are ignored (a valid gt they match
    leaves the FN pool but scores no TP — the devkit's ignored-detection
    rule); valid gt is preferred over ignored gt in assignment.

    Single pass: dets processed in descending score order against per-image
    overlap matrices; every det yields one (score, outcome) event and the
    PR curve is cumulative sums over the event list.

    with_aos: also return AOS (average orientation similarity, the official
    devkit's companion metric for the bbox AP): TP events accumulate
    (1+cos(alpha_det - alpha_gt))/2 and the similarity-precision curve is
    swept over the same R40 recall grid. Returns ``(ap, aos)``.

    impl: the BEV overlap's route, ``"cpp"`` (the host library) or
    ``"plain"`` (the pure-Python clipper).
    """
    if with_aos and metric != "bbox":
        # the devkit defines AOS only on 2D bbox matching; a bev/3d "AOS"
        # would be a silently meaningless number
        raise ValueError("with_aos requires metric='bbox' (devkit semantics)")
    # min_overlap overrides the official bar (0.7 Car / 0.5 others), for
    # undertrained checkpoints whose detections sit below the devkit bar
    min_ov = (
        float(min_overlap)
        if min_overlap is not None
        else MIN_OVERLAP[metric][0 if class_name == "Car" else 1]
    )
    neighbors = NEIGHBOR_CLASSES.get(class_name, ())
    # min_height overrides the devkit's difficulty bucket heights
    # (40/25/25 px assume KITTI's 1242x375 frames) — at small synthetic
    # resolutions every gt falls below them and total_valid_gt would be 0.
    gt_min_h, max_occ, max_trunc = DIFFICULTY[difficulty]
    if min_height is not None:
        gt_min_h = float(min_height)

    TP, FP, SHADOW = 0, 1, 2  # SHADOW: valid gt consumed by an ignored det
    events: List = []  # (score, kind)
    total_valid_gt = 0
    for gt_list, det_list in zip(gts, dets):
        valid, ignored, dontcare = [], [], []
        for o in gt_list:
            if o["type"] == class_name:
                in_bucket = (
                    (o["bbox"][3] - o["bbox"][1]) >= gt_min_h
                    and o["occluded"] <= max_occ
                    and o["truncated"] <= max_trunc
                )
                (valid if in_bucket else ignored).append(o)
            elif o["type"] in neighbors:
                ignored.append(o)
            elif o["type"] == "DontCare":
                dontcare.append(o)
        total_valid_gt += len(valid)
        d = sorted(
            (o for o in det_list if o["type"] == class_name),
            key=lambda o: -o["score"],
        )
        if not d:
            continue

        ov_valid = overlap_matrix(metric, d, valid, impl)
        ov_ign = overlap_matrix(metric, d, ignored, impl)
        if dontcare:
            # DontCare clipping: intersection / detection area (devkit
            # semantics — a det fully inside the region is absorbed
            # regardless of the region's size)
            db = np.array([o["bbox"] for o in d], np.float64)
            cb = np.array([o["bbox"] for o in dontcare], np.float64)
            ix = np.clip(
                np.minimum(db[:, None, 2], cb[None, :, 2])
                - np.maximum(db[:, None, 0], cb[None, :, 0]),
                0, None,
            )
            iy = np.clip(
                np.minimum(db[:, None, 3], cb[None, :, 3])
                - np.maximum(db[:, None, 1], cb[None, :, 1]),
                0, None,
            )
            area = np.maximum(
                (db[:, 2] - db[:, 0]) * (db[:, 3] - db[:, 1]), 1e-12
            )
            dc_frac = (ix * iy) / area[:, None]
        else:
            dc_frac = np.zeros((len(d), 0))

        used_valid = np.zeros(len(valid), bool)
        used_ign = np.zeros(len(ignored), bool)
        for i, det in enumerate(d):
            small = (det["bbox"][3] - det["bbox"][1]) < gt_min_h
            # 1) valid gt first (devkit prefers valid over ignored)
            if len(valid):
                cand = np.where(~used_valid & (ov_valid[i] >= min_ov))[0]
                if len(cand):
                    j = cand[np.argmax(ov_valid[i][cand])]
                    used_valid[j] = True
                    sim = 0.5 * (1.0 + np.cos(det["alpha"] - valid[j]["alpha"]))
                    events.append(
                        (det["score"], SHADOW if small else TP, sim)
                    )
                    continue
            # 2) ignored gt absorbs the det (neither TP nor FP)
            if len(ignored):
                cand = np.where(~used_ign & (ov_ign[i] >= min_ov))[0]
                if len(cand):
                    used_ign[cand[np.argmax(ov_ign[i][cand])]] = True
                    continue
            # 3) too-small unmatched det: ignored, never FP
            if small:
                continue
            # 4) DontCare region absorption
            if dc_frac.shape[1] and (dc_frac[i] >= min_ov).any():
                continue
            events.append((det["score"], FP, 0.0))

    if total_valid_gt == 0 or not events:
        return (0.0, 0.0) if with_aos else 0.0

    ev = np.array(sorted(events, key=lambda e: -e[0]), np.float64)
    scores, kinds, sims = ev[:, 0], ev[:, 1], ev[:, 2]
    tp_c = np.cumsum(kinds == TP)
    fp_c = np.cumsum(kinds == FP)
    sh_c = np.cumsum(kinds == SHADOW)
    sim_c = np.cumsum(np.where(kinds == TP, sims, 0.0))
    # only threshold-realisable points: the last index of each tied-score run
    last = np.r_[scores[1:] != scores[:-1], True]
    tp_c, fp_c, sh_c, sim_c = tp_c[last], fp_c[last], sh_c[last], sim_c[last]
    denom_fn = np.maximum(total_valid_gt - sh_c, 1e-12)
    recalls = tp_c / denom_fn
    denom_p = np.maximum(tp_c + fp_c, 1e-12)
    precs = tp_c / denom_p
    sim_precs = sim_c / denom_p
    ap, aos = 0.0, 0.0
    if recall_points == 11:
        grid = np.linspace(0.0, 1.0, 11)  # legacy devkit 0:0.1:1
    else:
        grid = np.linspace(1.0 / recall_points, 1.0, recall_points)
    for r in grid:
        mask = recalls >= r
        ap += (precs[mask].max() if mask.any() else 0.0) / len(grid)
        aos += (sim_precs[mask].max() if mask.any() else 0.0) / len(grid)
    ap = float(min(ap, 1.0))
    if with_aos:
        return ap, float(min(aos, 1.0))
    return ap


def evaluate_directories(gt_dir: str, det_dir: str, image_names: Sequence[str], **kw):
    """``evaluate_ap`` over KITTI label files ``gt_dir/<name>.txt`` and
    result files ``det_dir/<name>.txt`` (a missing result file: no
    detections); ``kw`` goes to ``evaluate_ap``."""
    gts, dets = [], []
    for name in image_names:
        with open(os.path.join(gt_dir, f"{name}.txt")) as f:
            gts.append(
                [parse_kitti_line(l, False) for l in f.read().splitlines() if l]
            )
        det_path = os.path.join(det_dir, f"{name}.txt")
        if os.path.exists(det_path):
            with open(det_path) as f:
                dets.append(
                    [parse_kitti_line(l, True) for l in f.read().splitlines() if l]
                )
        else:
            dets.append([])
    return evaluate_ap(gts, dets, **kw)
