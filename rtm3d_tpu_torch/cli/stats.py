"""Dataset statistics: the constants the configs carry, from a KITTI tree.

Port of ``rtm3d_tpu/cli/stats.py``. The reference ships these as scripts
whose outputs became config constants: tests/calc_area_of_bbox.py
(``BBOX_AREA_MAX/MIN``, detault.py:27-28) and
tests/calc_vertex_offset_fr_center.py (``VERTEX_OFFSET_INFER``,
detault.py:31). Prints and returns the JAX CLI's JSON: ``BBOX_AREA_MAX``,
``BBOX_AREA_MIN``, ``VERTEX_OFFSET_INFER``, ``num_images`` and
``num_objects``.

``--vis-targets DIR`` writes ``<name>_targets.png`` for the first
``--vis-count`` frames: each frame's target heatmap, built by
``data/targets.py::build_targets`` on the CLI's device (one splat kernel
launch per overlay on the GPU), blended over the frame
(``utils/visual.py::draw_heatmap_overlay``).

    python -m rtm3d_tpu_torch.cli.stats --model-config CFG [--data-path P] [--split train] \\
        [--vis-targets DIR] [--vis-count N] [--set KEY VALUE ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.geometry.projection import proj2d_bbox3d
from rtm3d_tpu_torch.train.step import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser("rtm3d_tpu_torch stats")
    p.add_argument("--model-config", type=str, required=True)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--vis-targets", type=str, default=None,
                   help="write per-image target-heatmap overlays to this directory")
    p.add_argument("--vis-count", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu: where --vis-targets builds targets")
    p.add_argument("--set", nargs="*", default=[])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg = load_config(args.model_config, args.set)
    if args.data_path:
        cfg.DATASET.PATH = args.data_path
    ds = create_dataset(cfg.DATASET.PATH, cfg, is_training=False, split=args.split)
    W, H = ds.img_size

    areas, voffs = [], []
    for i in range(len(ds)):
        lab = ds[i]["labels"]
        m = lab["mask"]
        if not m.any():
            continue
        bbox = lab["bbox"][m]
        # normalised area (calc_area_of_bbox.py semantics)
        nb = bbox / np.array([W, H, W, H])
        areas.append((nb[:, 2] - nb[:, 0]) * (nb[:, 3] - nb[:, 1]))
        # vertex offsets from the 2D centre, normalised (calc_vertex_offset_fr_center.py)
        uv, _, m3 = proj2d_bbox3d(*(torch.from_numpy(np.ascontiguousarray(lab[k][m])) for k in ("dim", "loc", "ry")),
                                  torch.from_numpy(np.ascontiguousarray(lab["K"][m].reshape(-1, 3, 3))))
        verts = uv.numpy().transpose(0, 2, 1)[:, :8]
        centers = (bbox[:, 0:2] + bbox[:, 2:4]) * 0.5
        off = np.abs(verts - centers[:, None, :]) / np.array([W, H])
        voffs.append(off[m3.numpy()])

    areas = np.concatenate(areas) if areas else np.zeros(1)
    voffs = np.concatenate(voffs).reshape(-1, 2) if voffs else np.zeros((1, 2))
    out = {
        "BBOX_AREA_MAX": float(areas.max()),
        "BBOX_AREA_MIN": float(areas.min()),
        "VERTEX_OFFSET_INFER": [float(voffs[:, 0].max()), float(voffs[:, 1].max())],
        "num_images": len(ds),
        # kept as the JAX CLI computes it (rtm3d_tpu/cli/stats.py:73): the
        # number of areas, so a tree with no object counts 1, the length of
        # the placeholder above
        "num_objects": int(sum(len(a) for a in [areas])),
    }
    print(json.dumps(out, indent=2))
    if args.vis_targets:
        out["overlays"] = write_target_overlays(args, cfg, device)
    return out


def write_target_overlays(args, cfg, device) -> list:
    """One overlay per frame of the first ``--vis-count``; returns their
    paths."""
    from rtm3d_tpu_torch.data import image_io
    from rtm3d_tpu_torch.data.targets import build_targets
    from rtm3d_tpu_torch.utils.visual import denormalize, draw_heatmap_overlay

    os.makedirs(args.vis_targets, exist_ok=True)
    # frames resampled on the host: in device-warp raw mode the reader ships
    # the source frame while the labels live in the warped one
    vcfg = cfg.clone()
    vcfg.TPU.DEVICE_WARP = False
    vcfg.TPU.DEVICE_DATA_CACHE = False
    ds = create_dataset(vcfg.DATASET.PATH, vcfg, is_training=False, split=args.split)
    W, H = ds.img_size
    down = int(cfg.MODEL.DOWN_SAMPLE)
    paths = []
    for i in range(min(args.vis_count, len(ds))):
        s = ds[i]
        img = s["image"]
        if img.dtype != np.uint8:
            img = denormalize(img, np.array(cfg.DATASET.MEAN), np.array(cfg.DATASET.STD))
        labels = {k: torch.from_numpy(np.asarray(v)[None]).to(device) for k, v in s["labels"].items()}
        # the train step's target parameters (train/step.py)
        t = build_targets(labels, (H // down, W // down), len(cfg.DATASET.OBJs), down_ratio=float(down),
                          gaussian_gen_type=cfg.DATASET.GAUSSIAN_GEN_TYPE,
                          bbox_area_max=cfg.DATASET.BBOX_AREA_MAX, bbox_area_min=cfg.DATASET.BBOX_AREA_MIN)
        overlay = draw_heatmap_overlay(img, t["m_hm"][0].permute(1, 2, 0).cpu().numpy())
        name = os.path.splitext(os.path.basename(s["path"]))[0]
        paths.append(os.path.join(args.vis_targets, f"{name}_targets.png"))
        image_io.imwrite_png(paths[-1], overlay)
    print(f"target overlays -> {args.vis_targets}")
    return paths


if __name__ == "__main__":
    main()
