"""Inference entry point: KITTI frames to KITTI result files.

Port of ``rtm3d_tpu/cli/detect.py:35-285`` (the float path) and its
``_save_vis`` (:413-499), for one process on one GPU: reader
(``data/kitti.py``) -> loader (``data/loader.py``, a padded final batch)
-> pinned side-stream copy of the next batch while this one runs ->
detect step (network, decode, the LM kernel twice) -> 2D boxes mapped back
to each original frame -> one KITTI result file per image
(``eval/kitti_writer.py``), and with ``--save-vis`` three drawings per image
(``utils/visual.py``).

    python -m rtm3d_tpu_torch.cli.detect --model-config configs/rtm3d_dla34_kitti.yaml \\
        [--data-path P] [--split test] [--out-dir results] [--save-vis DIR] \\
        [--checkpoint CKPT | --from-export ART] [--batch-size N] [--set KEY VALUE ...] [--device cpu]

``--checkpoint`` (else ``DETECTOR.CHECKPOINT``): a flax msgpack file of the
JAX package, a ``CheckPointer`` file of the port or a reference ``.pt``
(``train.checkpoint.load_detect_weights``). ``--from-export ART`` serves an
artifact of ``cli/export.py`` instead: no model is built and no weights are
loaded, the artifact's batch overrides ``--batch-size`` (the loader pads
the last batch, and a split shorter than it, to that batch) and its input
size must be the split's. Under ``TPU.DEVICE_WARP`` the
loader ships raw canvases and the step resamples them on the device. The
port serves on one device; ``--device`` is ``cuda`` by default, and without
a GPU the run raises unless it is given ``--device cpu``.

Not ported yet, and raising ``NotImplementedError`` (ROADMAP.md, queue A):
``--int8`` and its options (int8 PTQ).
"""

from __future__ import annotations

import argparse
import collections
import os
import time

import numpy as np

from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.data.loader import DataLoader, prefetch_to_device
from rtm3d_tpu_torch.eval.kitti_writer import detections_to_lines, write_results
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.train.checkpoint import load_detect_weights
from rtm3d_tpu_torch.train.step import make_detect_step, make_detect_step_from_export, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser("rtm3d_tpu_torch detect")
    p.add_argument("--model-config", type=str, required=True)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--out-dir", type=str, default="./results")
    p.add_argument("--save-vis", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    # the JAX CLI's int8 options: not ported yet, they raise
    p.add_argument("--int8", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--int8-3d-anyway", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--int8-no-gate", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--calib-batches", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--calib-method", type=str, default=None, help=argparse.SUPPRESS)
    p.add_argument("--calib-scales", type=str, default=None, help=argparse.SUPPRESS)
    p.add_argument("--from-export", type=str, default=None, help="serve this cli.export artifact")
    p.add_argument("--set", nargs="*", default=[])
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    int8 = [f for f, on in (("--int8", args.int8), ("--int8-3d-anyway", args.int8_3d_anyway),
                            ("--int8-no-gate", args.int8_no_gate), ("--calib-batches", args.calib_batches),
                            ("--calib-method", args.calib_method), ("--calib-scales", args.calib_scales)) if on]
    if int8:
        raise NotImplementedError(f"{', '.join(int8)}: int8 serving is not ported yet (ROADMAP.md, queue A: int8 PTQ)")


def original_frame_boxes(bbox2d: np.ndarray, shape, resize_max_side: int, img_size) -> np.ndarray:
    """(K, 4) xyxy boxes of the resized and padded input frame, mapped back
    to the original ``shape`` = (w0, h0) frame and clipped to it, as
    ``rtm3d_tpu/cli/detect.py:255-269`` maps them (KITTI scores original
    pixels; the 3D quantities are already in the camera frame)."""
    w0, h0 = (int(v) for v in shape)
    r = resize_max_side / max(w0, h0) if max(w0, h0) else 1.0
    nw, nh = int(w0 * r), int(h0 * r)
    pad_w = (img_size[0] - nw) // 2
    pad_h = (img_size[1] - nh) // 2
    b2 = bbox2d.copy()
    b2[:, 0::2] = (b2[:, 0::2] - pad_w) / r
    b2[:, 1::2] = (b2[:, 1::2] - pad_h) / r
    b2[:, 0::2] = b2[:, 0::2].clip(0, w0 - 1)
    b2[:, 1::2] = b2[:, 1::2].clip(0, h0 - 1)
    return b2


def main(argv=None) -> dict:
    """Detect over a split and write its result files. Returns a summary:
    ``images``, ``img_size``, ``device_s`` (the detect calls, each ending in
    the copy of its outputs to the host) and ``wall_s`` (loader, copies and
    writes included) with their images/s, and per batch ``batch_s`` (each
    call) and ``wait_s`` (the loop's wait for the batch)."""
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg = load_config(args.model_config, args.set)
    if args.data_path:
        cfg.DATASET.PATH = args.data_path
    # the device dataset cache is a training optimisation (cli/train.py
    # builds it); serving makes one pass over the frames
    cfg.TPU.DEVICE_DATA_CACHE = False

    ds = create_dataset(cfg.DATASET.PATH, cfg, is_training=False, split=args.split)
    cfg.INPUT_SIZE = tuple(ds.img_size)
    batch_size = min(args.batch_size, len(ds))
    if args.from_export:
        # the checkpoint's weights are baked into the artifact
        from rtm3d_tpu_torch.cli.export import load_exported

        exported = load_exported(args.from_export, device)
        if exported.input_hw != (ds.img_size[1], ds.img_size[0]):
            raise ValueError(f"{args.from_export} takes {exported.input_hw[1]}x{exported.input_hw[0]} frames, "
                             f"the split gives {ds.img_size[0]}x{ds.img_size[1]}")
        if exported.batch != args.batch_size:
            print(f"from-export: artifact batch is {exported.batch}, overriding --batch-size")
        batch_size = exported.batch  # its one shape: pad_final fills every batch to it
        detect = make_detect_step_from_export(exported, cfg, device=device)
    else:
        model = create_model(cfg)
        load_detect_weights(args.checkpoint or cfg.DETECTOR.CHECKPOINT, model)
        detect = make_detect_step(model, cfg, with_3d=True, device=device)
    loader = DataLoader(
        ds, batch_size, shuffle=False, drop_last=False, num_shards=1, shard_index=0,
        pad_final=True,  # one batch shape; the padded tail is skipped below
        num_workers=int(cfg.get("num_workers", 0)),
    )

    # the device takes the frames, K and the warp scalars; the host keeps
    # the batch for the writer (paths, shapes, labels for the drawings)
    hosted = collections.deque()

    def staged():
        for batch in loader:
            hosted.append(batch)
            arrays = {"image": batch["image"], "K": batch["calib"].reshape(-1, 3, 3).astype(np.float32)}
            if "warp" in batch:  # device-warp raw mode (TPU.DEVICE_WARP)
                arrays.update(warp=batch["warp"], border=batch["border"])
            yield arrays

    names = list(cfg.DATASET.OBJs)
    n_img, batch_s, wait_s = 0, [], []
    t_wall = t_wait = time.perf_counter()
    for arrays in prefetch_to_device(staged(), device):
        batch = hosted.popleft()
        t0 = time.perf_counter()
        wait_s.append(t0 - t_wait)
        det = detect(arrays["image"], arrays["K"], warp=arrays.get("warp"), border=arrays.get("border"))
        det = {k: v.cpu().numpy() for k, v in det.items()}
        batch_s.append(time.perf_counter() - t0)
        num_valid = int(batch["num_valid"])  # the padded tail is not written
        for bi in range(num_valid):
            name = os.path.splitext(os.path.basename(batch["path"][bi]))[0]
            # single-row views, with the boxes in the original frame
            det_i = {k: v[bi : bi + 1] for k, v in det.items()}
            det_i["bbox2d"] = original_frame_boxes(det["bbox2d"][bi], batch["shape"][bi], ds.resize_max_side,
                                                   ds.img_size)[None]
            write_results(args.out_dir, name, detections_to_lines(det_i, names, 0))
            if args.save_vis:
                save_vis(args.save_vis, cfg, batch, det, bi, name)
        n_img += num_valid
        t_wait = time.perf_counter()
    wall = time.perf_counter() - t_wall
    device_s = sum(batch_s)
    print(
        f"detect: {n_img} images, device {device_s:.2f}s ({n_img / max(device_s, 1e-9):.1f} img/s), "
        f"end-to-end {wall:.2f}s ({n_img / max(wall, 1e-9):.1f} img/s incl. load+write), "
        f"results -> {args.out_dir}"
    )
    return {"images": n_img, "img_size": list(ds.img_size), "device_s": device_s, "wall_s": wall,
            "device_images_per_s": n_img / max(device_s, 1e-9), "wall_images_per_s": n_img / max(wall, 1e-9),
            "batch_s": batch_s, "wait_s": wait_s}


def save_vis(out_dir: str, cfg, batch, det, bi: int, name: str) -> None:
    """``<name>.png`` (2D boxes, keypoints, 3D boxes on the input frame),
    ``<name>_panel.png`` (the three-row comparison with the ground truth)
    and ``<name>_bev.png`` (bird's-eye view), as the JAX CLI draws them."""
    from rtm3d_tpu_torch.data import image_io
    from rtm3d_tpu_torch.utils.visual import (
        compose_detection_panel, denormalize, draw_bbox2d, draw_bbox3d, draw_birdview, draw_keypoints,
    )

    raw = batch["image"][bi]
    if "warp" in batch:
        # the device-warp mode ships the source canvas; the frame the device
        # computed is rebuilt for display by the same affine on the host
        sx, sy, tx, ty, w0, h0 = (float(v) for v in batch["warp"][bi])
        M = np.array([[sx, 0, tx], [0, sy, ty]], np.float64)
        img = image_io.warp_affine_linear(raw[: int(h0), : int(w0)], M, tuple(cfg.INPUT_SIZE), batch["border"][bi])
    elif raw.dtype == np.uint8:
        img = raw.copy()
    else:
        img = denormalize(raw, np.array(cfg.DATASET.MEAN), np.array(cfg.DATASET.STD)).copy()
    base = img.copy()  # clean frame for the comparison panel
    K = batch["calib"][bi].reshape(3, 3)
    acc = det["accepted"][bi]
    names = list(cfg.DATASET.OBJs)
    if acc.any():
        draw_bbox2d(img, det["bbox2d"][bi][acc], det["cls"][bi][acc], det["scores"][bi][acc], names)
        draw_keypoints(img, det["m_proj"][bi][acc])
        for i in np.where(acc)[0]:
            draw_bbox3d(img, det["dim"][bi][i], det["loc"][bi][i], det["ry"][bi][i], K)
    os.makedirs(out_dir, exist_ok=True)
    image_io.imwrite_png(os.path.join(out_dir, f"{name}.png"), img)
    labels = batch["labels"]
    m = labels["mask"][bi]
    gt3d = list(zip(labels["dim"][bi][m], labels["loc"][bi][m], labels["ry"][bi][m]))
    panel = compose_detection_panel(base, det, bi, K, names, gt=gt3d)
    image_io.imwrite_png(os.path.join(out_dir, f"{name}_panel.png"), panel)
    boxes = [(float(det["loc"][bi][i][0]), float(det["loc"][bi][i][2]), float(det["dim"][bi][i][1]),
              float(det["dim"][bi][i][2]), float(det["ry"][bi][i])) for i in np.where(acc)[0]]
    gts = [(float(l[0]), float(l[2]), float(d[1]), float(d[2]), float(r)) for d, l, r in gt3d]
    image_io.imwrite_png(os.path.join(out_dir, f"{name}_bev.png"), draw_birdview(boxes, gts=gts))


if __name__ == "__main__":
    main()
