"""Inference entry point: KITTI frames to KITTI result files.

Port of ``rtm3d_tpu/cli/detect.py:35-285`` (the float path) and its
``_save_vis`` (:413-499): reader
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
loader ships raw canvases and the step resamples them on the device.
``--device`` is ``cuda`` by default, and without a GPU the run raises
unless it is given ``--device cpu``.

Under torchrun it serves data-parallel, one process per device
(``rtm3d_tpu/cli/detect.py:197-208``; ``parallel/dist.py``)::

    python -m torch.distributed.run --nproc-per-node N -m rtm3d_tpu_torch.cli.detect ... [--device cpu]

Each data group of ranks serves the strided shard of the frame list on
``cuda:LOCAL_RANK`` (or the CPU) at ``--batch-size / data size`` frames
a batch (which must divide; an export's batch is per rank) and writes
the result files of its real rows; the master prints the summary after
a barrier. ``TPU.MESH_AXES``/``MESH_SHAPE`` lay the ranks out as the
train CLI does (``parallel/dist.py::check_mesh_config``); serving shards
the frames on the data axis only and runs each frame whole on every rank
of its data group, as the JAX CLI replicates them across ``spatial``
(``rtm3d_tpu/cli/detect.py:197-236``, ``parallel/mesh.py:147-158``), and
only the group's spatial index 0 writes. With ``--int8`` the master
calibrates, over the batches one process would, and sends the scales to
every rank, so that every rank serves the same int8 network.

``--int8`` serves the post-training quantized network (``nn/quant.py``,
``rtm3d_tpu/cli/detect.py:44-81,170-195,288-410``): activation scales from
``--calib-scales`` when that file exists, else calibrated (``--calib-method``,
``mse`` by default) over the first ``--calib-batches`` batches of the split
through the detect step's own input stage, on the fp32 network with TF32
off, and saved to ``--calib-scales`` when it is given; then
``TPU.INT8_SKIP`` keeps the matching convs in float. It serves 2D only
unless ``--int8-3d-anyway``. After a calibration, the float-consistency
gate (``--int8-no-gate`` skips it) decodes the calibration batches' real
rows through the float and the int8 step at ``TPU.COMPUTE_DTYPE`` and
matches their 2D detections greedily by class and IoU >= 0.5: one line, a
WARNING under recall 0.9. The JAX export holds no int8 program, so
``--from-export`` with ``--int8`` is refused.
"""

from __future__ import annotations

import argparse
import collections
import copy
import os
import time

import numpy as np
import torch

from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.data.loader import DataLoader, prefetch_to_device
from rtm3d_tpu_torch.eval.kitti_writer import detections_to_lines, write_results
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.parallel import dist
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
    p.add_argument("--int8", action="store_true",
                   help="serve the int8 network (post-training quantized convs, nn/quant.py); 2D only unless "
                   "--int8-3d-anyway: the 3D residual acceptance needs vertex precision int8 features do not carry")
    p.add_argument("--int8-3d-anyway", action="store_true",
                   help="run the 3D solve under --int8 all the same")
    p.add_argument("--int8-no-gate", action="store_true",
                   help="skip the int8-vs-float 2D consistency gate over the calibration batches")
    p.add_argument("--calib-batches", type=int, default=2, help="batches swept for int8 calibration")
    p.add_argument("--calib-method", type=str, default="mse", choices=("mse", "absmax", "p99.9", "p99.99"),
                   help="activation clip: MSE-optimal grid search (default), absmax or a percentile of |x|")
    p.add_argument("--calib-scales", type=str, default=None,
                   help="JSON of activation scales: loaded when it exists, else written after calibration")
    p.add_argument("--from-export", type=str, default=None, help="serve this cli.export artifact")
    p.add_argument("--set", nargs="*", default=[])
    return p.parse_args(argv)


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
    call) and ``wait_s`` (the loop's wait for the batch). Under torchrun
    ``images`` counts every rank's frames, the rest is this rank's."""
    args = parse_args(argv)
    if args.from_export and args.int8:
        raise ValueError("--int8 quantizes the network, and an export holds no int8 program: drop --from-export")
    if not dist.launched():
        return _detect(args, resolve_device(None if args.device == "cuda" else args.device))
    device = dist.init_distributed(None if args.device == "cuda" else args.device)
    try:
        return _detect(args, device)
    finally:
        dist.shutdown()


def _detect(args, device) -> dict:
    cfg = load_config(args.model_config, args.set)
    if args.data_path:
        cfg.DATASET.PATH = args.data_path
    # the device dataset cache is a training optimisation (cli/train.py
    # builds it); serving makes one pass over the frames
    cfg.TPU.DEVICE_DATA_CACHE = False

    ds = create_dataset(cfg.DATASET.PATH, cfg, is_training=False, split=args.split)
    cfg.INPUT_SIZE = tuple(ds.img_size)
    dist.init_mesh(*dist.check_mesh_config(cfg))
    ranks = dist.data_size()
    writes = dist.spatial_index() == 0  # the other ranks of a data group serve the same frames
    asked = dist.local_batch_size(args.batch_size)
    batch_size = min(asked, -(-len(ds) // ranks))
    say = print if dist.is_master() else (lambda *a, **k: None)
    if args.from_export:
        # the checkpoint's weights are baked into the artifact
        from rtm3d_tpu_torch.cli.export import load_exported

        exported = load_exported(args.from_export, device)
        if exported.input_hw != (ds.img_size[1], ds.img_size[0]):
            raise ValueError(f"{args.from_export} takes {exported.input_hw[1]}x{exported.input_hw[0]} frames, "
                             f"the split gives {ds.img_size[0]}x{ds.img_size[1]}")
        if exported.batch != asked:
            say(f"from-export: artifact batch is {exported.batch}, overriding --batch-size")
        batch_size = exported.batch  # its one shape: pad_final fills every batch to it
        detect = make_detect_step_from_export(exported, cfg, device=device)
    else:
        model = create_model(cfg)
        load_detect_weights(args.checkpoint or cfg.DETECTOR.CHECKPOINT, model)
        if args.int8:
            detect = _int8_detect_step(args, cfg, model, ds, batch_size, device)
        else:
            detect = make_detect_step(model, cfg, with_3d=True, device=device)
    loader = DataLoader(
        ds, batch_size, shuffle=False, drop_last=False, num_shards=ranks, shard_index=dist.data_index(),
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
        for bi in range(num_valid if writes else 0):
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
    total = n_img
    if dist.world_size() > 1:
        dist.sync_processes("detect_done")
        total = int(dist.all_reduce_sum(torch.tensor([n_img], device=device), group=dist.data_group()).item())
    say(
        f"detect: {total} images, device {device_s:.2f}s ({n_img / max(device_s, 1e-9):.1f} img/s), "
        f"end-to-end {wall:.2f}s ({n_img / max(wall, 1e-9):.1f} img/s incl. load+write), "
        + (f"{dist.world_size()} ranks (times and rates of rank 0), " if dist.world_size() > 1 else "")
        + (f"a {ranks} x {dist.spatial_size()} data x spatial grid, " if dist.spatial_size() > 1 else "")
        + f"results -> {args.out_dir}"
    )
    return {"images": total, "img_size": list(ds.img_size), "device_s": device_s, "wall_s": wall,
            "device_images_per_s": n_img / max(device_s, 1e-9), "wall_images_per_s": n_img / max(wall, 1e-9),
            "batch_s": batch_s, "wait_s": wait_s}


def _int8_detect_step(args, cfg, model, ds, batch_size: int, device):
    """The int8 detect step (2D only unless ``--int8-3d-anyway``): scales
    loaded or calibrated (``_int8_scales``), ``TPU.INT8_SKIP`` applied, the
    quantized copy of ``model`` served by ``make_detect_step``; then the
    float-consistency gate over the calibration batches, or the notice that
    it was skipped. Under a process group the master loads or calibrates
    the scales, over the batches of one process (``--batch-size`` frames),
    and every rank serves the master's: each rank's own could differ in
    the last bit, and a flipped int8 value travels through the network
    (PERF.md). The master alone runs the gate."""
    from rtm3d_tpu_torch.nn import quant

    if dist.world_size() == 1:
        scales, calib = _int8_scales(args, cfg, model, ds, batch_size, device)
    else:
        scales, calib = (_int8_scales(args, cfg, model, ds, min(args.batch_size, len(ds)), device)
                         if dist.is_master() else (None, None))
        scales = dist.broadcast_object(scales)
    skip = tuple(cfg.TPU.get("INT8_SKIP", ()))
    if skip:
        scales = quant.skip_scales(scales, skip)
    qmodel = quant.quantize_model(model, scales)
    with_3d = args.int8_3d_anyway
    if not with_3d and dist.is_master():
        print("int8: serving 2D-only (the 3D residual gate keeps at most ~41% of float 3D detections under int8, "
              "best of a 4-scheme calibration sweep of the JAX package); pass --int8-3d-anyway to emit 3D "
              "output, or serve bf16")
    if calib and not args.int8_no_gate:
        int8_float_gate(cfg, model, qmodel, calib, device)
    elif not args.int8_no_gate and dist.is_master():
        print("int8 gate skipped (scales loaded from disk; pass --calib-batches without --calib-scales, or run "
              "evaluate --int8-guard for the gt-scored gate)")
    return make_detect_step(qmodel, cfg, with_3d=with_3d, device=device)


def _int8_scales(args, cfg, model, ds, batch_size: int, device):
    """(scales, calib): the scales of ``--calib-scales`` when the file
    exists (calib None), else calibrated over the first ``--calib-batches``
    batches, each through the detect step's input stage (the device warp,
    or the uint8 normalisation), on an fp32 copy of ``model`` on ``device``
    with TF32 off; calib is [(frames, real rows)] for the gate."""
    from rtm3d_tpu_torch.nn import quant
    from rtm3d_tpu_torch.train.step import _detect_inputs

    if args.calib_scales and os.path.exists(args.calib_scales):
        scales = quant.load_act_scales(args.calib_scales)
        print(f"int8: loaded {len(scales)} activation scales from {args.calib_scales}")
        return scales, None
    loader = DataLoader(ds, batch_size, shuffle=False, drop_last=False, num_shards=1, shard_index=0,
                        pad_final=True)
    calib = []
    for batch in loader:
        if len(calib) >= max(args.calib_batches, 1):
            break
        frames, _ = _detect_inputs(batch["image"], batch["calib"].reshape(-1, 3, 3), batch.get("warp"),
                                   batch.get("border"), cfg, device)
        calib.append((frames, int(batch["num_valid"])))
    net = copy.deepcopy(model).to(device=device, dtype=torch.float32).eval()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        scales = quant.calibrate_act_scales(net, [f for f, _ in calib], method=args.calib_method)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del net
    print(f"int8: calibrated {len(scales)} conv activation scales ({args.calib_method}) over {len(calib)} batches")
    if args.calib_scales:
        quant.save_act_scales(args.calib_scales, scales)
    return scales, calib


def int8_float_gate(cfg, model, qmodel, calib, device, iou_thresh: float = 0.5) -> dict:
    """The default serving gate (``rtm3d_tpu/cli/detect.py:341-410``): the
    calibration batches' real rows through the float and the int8 detect
    steps (2D, ``TPU.COMPUTE_DTYPE``), their score-gated 2D detections
    matched greedily one to one by class and IoU >= ``iou_thresh``. Prints
    one line, a WARNING when int8 keeps under 90% of the float detections;
    returns the counts and the recall."""
    from rtm3d_tpu_torch.eval.ap import iou_2d_matrix

    steps = [make_detect_step(m, cfg, with_3d=False, device=device) for m in (model, qmodel)]
    n_float = n_int8 = n_matched = 0
    for frames, nv in calib:
        K = torch.zeros((frames.shape[0], 3, 3), dtype=torch.float32, device=frames.device)
        df, dq = ({k: v.cpu().numpy() for k, v in step(frames, K).items()} for step in steps)
        for bi in range(nv):
            vf, vq = df["valid"][bi], dq["valid"][bi]
            n_float += int(vf.sum())
            n_int8 += int(vq.sum())
            if not (vf.any() and vq.any()):
                continue
            iou = iou_2d_matrix(df["bbox2d"][bi][vf].astype(np.float64), dq["bbox2d"][bi][vq].astype(np.float64))
            iou[df["cls"][bi][vf][:, None] != dq["cls"][bi][vq][None, :]] = 0.0
            while iou.size and iou.max() >= iou_thresh:  # greedy one-to-one by IoU
                i, j = np.unravel_index(np.argmax(iou), iou.shape)
                n_matched += 1
                iou[i, :] = 0.0
                iou[:, j] = 0.0
    recall = n_matched / n_float if n_float else 1.0
    line = (f"int8 gate (float-reference, {len(calib)} calib batches): float 2D detections {n_float}, "
            f"int8 {n_int8}, matched {n_matched} (recall {recall:.2f})")
    if recall < 0.9:
        print(f"WARNING: {line} — int8 is dropping float detections; run evaluate --int8-guard before deploying")
    else:
        print(line)
    return {"float": n_float, "int8": n_int8, "matched": n_matched, "recall": recall}


def save_vis(out_dir: str, cfg, batch, det, bi: int, name: str) -> None:
    """``<name>.png`` (2D boxes, keypoints, 3D boxes on the input frame),
    ``<name>_panel.png`` (the three-row comparison with the ground truth)
    and ``<name>_bev.png`` (bird's-eye view), as the JAX CLI draws them;
    2D-only detections (int8 serving) draw the first alone, without 3D boxes."""
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
    has_3d = "dim" in det
    if acc.any():
        draw_bbox2d(img, det["bbox2d"][bi][acc], det["cls"][bi][acc], det["scores"][bi][acc], names)
        draw_keypoints(img, det["m_proj"][bi][acc])
        for i in np.where(acc)[0] if has_3d else ():
            draw_bbox3d(img, det["dim"][bi][i], det["loc"][bi][i], det["ry"][bi][i], K)
    os.makedirs(out_dir, exist_ok=True)
    image_io.imwrite_png(os.path.join(out_dir, f"{name}.png"), img)
    if not has_3d:
        return  # the panel and the bird's-eye view draw 3D boxes
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
