"""Training entry point: KITTI files to checkpoints.

Port of ``rtm3d_tpu/cli/train.py:46-274``: reader (``data/kitti.py``) ->
augmentation -> loader workers (``data/loader.py``) -> pinned,
side-stream copy to the GPU -> train step (targets by the splat kernel)
-> eval-loss epoch -> checkpoints -> resume.

    python -m rtm3d_tpu_torch.cli.train --model-config configs/rtm3d_dla34_kitti.yaml \\
        [--data-path PATH] [--num-epochs N] [--batch-size B] [--set KEY VALUE ...] [--device cpu]

The flags are the JAX CLI's plus ``--device``, ``cuda`` by default;
without a GPU the run raises unless it is given ``--device cpu``.

``--multihost`` trains data-parallel, one process per device, under
torchrun (``parallel/dist.py``; the JAX CLI's flag, :54-58, 114-115)::

    python -m torch.distributed.run --nproc-per-node N -m rtm3d_tpu_torch.cli.train --multihost \\
        --model-config ... [--device cpu]

Each rank runs on ``cuda:LOCAL_RANK`` (NCCL) or, with ``--device cpu``,
on the CPU (gloo); ``BATCH_SIZE`` is the global batch. ``TPU.MESH_AXES``/
``MESH_SHAPE`` lay the ranks out as a data x spatial grid, as the JAX CLI
builds its mesh (:126; ``parallel/dist.py::check_mesh_config``, which
refuses with a message a mesh the port cannot run): each data group
loads its strided shard of every epoch at ``BATCH_SIZE / data size``
(which must divide), and with a ``spatial`` axis the ranks of a data
group load the same frames and each trains on its band of their rows
(``parallel/spatial.py``). The warm-up collective runs before the first
step. The losses, and so the best-model decision, are the global batch's
on every rank. The master alone prints, writes TensorBoard and saves
``.pt`` files; under ``TRAINING.USE_ORBAX`` every rank writes the
collective directory saves (``train/checkpoint.py``).

``TRAINING.CHECKPOINT_MODE`` is ``start``, ``resume`` (from the
``last_checkpoint`` pointer under ``TRAINING.WEIGHTS/<BACKBONE>``, when
there is one) or ``pretrained`` (a ``.pt``/``.pth``/``.pkl`` file in
``TRAINING.CHECKPOINT_FILE``, a whole model or a part of one such as an
ImageNet backbone, imported by longest-suffix name matching as the JAX CLI
does, :162-171). Under ``pretrained`` an empty ``CHECKPOINT_FILE`` trains
from init, and a named file that does not exist warns and trains from
init, as the JAX CLI does; a named file of any other suffix raises, where
the JAX CLI skips it without a word.

Resume is exact: the model's parameters and BN buffers, the optimizer
state, the EMA shadow, ``step`` and ``updates`` come back bit for bit, and
the LR schedule is a function of ``updates`` alone, so no step is taken
twice. Under ``WarmupCosineLR`` the schedule also divides by ``max_iters =
MAX_EPOCH x steps_per_epoch``: a resumed run is bit-exact there only with
the same ``SOLVER.MAX_EPOCH`` and the same train split.

TensorBoard scalars are written under ``TRAINING.LOGDIR`` when the package
is importable and ``LOGDIR`` is not empty, as the JAX CLI does (:199-208).
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from rtm3d_tpu_torch.config import load_config
from rtm3d_tpu_torch.data.kitti import create_dataset
from rtm3d_tpu_torch.data.loader import DataLoader, prefetch_to_device
from rtm3d_tpu_torch.nn.model import create_model
from rtm3d_tpu_torch.parallel import dist
from rtm3d_tpu_torch.train.checkpoint import CheckPointer, import_reference_weights, load_torch_weights
from rtm3d_tpu_torch.train.state import TrainState
from rtm3d_tpu_torch.train.step import make_eval_loss_step, make_train_step, resolve_device

LOSS_NAMES = ["MKF", "VFM", "M_OFF", "V_OFF", "total"]
MODES = ("start", "resume", "pretrained")


def parse_args(argv=None):
    p = argparse.ArgumentParser("rtm3d_tpu_torch train")
    p.add_argument("--model-config", type=str, required=True)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--num-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--test-interval", type=int, default=1)
    p.add_argument("--seed", type=int, default=20)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel over the ranks of torchrun (one process per device)")
    p.add_argument("--set", nargs="*", default=[], help="dotted config overrides")
    return p.parse_args(argv)


def setup(args):
    """Mirrors train.py:34-58."""
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    cfg = load_config(args.model_config, args.set)
    if args.data_path:
        cfg.DATASET.PATH = args.data_path
    if args.num_epochs:
        cfg.SOLVER.MAX_EPOCH = args.num_epochs
    if args.batch_size:
        cfg.BATCH_SIZE = args.batch_size
    return cfg


def run_eval_epoch(eval_step, state, loader, device, image_cache=None) -> np.ndarray:
    """Equal-weight mean of per-batch losses over true samples only: the
    wrap-around rows ``pad_final`` adds to the last batch are left out of
    every sum and count by the batch's ``sample_valid`` (reference
    test_epoch, train.py:61-81)."""
    losses = [eval_step(state, b, image_cache)["loss_items"] for b in prefetch_to_device(iter(loader), device)]
    return torch.stack(losses).mean(0).cpu().numpy() if losses else np.zeros(5)


def build_image_cache(ds, device):
    """The device dataset cache (TPU.DEVICE_DATA_CACHE): every raw frame on
    the device after one copy; per step the host then ships labels and
    affine scalars only. None when the dataset does not use it."""
    if not getattr(ds, "device_cache", False):
        return None
    arr = ds.canvas_array()
    cache = torch.from_numpy(arr).to(device)
    if dist.is_master():
        print(f"device data cache: {arr.nbytes / 1e9:.2f} GB resident on {device}")
    return cache


def _model_state(cfg, seed: int, device, max_iters: int, say=print):
    model = create_model(cfg, torch.Generator().manual_seed(seed))
    mode = str(cfg.TRAINING.CHECKPOINT_MODE).lower()
    if mode not in MODES:
        raise ValueError(f"TRAINING.CHECKPOINT_MODE {cfg.TRAINING.CHECKPOINT_MODE!r} is not one of {MODES}")
    if mode == "pretrained":
        path = str(cfg.TRAINING.CHECKPOINT_FILE or "")
        if path and not path.endswith((".pt", ".pth", ".pkl")):
            raise ValueError(f"pretrained weights must be a .pt, .pth or .pkl file, got {path!r}")
        if not path:
            say("pretrained: no TRAINING.CHECKPOINT_FILE; training from init")
        elif not os.path.exists(path):
            say(f"WARNING: pretrained weights {path} not found; training from init")
        else:
            report = import_reference_weights(model, load_torch_weights(path)[0])
            say(f"imported {len(report['loaded'])} tensors from {path}; {len(report['missed'])} missed")
    return mode, TrainState.create(model, cfg, device=device, max_iters=max_iters)


def main(argv=None, *, on_start=None):
    """Train; returns a summary: ``state``, ``img_size``, ``start_epoch``,
    ``cache_bytes`` and ``history``, one record an epoch (losses, steps,
    ``num_targets`` per step, wall seconds of the train loop, loader
    included; on a GPU, ``step_span_ms``: each step's span on the stream
    from CUDA events, host waits inside the step included; the seconds
    each batch took to build, and the seconds the loop waited for it; the
    eval batches run).

    ``on_start(state, start_epoch)`` is a test seam, not a user option:
    it is called once the state is built or restored, before the first
    step, so that a check (``chip_smoke.py``'s resume gate,
    ``tests/test_torch_train_cli.py``) can compare the state this run
    restored with the tensors saved before it.

    With ``--multihost`` it joins the process group first and leaves it
    on return; the summary is this rank's (its losses the global batch's)."""
    args = parse_args(argv)
    if not args.multihost:
        return _train(args, resolve_device(None if args.device == "cuda" else args.device), on_start)
    device = dist.init_distributed(None if args.device == "cuda" else args.device)
    try:
        return _train(args, device, on_start)
    finally:
        dist.shutdown()


def _train(args, device, on_start):
    cfg = setup(args)
    master = dist.is_master()
    say = print if master else (lambda *a, **k: None)

    train_ds = create_dataset(cfg.DATASET.PATH, cfg, is_training=True, split="train")
    test_ds = create_dataset(cfg.DATASET.PATH, cfg, is_training=False, split="test")
    # the dataset's rect size is the network's input; the test split takes
    # the train split's, so both steps see one shape
    cfg.INPUT_SIZE = tuple(train_ds.img_size)
    test_ds.img_size = list(train_ds.img_size)
    grid = dist.check_mesh_config(cfg)  # the bands need the rect size
    dist.init_mesh(*grid)

    workers = int(cfg.get("num_workers", 0))
    batch = dist.local_batch_size(int(cfg.BATCH_SIZE))
    shards = {"num_shards": dist.data_size(), "shard_index": dist.data_index()}
    train_loader = DataLoader(train_ds, batch, shuffle=True, seed=args.seed, num_workers=workers, **shards)
    # a full batch even when the split is shorter: pad_final wraps the tail
    test_loader = DataLoader(test_ds, batch, shuffle=False, drop_last=False, pad_final=True, num_workers=workers,
                             **shards)

    steps_per_epoch = max(len(train_loader), 1)
    mode, state = _model_state(cfg, args.seed, device, cfg.SOLVER.MAX_EPOCH * steps_per_epoch, say)
    w, h = cfg.INPUT_SIZE
    n_params = sum(p.numel() for p in state.model.parameters())
    say(f"model: {cfg.MODEL.BACKBONE}, params: {n_params / 1e6:.2f}M, input {w}x{h}, device {device}"
        + (f", {dist.world_size()} ranks, {batch} rows each" if dist.world_size() > 1 else "")
        + (f", a {grid[0]} x {grid[1]} data x spatial grid" if grid[1] > 1 else ""))

    checkpointer = CheckPointer(os.path.join(cfg.TRAINING.WEIGHTS, cfg.MODEL.BACKBONE),
                                use_orbax=bool(cfg.TRAINING.get("USE_ORBAX", False)))
    start_epoch, min_loss = 0, math.inf
    if mode == "resume" and checkpointer.has_checkpoint():
        state, meta = checkpointer.load(state, use_latest=True)
        start_epoch = int(meta.get("epoch", -1)) + 1
        min_loss = float(meta.get("min_loss", math.inf))
        say(f"resumed from epoch {start_epoch}, min_loss {min_loss:.4f}")

    train_step = make_train_step(cfg, device=device)
    eval_step = make_eval_loss_step(cfg, device=device)
    train_cache = build_image_cache(train_ds, device)
    test_cache = build_image_cache(test_ds, device)
    cache_bytes = sum(c.numel() for c in (train_cache, test_cache) if c is not None)

    tb_writer = None
    if master and cfg.TRAINING.LOGDIR:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(os.path.join(cfg.TRAINING.LOGDIR, cfg.MODEL.BACKBONE))
        except ImportError:
            pass

    if on_start is not None:
        on_start(state, start_epoch)
    dist.warmup_collectives(device)
    timed = device.type == "cuda"
    history = []
    for epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        train_loader.set_epoch(epoch)
        mloss, ntgt, events, waits = np.zeros(5), [], [], []
        t_ep = t_wait = time.perf_counter()
        for i, b in enumerate(prefetch_to_device(iter(train_loader), device)):
            waits.append(time.perf_counter() - t_wait)
            if timed:
                events.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            state, metrics = train_step(state, b, train_cache)
            if timed:
                events[-1][1].record()
            items = metrics["loss_items"].detach().cpu().numpy()
            if not np.isfinite(items[-1]):
                # non-finite loss abort (train.py:97-99)
                say(f"WARNING: non-finite loss {items}, aborting epoch")
                break
            mloss = (mloss * i + items) / (i + 1)
            ntgt.append(int(metrics["num_targets"]))
            if tb_writer is not None:
                for name, v in zip(LOSS_NAMES, items):
                    tb_writer.add_scalar(f"loss/{name}", float(v), state.step)
            if i % 10 == 0:
                say(f"epoch {epoch} it {i}/{steps_per_epoch} "
                    + " ".join(f"{n}={v:.4f}" for n, v in zip(LOSS_NAMES, mloss))
                    + f" lr={state.schedule(state.updates):.2e} ntgt={ntgt[-1]}")
            t_wait = time.perf_counter()
        train_wall_s = time.perf_counter() - t_ep
        record = {
            "epoch": epoch, "steps": len(ntgt), "train_loss": mloss.tolist(), "num_targets": ntgt,
            "train_wall_s": train_wall_s, "build_s": list(train_loader.build_seconds), "wait_s": waits,
            "step_span_ms": [a.elapsed_time(z) for a, z in events] if timed else None,
            "eval_loss": None, "eval_batches": 0,
        }

        test_items = mloss
        if (epoch + 1) % args.test_interval == 0 and len(test_loader) > 0:
            test_items = run_eval_epoch(eval_step, state, test_loader, device, image_cache=test_cache)
            record["eval_loss"], record["eval_batches"] = test_items.tolist(), len(test_loader)
            say(f"epoch {epoch} test: " + " ".join(f"{n}={v:.4f}" for n, v in zip(LOSS_NAMES, test_items))
                + f" ({time.perf_counter() - t_ep:.1f}s)")
        history.append(record)

        # a checkpoint every epoch, and the best by test loss (train.py:158-162);
        # a non-finite test loss never counts as the best. The test loss is
        # the global batch's on every rank, so every rank decides alike
        test_total = float(test_items[-1])
        checkpointer.save(f"model_{epoch:07d}", state, epoch=epoch, min_loss=min_loss)
        if math.isfinite(test_total) and test_total < min_loss:
            min_loss = test_total
            checkpointer.save("model_best", state, epoch=epoch, min_loss=min_loss)
    if tb_writer is not None:
        tb_writer.close()
    return {"state": state, "img_size": list(train_ds.img_size), "start_epoch": start_epoch,
            "cache_bytes": cache_bytes, "history": history}


if __name__ == "__main__":
    main()
