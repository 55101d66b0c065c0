"""Data parallelism over processes: one process per device, torch.distributed.

Port of ``rtm3d_tpu/parallel/mesh.py`` in torch's idiom. The JAX package
runs one program over a ``data`` mesh and XLA inserts the collectives;
here each process (rank) holds a replica of the train state and its own
rows of the global batch, and the collectives are explicit, in three
places: BatchNorm's batch statistics (``nn/layers.py``), the loss's
counts (``losses/rtm3d_loss.py``) and the gradients (``train/step.py``).
Every helper here is a no-op, or the identity, when no process group of
more than one rank is initialised, so a single-process run takes the
path it took before this module existed.

Launch with torchrun, which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
and ``MASTER_ADDR``/``MASTER_PORT``::

    python -m torch.distributed.run --nproc-per-node N -m rtm3d_tpu_torch.cli.train --multihost ...

Not ported, and why:
- ``create_mesh_for_batch``'s device trimming (mesh.py:40-83): a rank
  cannot be left out of a process group, so a global batch that the
  world size does not divide raises (``local_batch_size``);
- ``shard_batch``, ``_put``, ``device_batch`` (mesh.py:97-140): each rank
  loads and holds its own rows (``DataLoader(num_shards=world_size(),
  shard_index=rank())``);
- the ``spatial`` axis (mesh.py:11-14, 87-94): torch has no stock spatial
  partitioning of convolutions with halo exchange (ROADMAP.md). A config
  that asks for it through ``TPU.MESH_AXES``/``MESH_SHAPE`` is refused by
  ``check_mesh_config``, which both CLIs call, and not run as something
  else without a word.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the default process group; 1 when none is initialised."""
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_master() -> bool:
    """The reference's is_master_node (train_multi_gpu.py:71-72)."""
    return rank() == 0


def launched() -> bool:
    """True when the process was started by torchrun (or anything that
    sets its ``RANK`` and ``WORLD_SIZE``)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def device_for_rank(device=None) -> torch.device:
    """``cuda:LOCAL_RANK`` unless the caller names a device (``cuda``
    without an index is ``cuda:LOCAL_RANK`` too)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def init_distributed(device=None, backend: str | None = None, *, init_method: str = "env://",
                     rank: int | None = None, world_size: int | None = None,
                     timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group and return this rank's device.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``; ``init_method`` to its ``MASTER_ADDR``/``MASTER_PORT``
    (``env://``). The device is ``device_for_rank(device)``; the backend
    NCCL on a CUDA device and gloo on the CPU, unless ``backend`` names
    one (two ranks on one card must share it over gloo: NCCL refuses
    that). A CUDA device becomes this process's current device. A failed
    initialisation raises; there is no fallback to one process."""
    if initialized():
        raise RuntimeError("a default process group is already initialised")
    dev = device_for_rank(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{dev} was asked for and no CUDA device is available; pass --device cpu")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


def shutdown() -> None:
    """Leave the default process group, if one is initialised."""
    if initialized():
        dist.destroy_process_group()


def check_mesh_config(cfg) -> None:
    """Refuse a mesh the port cannot run: ``TPU.MESH_AXES`` other than
    ``("data",)``, or a ``TPU.MESH_SHAPE`` other than ``(-1,)`` (every
    device) or ``(world size,)``. The JAX CLIs build their mesh from both
    keys (``rtm3d_tpu/cli/train.py:126``, ``cli/detect.py:206``) and can
    shard the frame's rows on a ``spatial`` axis (``parallel/mesh.py:
    88-94``); the port's only parallelism is data parallelism over the
    ranks of torchrun, so any other mesh raises ``ValueError``."""
    axes = tuple(str(a) for a in cfg.TPU.get("MESH_AXES", ("data",)))
    shape = tuple(int(s) for s in cfg.TPU.get("MESH_SHAPE", (-1,)))
    n = world_size()
    if axes != ("data",) or shape not in ((-1,), (n,)):
        raise ValueError(
            f"TPU.MESH_AXES {axes} with TPU.MESH_SHAPE {shape} is not supported: the port runs data parallelism "
            f"only, one process per device under torchrun (world size here {n}), and the 'spatial' axis of the "
            "JAX package (rtm3d_tpu/parallel/mesh.py) is not ported. Use MESH_AXES ('data',) with MESH_SHAPE "
            f"(-1,) or ({n},).")


def local_batch_size(global_batch: int) -> int:
    """This rank's share of the global batch (mesh.py:210-216; the
    reference divides BATCH_SIZE by the GPU count, model_factory.py:61-62).
    Raises ``ValueError`` when the world size does not divide it."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"the global batch {global_batch} is not divisible by the world size {n}")
    return global_batch // n


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, in place, returned; ``t`` itself
    when there is one rank."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


def broadcast_object(obj):
    """The master's ``obj`` (any picklable object), on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def sync_processes(name: str) -> None:
    """A barrier over every rank (mesh.py:193-202); a no-op with one rank.
    ``name`` says in a hang's traceback which barrier it was."""
    del name
    if world_size() > 1:
        dist.barrier()


def warmup_collectives(device) -> None:
    """One tiny ``all_reduce`` on ``device``, waited for (mesh.py:153-190):
    the collective context is set up, and the ranks aligned, before the
    first step, so that a rank that is slow to start stalls here and not
    inside the first BatchNorm. A no-op with one rank."""
    if world_size() > 1:
        t = torch.ones(1, device=device)
        dist.all_reduce(t)
        if t.item() != world_size():
            raise RuntimeError(f"warm-up all_reduce gave {t.item()}, expected {world_size()}")
