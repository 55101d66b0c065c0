"""Data and spatial parallelism over processes: one process per device, torch.distributed.

Port of ``rtm3d_tpu/parallel/mesh.py`` in torch's idiom. The JAX package
runs one program over a mesh of devices and XLA inserts the collectives;
here each process (rank) holds a replica of the train state and its own
piece of the global batch, and the collectives are explicit.

The mesh is the JAX package's: ``TPU.MESH_AXES`` ``("data",)``,
``("data", "spatial")`` or ``("spatial",)``, with ``TPU.MESH_SHAPE``.
Rank ``r`` sits at ``(r // S, r % S)`` of a ``data x spatial`` grid of
``D x S`` ranks, the row-major order of ``np.asarray(devices).reshape
(shape)`` (mesh.py:36). The ``D`` data groups each hold their rows of
the global batch; the ``S`` ranks of one data group hold the same
frames, each the rows of one band of every frame (``parallel/spatial.py``,
the JAX ``spatial`` axis of mesh.py:11-14, 87-94). The collectives are in
four places: BatchNorm's batch statistics (``nn/layers.py``, over the
whole world: the (frame, band) pieces of the ranks are disjoint), the
loss's counts (``losses/rtm3d_loss.py``, likewise), the gradients
(``train/step.py``) and, with ``S > 1``, the halo exchanges and the
KFPN's softmax over the spatial group (``parallel/spatial.py``). Every
helper here is a no-op, or the identity, when no process group of more
than one rank is initialised, and a grid of spatial size 1 creates no
sub-group: both take the path they took before the spatial axis existed.

Launch with torchrun, which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
and ``MASTER_ADDR``/``MASTER_PORT``::

    python -m torch.distributed.run --nproc-per-node N -m rtm3d_tpu_torch.cli.train --multihost ...

Not ported, and why:
- ``create_mesh_for_batch``'s device trimming (mesh.py:40-83): a rank
  cannot be left out of a process group, so a global batch that the
  data axis does not divide raises (``local_batch_size``);
- ``shard_batch``, ``_put``, ``device_batch`` (mesh.py:97-140): each rank
  loads and holds its own rows (``DataLoader(num_shards=data_size(),
  shard_index=data_index())``), and the train step cuts its band.
A mesh the port cannot run is refused with a message by
``check_mesh_config``, which both CLIs call, and never run as something
else.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
MESH_AXES = (("data",), ("data", "spatial"), ("spatial",))


class _Mesh:
    """The data x spatial grid of the default process group, with this
    rank's two sub-groups: the ranks of its data group (one per band) and
    the ranks that hold its band in the other data groups."""

    def __init__(self, data: int, spatial: int, spatial_group, data_group):
        self.data, self.spatial = data, spatial
        self.spatial_group, self.data_group = spatial_group, data_group


_mesh: _Mesh | None = None  # set by init_mesh while a grid of spatial size > 1 is in use


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
    """Leave the default process group, if one is initialised, and forget
    the mesh."""
    global _mesh
    _mesh = None
    if initialized():
        dist.destroy_process_group()


def check_mesh_config(cfg) -> tuple:
    """The ``(data, spatial)`` grid that ``TPU.MESH_AXES`` and
    ``TPU.MESH_SHAPE`` ask for at this world size, or ``ValueError`` with
    a message for a mesh the port cannot run. The JAX CLIs build their
    mesh from both keys (``rtm3d_tpu/cli/train.py:126``,
    ``cli/detect.py:206``; ``parallel/mesh.py:27-37``). Accepted:
    ``("data",)`` with ``(-1,)`` or ``(world size,)``; ``("data",
    "spatial")`` with ``(d, s)`` or ``(-1, s)``; ``("spatial",)`` with
    ``(-1,)`` or ``(world size,)``, a ``(1, world size)`` grid. Refused: any
    other axis names or order, a shape whose product is not the world
    size, and, with ``s > 1``, a frame (``INPUT_SIZE``'s height) whose
    bands would be thinner than the network's deepest stride, or not
    made of whole multiples of it (``parallel/spatial.py::band_rows``)."""
    axes = tuple(str(a) for a in cfg.TPU.get("MESH_AXES", ("data",)))
    shape = tuple(int(s) for s in cfg.TPU.get("MESH_SHAPE", (-1,)))
    n = world_size()
    where = f"TPU.MESH_AXES {axes} with TPU.MESH_SHAPE {shape} at world size {n}"
    if axes not in MESH_AXES:
        raise ValueError(f"{where}: the port runs the axes {' or '.join(map(str, MESH_AXES))} (one process per "
                         "device under torchrun), not these axis names")
    if len(shape) != len(axes) or any(s == 0 or s < -1 for s in shape) or shape.count(-1) > 1:
        raise ValueError(f"{where}: the shape must give one size per axis, each positive or -1 (once)")
    fixed = 1
    for s in shape:
        fixed *= s if s != -1 else 1
    if n % fixed or (-1 not in shape and fixed != n):
        raise ValueError(f"{where}: the mesh's product must be the world size {n}")
    sizes = dict(zip(axes, (n // fixed if s == -1 else s for s in shape)))
    grid = (sizes.get("data", 1), sizes.get("spatial", 1))
    if grid[1] > 1:
        from rtm3d_tpu_torch.nn.model import deepest_stride
        from rtm3d_tpu_torch.parallel.spatial import band_rows

        try:
            band_rows(int(cfg.INPUT_SIZE[1]), grid[1], deepest_stride(cfg))
        except ValueError as e:
            raise ValueError(f"{where}: {e}") from None
    return grid


def init_mesh(data: int, spatial: int) -> None:
    """Lay the ranks of the default process group out as a ``data x
    spatial`` grid (rank ``r`` at ``(r // spatial, r % spatial)``). With
    ``spatial`` 1 nothing is created: the data group is the world. Else
    every rank creates every sub-group, in the same order (gloo hangs
    otherwise): first the ``data`` spatial groups, then the ``spatial``
    data groups, and keeps its own two."""
    global _mesh
    n = world_size()
    if data * spatial != n:
        raise ValueError(f"a {data} x {spatial} grid needs {data * spatial} ranks, the world has {n}")
    if spatial == 1:
        _mesh = None
        return
    me = rank()
    spatial_groups = [dist.new_group([d * spatial + s for s in range(spatial)]) for d in range(data)]
    data_groups = [dist.new_group([d * spatial + s for d in range(data)]) for s in range(spatial)]
    _mesh = _Mesh(data, spatial, spatial_groups[me // spatial], data_groups[me % spatial])


def data_size() -> int:
    """Ranks along the data axis: the world size divided by the spatial size."""
    return world_size() if _mesh is None else _mesh.data


def data_index() -> int:
    return rank() if _mesh is None else rank() // _mesh.spatial


def spatial_size() -> int:
    """Ranks along the spatial axis (bands of each frame); 1 without a grid."""
    return 1 if _mesh is None else _mesh.spatial


def spatial_index() -> int:
    """This rank's band: 0 holds each frame's top rows."""
    return 0 if _mesh is None else rank() % _mesh.spatial


def spatial_group():
    """The process group of this rank's data group, one rank a band
    (the halo exchanges); None without a grid."""
    return None if _mesh is None else _mesh.spatial_group


def data_group():
    """The process group of the ranks that hold this rank's band in every
    data group; None (the world) without a grid."""
    return None if _mesh is None else _mesh.data_group


def local_batch_size(global_batch: int) -> int:
    """This rank's share of the global batch (mesh.py:210-216; the
    reference divides BATCH_SIZE by the GPU count, model_factory.py:61-62):
    the global batch over the data axis, whose ranks each load their own
    frames (the spatial ranks of one data group load the same). Raises
    ``ValueError`` when the data axis does not divide it."""
    n = data_size()
    if global_batch % n:
        what = "world size" if spatial_size() == 1 else "data axis size"
        raise ValueError(f"the global batch {global_batch} is not divisible by the {what} {n}")
    return global_batch // n


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (the world when None),
    in place, returned; ``t`` itself when the group has one rank."""
    if world_size() > 1 and (group is None or dist.get_world_size(group) > 1):
        dist.all_reduce(t, group=group)
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
