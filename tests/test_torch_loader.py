"""The port's DataLoader against the JAX package's, on the CPU: the same
batches, bit for bit, for the same seed and epoch, whatever the worker
count, shard or padding; ``prefetch_to_device`` is the identity on the
CPU. Both loaders read the tree of tests/test_torch_data.py through their
own package's reader (host mode with the training augmentation, so every
batch draws from its shared RandomState)."""

import multiprocessing as mp
import threading

import numpy as np
import pytest

from rtm3d_tpu.data.loader import DataLoader as DataLoaderJax
from rtm3d_tpu_torch.data.loader import DataLoader, prefetch_to_device
from tests.test_torch_data import TREE, assert_same, datasets, kitti_tree  # noqa: F401

CASES = {
    "workers0": dict(batch_size=2),
    "workers2": dict(batch_size=2, num_workers=2),
    "pad_final": dict(batch_size=4, drop_last=False, pad_final=True, shuffle=False),
    "shards3_0": dict(batch_size=2, num_shards=3, shard_index=0, drop_last=False, pad_final=True),
    "shards3_1": dict(batch_size=2, num_shards=3, shard_index=1, drop_last=False, pad_final=True),
    "shards3_2": dict(batch_size=2, num_shards=3, shard_index=2, drop_last=False, pad_final=True),
    "shards4_3": dict(batch_size=1, num_shards=4, shard_index=3, drop_last=False, pad_final=True),
    "batch_over_dataset": dict(batch_size=8, drop_last=False, pad_final=True),
    "batch_over_dataset_drop": dict(batch_size=8),
    "raw_cache_workers2": dict(batch_size=4, num_workers=2, drop_last=False, pad_final=True),
}


@pytest.fixture(scope="module")
def readers(kitti_tree):  # noqa: F811
    return {
        "host": datasets(kitti_tree, (), True),
        "raw_cache": datasets(kitti_tree, ("TPU.DEVICE_WARP", "True", "TPU.DEVICE_DATA_CACHE", "True"), True),
    }


@pytest.mark.parametrize("case", list(CASES))
def test_batches_match_jax(readers, case):
    kw = dict(CASES[case])
    ds_jax, ds_port = readers["raw_cache" if case.startswith("raw") else "host"]
    kw.setdefault("num_shards", 1)
    kw.setdefault("shard_index", 0)
    port = DataLoader(ds_port, seed=7, **kw)
    jax_kw = dict(kw, num_workers=0)  # the JAX stream is the same for any worker count
    ref = DataLoaderJax(ds_jax, seed=7, **jax_kw)
    n = TREE["num_train"]
    assert len(port) == len(ref)
    seen_rows = 0
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port)
        assert len(port.build_seconds) == len(got)
        for b, (g, w) in enumerate(zip(got, want)):
            assert_same(w, g, f"{case} epoch {epoch} batch {b}")
            assert g["num_valid"] == int(g["sample_valid"].sum())
            assert len(g["path"]) == kw["batch_size"]
            seen_rows += g["num_valid"]
    if kw.get("pad_final"):
        # every real row of the shard once an epoch; wrap-around rows never valid
        real_rows = n // kw["num_shards"] + (kw["shard_index"] < n % kw["num_shards"])
        assert seen_rows == 2 * real_rows
    if case == "batch_over_dataset_drop":
        assert len(port) == 0


def test_shards_partition_the_epoch(readers):
    ds_jax, ds_port = readers["host"]
    rows = []
    for k in range(3):
        idx, real = DataLoader(ds_port, 2, seed=7, num_shards=3, shard_index=k)._indices()
        idx_j, real_j = DataLoaderJax(ds_jax, 2, seed=7, num_shards=3, shard_index=k)._indices()
        np.testing.assert_array_equal(idx, idx_j)
        np.testing.assert_array_equal(real, real_j)
        rows += idx[real].tolist()
    assert sorted(rows) == list(range(TREE["num_train"]))


def test_worker_error_reaches_the_parent(readers):
    _, ds_port = readers["host"]

    class Broken:
        def __len__(self):
            return len(ds_port)

        def __getitem__(self, i, rng=None):
            raise OSError(f"frame {i} is unreadable")

    for workers in (0, 2):
        with pytest.raises((RuntimeError, OSError), match="unreadable"):
            list(DataLoader(Broken(), 2, num_workers=workers))


@pytest.mark.parametrize("workers", [0, 2])
def test_a_consumer_that_stops_early_ends_the_builders(readers, workers):
    """Closing the batch iterator early (the CLI's non-finite-loss abort)
    leaves no builder thread or worker process behind."""
    _, ds_port = readers["host"]
    threads, children = threading.active_count(), len(mp.active_children())
    it = iter(DataLoader(ds_port, 1, seed=7, num_workers=workers))
    next(it)
    it.close()
    assert threading.active_count() == threads
    assert len(mp.active_children()) == children


def test_prefetch_is_the_identity_on_the_cpu(readers):
    _, ds_port = readers["host"]
    batches = list(DataLoader(ds_port, 2, seed=7))
    out = list(prefetch_to_device(iter(batches), "cpu"))
    assert len(out) == len(batches) and all(a is b for a, b in zip(out, batches))
