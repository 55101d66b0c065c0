"""Batching loader with shards, forked workers, and the copy to the GPU.

Port of ``rtm3d_tpu/data/loader.py:27-271`` (reference: torch DataLoader
+ DistributedSampler, dataset_reader.py:306-322). Each shard reads a
strided slice of a seeded per-epoch permutation (``set_epoch``), padded by
wrap-around so every shard has the same length; samples are stacked into
fixed-shape numpy batches; ``num_workers`` forked processes build whole
batches round-robin and the parent hands them out in order, raising what a
worker raised. ``num_workers=0`` builds them on one background thread.

The augmentation RNG is keyed by (seed, epoch, batch index), so the batch
stream is bit-identical for every ``num_workers``. The workers run numpy
and ``data/image_io.py`` only, never torch nor CUDA: they fork from a
process that may already hold a CUDA context. Batches stay numpy until
``prefetch_to_device`` copies them.

``DataLoader.build_seconds`` lists, per batch of the last epoch, the
seconds its worker took to build it (host work per batch).
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import time
from typing import Dict, Iterator

import numpy as np
import torch


def _stack(samples) -> Dict:
    batch: Dict = {
        "labels": {k: np.stack([s["labels"][k] for s in samples], axis=0) for k in samples[0]["labels"]},
        "path": [s["path"] for s in samples],
    }
    for key in samples[0]:
        if key in ("labels", "path"):
            continue
        batch[key] = np.stack([s[key] for s in samples], axis=0)
    return batch


def _worker_loop(loader: "DataLoader", indices, real, n_batches, worker_id, out_q):
    """This worker's round-robin share of the epoch's batches, in a forked
    child: numpy and image_io only."""
    try:
        for b in range(worker_id, n_batches, loader.num_workers):
            t0 = time.perf_counter()
            batch = loader._build_batch(indices, real, b)
            out_q.put((b, batch, time.perf_counter() - t0))
        out_q.put(("done", worker_id, 0.0))
    except KeyboardInterrupt:
        pass
    except BaseException as e:  # surface worker crashes to the parent
        out_q.put(("error", f"worker {worker_id}: {type(e).__name__}: {e}", 0.0))


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 20,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
        num_workers: int = 0,
        pad_final: bool = False,
    ):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} is not in [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.num_workers = int(num_workers)
        # pad the final partial batch to the static batch size with
        # wrap-around samples; batch['num_valid'] and batch['sample_valid']
        # mark the real rows
        self.pad_final = bool(pad_final) and not drop_last
        self.epoch = 0
        self.build_seconds: list = []

    def set_epoch(self, epoch: int):
        """Per-epoch reshuffle (DistributedSampler.set_epoch)."""
        self.epoch = epoch

    def _indices(self):
        """This shard of the epoch permutation, and a per-entry real/pad mask.

        Shard lengths are equalised (dataset_reader.py:312-313): when
        ``len(dataset)`` is not divisible by ``num_shards`` the global list
        is padded with wrap-around duplicates before striding. The pads are
        a suffix of each shard and are marked False in the mask."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        total = -(-n // self.num_shards) * self.num_shards
        if total > n:
            idx = np.concatenate([idx, np.resize(idx, total - n)])  # cyclic
        real = np.arange(total) < n
        sl = slice(self.shard_index, None, self.num_shards)
        return idx[sl], real[sl]

    def __len__(self):
        n = len(self._indices()[0])
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    # ------------------------------------------------------------------
    def _batch_rng(self, b: int) -> np.random.RandomState:
        """Augmentation RNG keyed by (seed, epoch, batch index)."""
        return np.random.RandomState((self.seed * 100003 + self.epoch * 1000003 + b * 7919) % (2**31 - 1))

    def _build_batch(self, indices: np.ndarray, real: np.ndarray, b: int) -> Dict:
        sl = slice(b * self.batch_size, (b + 1) * self.batch_size)
        chunk, chunk_real = indices[sl], real[sl]
        # shard pads are a suffix of the shard, so valid rows are a prefix
        num_valid = int(chunk_real.sum())
        if self.pad_final and len(chunk) < self.batch_size:
            extra = np.resize(indices, self.batch_size - len(chunk))  # cyclic
            chunk = np.concatenate([chunk, extra])
        rng = self._batch_rng(b)  # one stream shared by the batch's samples
        samples = [self.dataset.__getitem__(int(i), rng=rng) for i in chunk]
        batch = _stack(samples)
        batch["num_valid"] = num_valid
        batch["sample_valid"] = np.arange(len(chunk)) < num_valid
        return batch

    # ------------------------------------------------------------------
    def _produce(self, q: "queue.Queue", stop: threading.Event, indices, real, n_batches):
        try:
            for b in range(n_batches):
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                batch = self._build_batch(indices, real, b)
                q.put((batch, time.perf_counter() - t0))
            q.put(None)
        except BaseException as e:  # re-raised in the consumer
            q.put(e)

    def _iter_threaded(self, indices, real, n_batches) -> Iterator[Dict]:
        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop, indices, real, n_batches), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, seconds = item
                self.build_seconds.append(seconds)
                yield batch
        finally:
            # a consumer that stops early (the CLI's non-finite-loss abort)
            # ends the builder: it finishes its batch and builds no other
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass

    def _iter_workers(self, indices, real, n_batches) -> Iterator[Dict]:
        ctx = mp.get_context("fork")
        out_q = ctx.Queue(maxsize=max(self.prefetch, self.num_workers))
        workers = [
            ctx.Process(target=_worker_loop, args=(self, indices, real, n_batches, w, out_q), daemon=True)
            for w in range(self.num_workers)
        ]
        for w in workers:
            w.start()
        ready: Dict[int, tuple] = {}
        next_b, done = 0, 0
        try:
            while next_b < n_batches:
                if next_b in ready:
                    batch, seconds = ready.pop(next_b)
                    self.build_seconds.append(seconds)
                    yield batch
                    next_b += 1
                    continue
                if done == self.num_workers:
                    raise RuntimeError(f"all workers exited with {n_batches - next_b} batches outstanding")
                tag, payload, seconds = out_q.get()
                if tag == "done":
                    done += 1
                elif tag == "error":
                    raise RuntimeError(payload)
                else:
                    ready[tag] = (payload, seconds)
        finally:
            for w in workers:
                if w.is_alive():
                    w.terminate()
            for w in workers:
                w.join(timeout=5)
            out_q.close()

    def __iter__(self) -> Iterator[Dict]:
        indices, real = self._indices()
        n_batches = len(self)
        self.build_seconds = []
        if self.num_workers > 0 and n_batches > 0:
            return self._iter_workers(indices, real, n_batches)
        return self._iter_threaded(indices, real, n_batches)


def _pin(x):
    """numpy arrays (nested in dicts) as pinned host tensors; other values
    (paths, ``num_valid``) as they are."""
    if isinstance(x, dict):
        return {k: _pin(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
    return x


def _copy(x, device):
    if isinstance(x, dict):
        return {k: _copy(v, device) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return x


def _hand_over(x, consumer):
    """Mark each device tensor as used on the consuming stream, so the
    caching allocator does not give its memory to a later copy on the side
    stream while the step still reads it."""
    if isinstance(x, dict):
        for v in x.values():
            _hand_over(v, consumer)
    elif isinstance(x, torch.Tensor):
        x.record_stream(consumer)


def prefetch_to_device(iterator, device, size: int = 2) -> Iterator:
    """Batches of ``iterator`` on ``device``, the next one's copy running
    while the consumer's step runs.

    On a CUDA device each batch's arrays are copied into pinned host
    tensors, then to the device with ``non_blocking`` copies on a side
    stream; the consuming stream waits on the copy's event before the batch
    is handed out, and each tensor is recorded on the consuming stream.
    ``size`` batches are in flight at once. On the CPU it is the identity:
    the batches pass as they are."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return
    side = torch.cuda.Stream(device)
    consumer = torch.cuda.current_stream(device)
    pending = []

    def start(batch):
        pinned = _pin(batch)
        with torch.cuda.stream(side):
            out = _copy(pinned, device)
            done = torch.cuda.Event()
            done.record(side)
        # the pinned buffers stay referenced until the copy has run
        return out, done, pinned

    it = iter(iterator)
    for batch in it:
        pending.append(start(batch))
        if len(pending) < max(size, 1):
            continue
        out, done, _ = pending.pop(0)
        consumer.wait_event(done)
        _hand_over(out, consumer)
        yield out
    for out, done, _ in pending:
        consumer.wait_event(done)
        _hand_over(out, consumer)
        yield out
