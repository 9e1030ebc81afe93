"""Host-side batch loading with a background prefetch, and the copy to the
device one batch ahead (port of ``egm_unet_tpu/data/loader.py``).

A thread pool maps the (numpy) dataset and a two-slot queue overlaps host
decoding and augmentation with the device's steps.  ``DevicePrefetcher``
copies batch N+1 from pinned host memory while step N runs.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


def _in_background(items, depth: int) -> Iterator:
    """Iterate ``items`` in a worker thread, at most ``depth`` ahead of the
    caller; an exception raised there is raised here."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in items:
                q.put(item)
        except BaseException as e:  # surface in the consumer thread
            q.put((stop, e))
            return
        q.put((stop, None))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is stop:
            if item[1] is not None:
                raise item[1]
            return
        yield item


class BatchLoader:
    """Batches of ``dataset`` in an order shuffled by ``np.random.default_rng
    (seed)`` once per epoch (the JAX package's order for the same seed);
    ``drop_last`` drops a short last batch.  ``collate(images, targets)``
    replaces ``np.stack``.

    Data parallel, every rank walks the same order and ``len()`` counts the
    global batches; ``rows`` (``parallel.rank_rows``): the rank loads only
    these rows of each global batch of ``batch_size``; ``shard=(rank,
    world)``: the rank takes whole batches, every ``world``-th from its
    ``rank``-th (the eval split)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_workers: int = 4,
                 collate=None, rows=None, shard=(0, 1)):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.collate = collate
        self.rows = rows
        self.shard = shard

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def _assemble(self, idxs):
        if self.rows is not None:
            idxs = idxs[self.rows]
        samples = list(self.pool.map(self.ds.__getitem__, idxs))
        images = [s[0] for s in samples]
        targets = [s[1] for s in samples]
        if self.collate is not None:
            return self.collate(images, targets)
        return np.stack(images), np.stack(targets)

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        rank, world = self.shard
        yield from _in_background(
            (self._assemble(order[b * self.bs:(b + 1) * self.bs])
             for b in range(rank, len(self), world)), depth=2)

    def close(self) -> None:
        self.pool.shutdown(wait=False)


class DevicePrefetcher:
    """Iterator adaptor that applies ``prepare`` (dtype narrowing and the
    copy to the device, ``to_device``) to batch N+1 in a worker thread while
    the caller's step N runs.  ``depth`` bounds the batches in flight."""

    def __init__(self, iterable, prepare, depth: int = 2):
        self.iterable = iterable
        self.prepare = prepare
        self.depth = depth

    def __iter__(self) -> Iterator:
        yield from _in_background((self.prepare(b) for b in self.iterable), self.depth)


def narrow_for_transfer(images: np.ndarray, targets: np.ndarray,
                        dtype: torch.dtype) -> tuple:
    """A host batch as torch tensors in the narrowest types to copy: images
    in the compute dtype (bfloat16 halves the bytes of float32; the cast is
    torch's, numpy has no bfloat16), raw uint8 images as they are; integer
    masks as uint8 (class ids and the 255 ignore value fit), widened on the
    device."""
    images = torch.from_numpy(np.ascontiguousarray(images))
    if images.dtype != torch.uint8:
        images = images.to(torch.bfloat16 if dtype == torch.bfloat16 else torch.float32)
    targets = np.asarray(targets)
    if np.issubdtype(targets.dtype, np.integer):
        targets = targets.astype(np.uint8)
    return images, torch.from_numpy(np.ascontiguousarray(targets))


def to_device(tensors, device: torch.device) -> tuple:
    """Copy host tensors to ``device``: for a CUDA device from pinned memory
    with ``non_blocking=True`` (the copy is ordered on the current stream
    before the step that reads it); for the CPU as they are."""
    device = torch.device(device)
    if device.type != "cuda":
        return tuple(tensors)
    return tuple(t.pin_memory().to(device, non_blocking=True) for t in tensors)


class SuperBatcher:
    """Groups K consecutive loader batches into stacked ``(K, B, ...)``
    arrays for ``engine.make_train_multistep``; a last group smaller than K
    is emitted as it is."""

    def __init__(self, loader, k: int):
        self.loader, self.k = loader, k

    def __len__(self):
        return -(-len(self.loader) // self.k)

    def __iter__(self) -> Iterator:
        buf = []
        for b in self.loader:
            buf.append(b)
            if len(buf) == self.k:
                yield tuple(np.stack(x) for x in zip(*buf))
                buf = []
        if buf:
            yield tuple(np.stack(x) for x in zip(*buf))
