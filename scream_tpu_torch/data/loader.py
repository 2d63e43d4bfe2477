"""Batched, prefetching host-side loaders (port of
``scream_tpu/data/loader.py``). ``PairLoader``, ``BucketedPairLoader`` and
``DEMLoader`` yield numpy batches: the pair schema ``register_batch`` reads
(src, tgt, masks, rot, trans, scale, center, optional idx / covariance /
scene sidecars) and the OpenGF schema (dsm, dem, dem_coarse and masks).
:func:`prefetch_to_device` stages them on the device ahead of the consumer;
:class:`HostShardDataset` gives each process of a multi-process run its
strided share of a dataset."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from scream_tpu_torch.data.batching import bucket_for, collate_dem, collate_pairs


class PairLoader:
    """Iterate padded registration batches from any map-style pair dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        src_capacity: int,
        tgt_capacity: Optional[int] = None,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.src_capacity = src_capacity
        self.tgt_capacity = tgt_capacity or src_capacity
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, items):
        return collate_pairs(items, self.src_capacity, self.tgt_capacity)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [order[i: i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        if self.num_workers <= 0:
            for idxs in batches:
                yield self._collate([self.dataset[int(i)] for i in idxs])
            return

        yield from _queue_iter(
            batches,
            lambda pool, idxs: self._collate(
                list(pool.map(lambda i: self.dataset[int(i)], idxs))),
            self.num_workers,
            self.prefetch,
        )


class DEMLoader(PairLoader):
    """OpenGF variant: pads dsm / dem / dem_coarse.

    ``dsm_capacity`` and ``dem_capacity`` must be equal: DSM and DEM points
    correspond index for index (``process_open_gf.py:217-231``), so unequal
    paddings would misalign the L1 loss and the masks. Only the coarse
    DEM's capacity is independent.
    """

    def __init__(self, dataset, batch_size: int, dsm_capacity: int,
                 dem_capacity: int, coarse_capacity: int, **kw):
        if dem_capacity != dsm_capacity:
            raise ValueError(
                f"dsm_capacity ({dsm_capacity}) and dem_capacity "
                f"({dem_capacity}) must be equal: DSM and DEM points "
                f"correspond index-for-index in the OpenGF protocol")
        super().__init__(dataset, batch_size, src_capacity=dsm_capacity, **kw)
        self.dsm_capacity = dsm_capacity
        self.dem_capacity = dem_capacity
        self.coarse_capacity = coarse_capacity

    def _collate(self, items):
        return collate_dem(items, self.dsm_capacity, self.dem_capacity,
                           self.coarse_capacity)


def _queue_iter(work, make_batch, num_workers: int, prefetch: int):
    """A daemon producer thread drives a pool that assembles batches
    ``prefetch`` ahead of the consumer. Errors are forwarded (a dead
    producer without a sentinel would hang ``q.get``), and an abandoned
    iteration winds the producer down instead of leaking it."""
    # maxsize <= 0 would make the queue unbounded: keep at least one slot.
    q: "queue.Queue" = queue.Queue(maxsize=max(int(prefetch), 1))
    stop = threading.Event()

    def _put(item) -> bool:
        # Bounded put that gives up once the consumer has gone away.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return not stop.is_set()
            except queue.Full:
                continue
        return False

    def producer():
        try:
            with ThreadPoolExecutor(num_workers) as pool:
                for unit in work:
                    if stop.is_set():
                        return
                    if not _put(make_batch(pool, unit)):
                        return
            _put(None)
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            _put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            batch = q.get()
            if batch is None:
                return
            if isinstance(batch, BaseException):
                raise batch
            yield batch
    finally:
        stop.set()
        # Unblock a producer parked in q.put, then let it exit.
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


class BucketedPairLoader:
    """Pad-to-bucket loader: each pair goes to the smallest bucket that
    fits ``max(n_src, n_tgt)``, batches form within buckets, and the
    batches of all buckets interleave (shuffled with ``shuffle``), so every
    batch is tightly padded and the device sees one shape per bucket.

    ``size_fn(dataset, i) -> (n_src, n_tgt)`` probes sizes cheaply; the
    default (:func:`_default_size_fn`) reads npy headers through ``mmap``
    for the split layout and makes the item only as a last resort.
    """

    def __init__(self, dataset, batch_size: int,
                 buckets=(1024, 2048, 4096, 8192, 16384), shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 4,
                 size_fn=None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self.prefetch = prefetch

        size_fn = size_fn or _default_size_fn
        self._assignment = {}
        for i in range(len(dataset)):
            n_src, n_tgt = size_fn(dataset, i)
            cap = bucket_for(max(n_src, n_tgt), self.buckets)
            self._assignment.setdefault(cap, []).append(i)

    def __len__(self):
        total = 0
        for items in self._assignment.values():
            n = len(items)
            total += n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return total

    def __iter__(self):
        plan = []  # (capacity, [indices])
        for cap, items in self._assignment.items():
            idxs = np.asarray(items)
            if self.shuffle:
                self.rng.shuffle(idxs)
            for i in range(0, len(idxs), self.batch_size):
                chunk = idxs[i: i + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    continue
                plan.append((cap, chunk))
        if self.shuffle:
            self.rng.shuffle(plan)

        if self.num_workers <= 0:
            for cap, chunk in plan:
                yield collate_pairs([self.dataset[int(i)] for i in chunk], cap)
            return

        yield from _queue_iter(
            plan,
            lambda pool, unit: collate_pairs(
                list(pool.map(lambda i: self.dataset[int(i)], unit[1])), unit[0]),
            self.num_workers,
            self.prefetch,
        )


def _default_size_fn(dataset, i):
    """Cloud sizes ``(n_src, n_tgt)`` of item ``i`` without making it where
    possible: a dataset's ``size_hint(i)``; else through wrappers'
    ``_unwrap(i) -> (inner, inner_i)`` (``SkipDataset``,
    :class:`HostShardDataset`, ``ConcatDataset``); else the npy headers of
    the split layout through ``mmap`` (capped at ``max_points``); else the
    item itself. Making an augmenting item would spend its randomness."""
    import os

    while True:
        hint = getattr(dataset, "size_hint", None)
        if hint is not None:
            return hint(i)
        unwrap = getattr(dataset, "_unwrap", None)
        if unwrap is None:
            break
        dataset, i = unwrap(i)

    d = getattr(dataset, "dir", None)
    if d is not None:
        src_path = os.path.join(d, "src%d.npy" % i)
        tgt_path = os.path.join(d, "tgt%d.npy" % i)
        if os.path.exists(src_path):
            n_src = np.load(src_path, mmap_mode="r").shape[0]
            n_tgt = np.load(tgt_path, mmap_mode="r").shape[0]
            cap = getattr(dataset, "max_points", None)
            if cap:
                n_src, n_tgt = min(n_src, cap), min(n_tgt, cap)
            return n_src, n_tgt
    item = dataset[i]
    return len(item["src"]), len(item["tgt"])


def prefetch_to_device(iterator, size: int = 2, device="cuda", skip=()):
    """Stage host batches on ``device``, ``size`` ahead of the consumer.

    On a CUDA device each array is copied into pinned host memory and sent
    with a ``non_blocking`` copy on a side stream, and the consumer's
    stream waits on that copy's event: batch i+1 travels while batch i
    computes, and the host never waits for a copy. On the CPU the arrays
    become tensors sharing their memory. Keys in ``skip`` (host-only
    bookkeeping such as ``idx`` and ``scene``) stay numpy. Yields dicts.
    """
    import collections

    import torch

    from scream_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def host_tensor(v):
        if isinstance(v, torch.Tensor):
            return v
        v = np.asarray(v)
        # A read-only array (a memmap slice of the collated cache) is copied.
        return torch.from_numpy(v if v.flags.writeable else np.array(v))

    def stage(batch):
        if copy_stream is None:
            return {k: v if k in skip else host_tensor(v) for k, v in batch.items()}, None
        out = {}
        with torch.cuda.stream(copy_stream):
            for k, v in batch.items():
                if k in skip:
                    out[k] = v
                    continue
                host = host_tensor(v)
                if not host.is_cuda:
                    host = host.pin_memory()
                out[k] = host.to(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(copy_stream)
        return out, done

    def hand_over(staged):
        out, done = staged
        if done is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(done)
            for v in out.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(stream)  # allocated on the copy stream
        return out

    queue_ = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue_.append(stage(batch))
        if len(queue_) >= size:
            break
    while queue_:
        out = queue_.popleft()
        for batch in it:
            queue_.append(stage(batch))
            break
        yield hand_over(out)


class HostShardDataset:
    """Strided per-process share of a dataset for multi-process sweeps:
    process ``shard`` of ``count`` takes items ``shard, shard + count, ...``.
    The defaults are ``torch.distributed``'s rank and world size where a
    process group is initialized, else ``(0, 1)``."""

    def __init__(self, dataset, shard: int = None, count: int = None):
        if shard is None or count is None:
            import torch.distributed as dist

            ready = dist.is_available() and dist.is_initialized()
            shard = (dist.get_rank() if ready else 0) if shard is None else shard
            count = (dist.get_world_size() if ready else 1) if count is None else count
        if not 0 <= shard < count:
            raise ValueError(f"shard {shard} not in [0, {count})")
        self.dataset = dataset
        self.shard, self.count = shard, count

    def __len__(self):
        n = len(self.dataset)
        return (n - self.shard + self.count - 1) // self.count

    def __getitem__(self, i):
        if i < 0 or i >= len(self):
            raise IndexError(i)
        return self.dataset[self.shard + i * self.count]

    def _unwrap(self, i):
        return self.dataset, self.shard + i * self.count
