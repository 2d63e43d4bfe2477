"""Batched, prefetching host-side loaders (port of ``PairLoader`` and
``DEMLoader`` in ``scream_tpu/data/loader.py``). They yield numpy batches:
the pair schema ``register_batch`` reads (src, tgt, masks, rot, trans,
scale, center) and the OpenGF schema (dsm, dem, dem_coarse and masks)."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from scream_tpu_torch.data.batching import collate_dem, collate_pairs


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
