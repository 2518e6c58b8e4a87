"""Host data pipeline: threaded PIL decode + prefetch feeding static batches.

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=4,
pin_memory=True)`` (``utils/train_eval_util.py:49,96``).  Decode runs on
a thread pool through PIL (the C++ libjpeg decoder of the JAX package is
not ported yet: ``ROADMAP.md`` Queue 1, item 6); batches are prepared
ahead of the consumer on a bounded queue so host decode overlaps device
compute.

Batches are **uint8 HWC with static shapes**: the final partial batch is
padded (``valid`` marks real rows); padding rows are dropped after score
readback, reproducing the reference's tail truncation
(``detection_util.py:249``).  One process decodes whole batches (no
multi-host stripes).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np

from mcm_tpu_torch.data.transforms import load_image_uint8


def default_decode_threads() -> int:
    """Decode-pool width when the caller doesn't pin one."""
    return min(32, os.cpu_count() or 4)


class Batch(NamedTuple):
    images: np.ndarray   # uint8 [B, S, S, 3]
    labels: np.ndarray   # int32 [B]
    valid: int           # non-padding row count of the batch


class DataPipeline:
    """Iterate (path, label) datasets as prefetched uint8 batches.

    Parameters
    ----------
    dataset:        indexable of (path, label) with __len__.
    batch_size:     static batch size (padded final batch).
    image_size:     square output resolution (shorter-side resize + crop).
    num_workers:    decode threads (default: min(32, cpu count)).
    prefetch:       batches decoded ahead of the consumer.
    """

    def __init__(self, dataset, batch_size: int, image_size: int = 224,
                 num_workers: Optional[int] = None, prefetch: int = 2,
                 drop_remainder: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_workers = num_workers or default_decode_threads()
        self.prefetch = max(1, prefetch)
        self.drop_remainder = drop_remainder

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    @property
    def num_samples(self) -> int:
        return len(self.dataset)

    # -- batch decode ---------------------------------------------------------

    def _decode_batch(self, lo: int, hi: int,
                      pool: Optional[ThreadPoolExecutor]) -> Batch:
        size = self.image_size
        paths = []
        labels = np.zeros((self.batch_size,), dtype=np.int32)
        for row, i in enumerate(range(lo, hi)):
            path, label = self.dataset[i]
            paths.append(path)
            labels[row] = label
        # np.empty: every real row is written below and the padding tail is
        # replicated from the last real row
        images = np.empty((self.batch_size, size, size, 3), dtype=np.uint8)
        decoded = (pool.map(lambda p: load_image_uint8(p, size), paths)
                   if pool is not None else
                   (load_image_uint8(p, size) for p in paths))
        for i, img in enumerate(decoded):
            images[i] = img
        valid = hi - lo
        images[valid:] = images[valid - 1]
        labels[valid:] = labels[valid - 1]
        return Batch(images, labels, valid)

    # -- iteration ------------------------------------------------------------

    def __iter__(self) -> Iterator[Batch]:
        n = len(self.dataset)
        num_batches = len(self)
        if num_batches == 0:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            pool = (ThreadPoolExecutor(self.num_workers)
                    if self.num_workers > 1 else None)
            try:
                for b in range(num_batches):
                    if stop.is_set():
                        return
                    lo = b * self.batch_size
                    hi = min(lo + self.batch_size, n)
                    q.put(("batch", self._decode_batch(lo, hi, pool)))
                q.put(("done", None))
            except BaseException as e:  # surface worker errors to consumer
                q.put(("error", e))
            finally:
                if pool is not None:
                    pool.shutdown(wait=True)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="mcm-pipeline-producer")
        thread.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    return
                if kind == "error":
                    raise payload
                yield payload
        finally:
            stop.set()
            # Drain AND join: draining frees a slot for a producer blocked
            # in q.put, and the join bounds it — an unjoined producer would
            # keep decoding after an early consumer exit.
            while thread.is_alive():
                while not q.empty():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                thread.join(timeout=0.1)


def collect_scores(score_batches: Sequence[np.ndarray],
                   valids: Sequence[int], total: int) -> np.ndarray:
    """Concatenate per-batch score vectors dropping padding rows, truncated
    to the dataset length (reference ``detection_util.py:249`` semantics)."""
    parts = [np.asarray(s)[:v] for s, v in zip(score_batches, valids)]
    if not parts:  # e.g. drop_remainder over a sub-batch-size dataset
        return np.zeros((0,), dtype=np.float32)
    return np.concatenate(parts, axis=0)[:total].copy()
