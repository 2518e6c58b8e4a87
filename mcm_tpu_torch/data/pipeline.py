"""Host data pipeline: native batch decode + prefetch feeding static batches.

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=4,
pin_memory=True)`` (``utils/train_eval_util.py:49,96``).  Decode runs
through the C++ libjpeg decoder (:mod:`mcm_tpu_torch.runtime.native`:
GIL-free thread pool, PIL-geometry triangle resample, optional
DCT-prescaled decode) straight into the batch buffer, with a per-image PIL
fallback for the rows it refuses (non-JPEG, truncated, CMYK files) and for
every row when the native route is unavailable; batches are prepared ahead
of the consumer on a bounded queue so host decode overlaps device compute.

Batches are **uint8 HWC with static shapes**: the final partial batch is
padded (``valid`` marks real rows); padding rows are dropped after score
readback, reproducing the reference's tail truncation
(``detection_util.py:249``).  Under data parallelism each process decodes
only its stripe of every global batch (:mod:`mcm_tpu_torch.parallel.multihost`).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from mcm_tpu_torch.data.transforms import load_image_uint8
from mcm_tpu_torch.runtime import native


class Batch(NamedTuple):
    images: np.ndarray   # uint8 [local_B, S, S, 3] (this process's stripe)
    labels: np.ndarray   # int32 [local_B]
    valid: int           # GLOBAL non-padding row count of the batch


class DataPipeline:
    """Iterate (path, label) datasets as prefetched uint8 batches.

    Parameters
    ----------
    dataset:        indexable of (path, label) with __len__.
    batch_size:     static batch size (padded final batch).
    image_size:     square output resolution (shorter-side resize + crop).
    num_workers:    decode threads (default: min(32, cpu count)).
    prefetch:       batches decoded ahead of the consumer.
    use_native:     the C++ libjpeg decoder (PIL for every row when the
                    native route is unavailable).
    fast_decode:    DCT-prescaled native decode (smallest M/8 scale keeping
                    the shorter side ≥ target, fast IDCT; ~1-4 LSB from
                    PIL on natural images: a throughput mode, NOT for
                    parity runs).  Raises without the native route.
    stripe:         (lo, hi) rows of each global batch this process
                    decodes; default: this process's stripe of the
                    ``torch.distributed`` group ((0, batch_size) without
                    one), taken at the first decode.
    """

    def __init__(self, dataset, batch_size: int, image_size: int = 224,
                 num_workers: Optional[int] = None, prefetch: int = 2,
                 drop_remainder: bool = False, use_native: bool = True,
                 fast_decode: bool = False,
                 stripe: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_workers = num_workers or native.default_decode_threads()
        self.prefetch = max(1, prefetch)
        self.drop_remainder = drop_remainder
        self.use_native = use_native and native.native_available()
        if fast_decode and not self.use_native:
            raise RuntimeError(
                "fast_decode needs the native decoder, which is off here: "
                + ("use_native=False" if not use_native
                   else str(native.native_info()["reason"])))
        self.fast_decode = fast_decode
        #: rows decoded by PIL: those the native decoder refused (PNG,
        #: truncated, CMYK files), or every row without the native route
        self.pil_rows = 0
        # Every process iterates the same number of (lockstep) batches and
        # ``valid`` stays the GLOBAL count; the stripe's padding is dropped
        # by ``assemble_global_outputs`` after readback.
        self._stripe = stripe

    @property
    def stripe(self) -> Tuple[int, int]:
        if self._stripe is None:
            from mcm_tpu_torch.parallel.multihost import batch_stripe
            self._stripe = batch_stripe(self.batch_size)
        return self._stripe

    @property
    def local_batch_size(self) -> int:
        lo, hi = self.stripe
        return hi - lo

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
        s_lo, s_hi = self.stripe
        local_lo = min(lo + s_lo, hi)   # this process's rows of the batch
        local_hi = min(lo + s_hi, hi)
        paths = []
        labels = np.zeros((self.local_batch_size,), dtype=np.int32)
        for row, i in enumerate(range(local_lo, local_hi)):
            path, label = self.dataset[i]
            paths.append(path)
            labels[row] = label
        # np.empty: every real row is written below and the padding tail is
        # replicated from the last real row (zeroed for an empty stripe)
        images = np.empty((self.local_batch_size, size, size, 3),
                          dtype=np.uint8)
        todo = list(range(len(paths)))
        if self.use_native and paths:
            # straight into the batch buffer; failed rows are overwritten
            # by the PIL fallback below
            out, status = native.decode_batch(paths, size,
                                              n_threads=self.num_workers,
                                              fast=self.fast_decode,
                                              out=images[:len(paths)])
            if out is not None:   # None: the route was disabled since
                todo = [i for i in todo if status[i] != 0]
        decoded = (pool.map(lambda i: load_image_uint8(paths[i], size), todo)
                   if pool is not None and len(todo) > 1 else
                   (load_image_uint8(paths[i], size) for i in todo))
        for i, img in zip(todo, decoded):
            images[i] = img
        self.pil_rows += len(todo)
        local_valid = len(paths)
        if local_valid:
            images[local_valid:] = images[local_valid - 1]
            labels[local_valid:] = labels[local_valid - 1]
        else:   # the tail batch left this stripe empty: all padding, but
            images[:] = 0   # still a step, so the ranks stay in lockstep
        return Batch(images, labels, hi - lo)   # valid = GLOBAL count

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
