"""Data-parallel evaluation over ``torch.distributed``: one process per card.

The JAX package runs a multi-process eval as SPMD lockstep over a global
mesh (``mcm_tpu/parallel/multihost.py``).  The port keeps its scheme and
drops what a global array needs:

* every process runs the SAME number of per-batch steps: global batch ``i``
  covers dataset rows ``[i·B, (i+1)·B)`` and process ``h`` decodes and
  scores its contiguous *stripe* ``[i·B + h·b, i·B + (h+1)·b)``
  (``b = B / process_count``, :func:`batch_stripe`) on its own card;
* :func:`assemble_global_outputs` all-gathers the per-process stripe stacks
  of HOST arrays (gloo) and interleaves them back into dataset order
  (:func:`interleave_process_stripes`), then drops tail padding exactly like
  ``collect_scores``.

JAX's ``make_global_batch``, ``put_global`` and ``read_local`` have no
counterpart: each rank holds its own stripe, its own copy of the weights
and its own outputs on its own card, so nothing is global on the device.
Evaluation's collectives are on host arrays and small Python objects,
which is why the group is gloo (two ranks may share one card; NCCL would
refuse them).  Training adds two on tensors (:func:`gather_rows`, the
features of the global contrastive loss, and :func:`all_reduce_sum_`, the
gradients), still over gloo and only with the ops gloo has
(``all_gather``, ``all_reduce``): a CUDA tensor goes through an explicit
host copy each way.  Every function degenerates to the single-process path
when no group is up.

Launch: ``python -m torch.distributed.run --standalone --nproc_per_node N
-m mcm_tpu_torch.cli.eval_ood ... --n_devices N``; the launcher sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address that
:func:`initialize` reads.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mcm_tpu_torch.config import resolve_device

#: how long a rank waits in one collective (or in the group's start-up)
#: for the others.  A rank that raises closes its sockets and its peers
#: fail at once; the timeout bounds the wait when a rank hangs instead.
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def process_index() -> int:
    """This process's rank; 0 when no group is up."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The world size; 1 when no group is up."""
    return dist.get_world_size() if dist.is_initialized() else 1


# batch_stripe's arguments (JAX's signature) shadow the two functions
def _rank() -> int:
    return process_index()


def _world() -> int:
    return process_count()


def rank_device(device="cuda") -> torch.device:
    """The card this rank runs on: ``cuda`` is ``cuda:LOCAL_RANK`` (0 outside
    a launcher), an explicit ``cuda:K`` puts every rank on card K, ``cpu``
    stays the CPU.  Without a card a CUDA device raises, as
    :func:`~mcm_tpu_torch.config.resolve_device` does."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        k = int(os.environ.get("LOCAL_RANK", "0"))
        n = torch.cuda.device_count()
        if k >= n:
            raise RuntimeError(
                f"LOCAL_RANK {k} but {n} card(s) are visible: launch at most "
                f"{n} processes per host, or pass --device cuda:K to put "
                f"every rank on card K")
        dev = torch.device("cuda", k)
    return dev


def initialize(device="cuda") -> bool:
    """Bind this process to its card (before any CUDA work, so kernels build
    and run there) and, when the launcher's ``WORLD_SIZE`` is above 1, join
    the gloo group.  Returns whether it started the group (the caller then
    owns its shutdown); a group already up is left as it is."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return False
    dist.init_process_group("gloo", timeout=GROUP_TIMEOUT)
    return True


@contextlib.contextmanager
def launched(device="cuda") -> Iterator[None]:
    """:func:`initialize` for the body; destroys the group on exit if it
    started it (the CLIs' ``main``)."""
    started = initialize(device)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` on one process)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def host_shard_range(n_samples: int) -> Tuple[int, int]:
    """This process's contiguous [lo, hi) slice of a dataset (equal-ish
    split by process index; the last process takes the remainder).  For
    dataset-level work splits; the batch loop uses :func:`batch_stripe`, so
    steps stay in lockstep."""
    n_proc = process_count()
    idx = process_index()
    per = n_samples // n_proc
    lo = idx * per
    hi = n_samples if idx == n_proc - 1 else lo + per
    return lo, hi


def batch_stripe(global_batch_size: int,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None) -> Tuple[int, int]:
    """This process's [lo, hi) stripe within every global batch."""
    n = _world() if process_count is None else process_count
    idx = _rank() if process_index is None else process_index
    if global_batch_size % n:
        raise ValueError(f"batch size {global_batch_size} not divisible by "
                         f"process count {n}")
    b = global_batch_size // n
    return idx * b, (idx + 1) * b


def interleave_process_stripes(stacked: np.ndarray) -> np.ndarray:
    """[n_proc, n_batches, b, ...] → [n_batches, n_proc·b, ...]: undo the
    per-batch striping so rows are in dataset order again."""
    n_proc, n_batches, b = stacked.shape[:3]
    out = stacked.transpose(1, 0, 2, *range(3, stacked.ndim))
    return out.reshape(n_batches, n_proc * b, *stacked.shape[3:])


#: per-all-gather chunk budget (bytes of GLOBAL rows per chunk): peak host
#: memory stays near (result + one chunk) instead of several copies of a
#: whole pass (an ImageNet train-set feature matrix)
ASSEMBLE_CHUNK_BYTES = 64 << 20


def assemble_global_outputs(outs: Sequence[np.ndarray],
                            valids: Sequence[int], total: int,
                            chunk_bytes: Optional[int] = None) -> np.ndarray:
    """Per-batch host outputs → the global dataset-order array on every rank.

    ``outs[i]`` is this process's rows of batch ``i`` (the whole batch on one
    process).  ``collect_scores`` semantics: per-batch ``valids`` (GLOBAL
    counts) rows kept, concatenated, truncated to ``total``.  Several
    processes: the stripe stacks are all-gathered in chunks of at most
    ``chunk_bytes`` (default :data:`ASSEMBLE_CHUNK_BYTES`, read at call
    time) of global rows, written straight into one preallocated result.
    Every rank joins every chunk, those past ``total`` included: a rank that
    skipped one would leave the others waiting in it."""
    from mcm_tpu_torch.data.pipeline import collect_scores

    if not outs:
        return np.zeros((0,), dtype=np.float32)
    n_proc = process_count()
    if n_proc == 1:
        return collect_scores(outs, valids, total)
    local = np.stack([np.asarray(o) for o in outs])  # [n_batches, b, ...]
    n_batches, b = local.shape[:2]
    feat_shape = local.shape[2:]
    row_bytes = local.dtype.itemsize * int(np.prod(feat_shape,
                                                   dtype=np.int64))
    budget = ASSEMBLE_CHUNK_BYTES if chunk_bytes is None else chunk_bytes
    chunk = max(1, int(budget) // max(1, row_bytes * b * n_proc))

    offsets = np.concatenate(([0], np.cumsum(valids)))
    n_rows = int(min(total, offsets[-1]))
    out = np.empty((n_rows,) + feat_shape, dtype=local.dtype)
    for lo in range(0, n_batches, chunk):
        hi = min(lo + chunk, n_batches)
        mine = torch.from_numpy(np.ascontiguousarray(local[lo:hi]))
        parts = [torch.empty_like(mine) for _ in range(n_proc)]
        dist.all_gather(parts, mine)
        if offsets[lo] >= n_rows:
            continue   # joined for the lockstep; nothing of it is kept
        full = interleave_process_stripes(
            np.stack([p.numpy() for p in parts]))   # [hi-lo, B, ...]
        for i in range(lo, hi):
            start = int(offsets[i])
            if start >= n_rows:
                break
            v = min(int(valids[i]), n_rows - start)
            out[start:start + v] = full[i - lo, :v]
    return out


# -- collectives of data-parallel training ---------------------------------------

def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, contiguous (gloo's tensors)."""
    return t.detach().to("cpu").contiguous()


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``[b, ...]`` rows → ``[world·b, ...]`` in rank order, on
    ``x``'s device (``x`` itself on one process).

    This rank's rows are ``x`` itself and the other ranks' are constants, so
    the backward of the result gives ``x`` exactly its own rows of the
    incoming gradient.  Every rank then back-propagates a loss over the
    whole batch through its own rows only, and the gradients summed over
    the ranks (:func:`all_reduce_sum_`) count each row once.  Built from
    gloo's ``all_gather`` of host copies (``torch.distributed.nn``'s
    gathering autograd op needs ``reduce_scatter``, which gloo lacks)."""
    world = process_count()
    if world == 1:
        return x
    mine = _to_host(x)
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    rows = [p.to(x.device, non_blocking=True) for p in parts]
    rows[process_index()] = x
    return torch.cat(rows)


def all_reduce_sum_(tensors: List[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place: one flattened fp32 host
    buffer, one gloo ``all_reduce``, copied back.  Every rank ends with the
    same bits (the reduction gives all ranks one result)."""
    if process_count() == 1 or not tensors:
        return
    flat = torch.cat([_to_host(t).reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view(t.shape))
            offset += n
