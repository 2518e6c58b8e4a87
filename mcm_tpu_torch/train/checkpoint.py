"""Full train-state checkpointing: params + optimizer moments + progress
(the JAX package's ``train/checkpoint.py``).

The per-epoch ``.npz`` params checkpoint (``loop.py``) is for consumption
by ``--model CLIP-Linear``; resuming training also needs AdamW's moments
and the step count, or the optimizer re-warms and the trajectory changes.

Format: one ``.npz`` holding the leaves by index (the parameters in
``named_parameters`` order, then each parameter's optimizer state by key),
the step counter, the completed-epoch count and a structure string.  The
structure string is the port's own (parameter names, optimizer class and
groups, state keys): a file of another optimizer, model or config, or the
JAX package's ``.train_state.npz``, is refused, as are leaves of another
shape or dtype.  Writes are atomic (tmp + ``os.replace``).

A tensor-parallel model (:class:`~mcm_tpu_torch.parallel.tensor.ShardedCLIP`)
is written as its unsharded tree: each split leaf, and each of its moments,
is the join of its shards' slices, so the file, structure string included,
is the one a run with a model axis of 1 writes, and a restore splits it
again over the template's shards, whatever their count.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from mcm_tpu_torch.parallel import tensor as ttensor
from mcm_tpu_torch.train.contrastive import TrainState


class _Leaf:
    """One leaf of the unsharded state: its shards' tensors (one for a whole
    leaf) joined along ``axis``; a 0-d tensor (a step count) is the same on
    every shard and is read from the first."""

    def __init__(self, parts: List[torch.Tensor], axis: Optional[int]):
        self.parts = parts
        self.axis = axis if parts[0].dim() else None
        shape = list(parts[0].shape)
        if self.axis is not None:
            shape[self.axis] = sum(p.shape[self.axis] for p in parts)
        self.shape = tuple(shape)
        self.dtype = parts[0].dtype

    def numpy(self) -> np.ndarray:
        if self.axis is None:
            return self.parts[0].detach().cpu().numpy()
        return torch.cat([p.detach().cpu() for p in self.parts],
                         dim=self.axis).numpy()

    def copy_(self, arr: np.ndarray) -> None:
        t = torch.from_numpy(arr)
        pieces = ([t] * len(self.parts) if self.axis is None else
                  t.split([p.shape[self.axis] for p in self.parts],
                          dim=self.axis))
        for p, piece in zip(self.parts, pieces):
            p.copy_(piece)


def _flatten(state: TrainState) -> Tuple[List[_Leaf], str]:
    logical = ttensor.logical_parameters(state.params)
    index = {id(p): i for i, (_, parts, _) in enumerate(logical)
             for p in parts}
    opt = state.opt_state
    leaves = [_Leaf(parts, axis) for _, parts, axis in logical]
    groups, slots = [], []
    for group in opt.param_groups:
        # a split leaf's shards are one leaf of the unsharded tree
        ids = list(dict.fromkeys(index[id(p)] for p in group["params"]))
        groups.append(ids)
        for i in ids:
            _, parts, axis = logical[i]
            states = [opt.state.get(p, {}) for p in parts]
            keys = sorted(k for k, v in states[0].items()
                          if isinstance(v, torch.Tensor))
            slots.append(f"{i}:{','.join(keys)}")
            leaves.extend(_Leaf([s[k] for s in states], axis) for k in keys)
    names = " ".join(n for n, _, _ in logical)
    structure = (f"mcm_tpu_torch.TrainState(params=[{names}], "
                 f"opt_state={type(opt).__name__}(groups={groups}, "
                 f"state=[{' '.join(slots)}]))")
    return leaves, structure


def save_train_state(state: TrainState, path: str, *, epoch: int) -> None:
    """Persist the full state after ``epoch`` completed epochs."""
    leaves, structure = _flatten(state)
    arrs = {f"leaf_{i}": l.numpy() for i, l in enumerate(leaves)}
    arrs["__step"] = np.asarray(int(state.step), np.int64)
    arrs["__epoch"] = np.asarray(int(epoch), np.int64)
    arrs["__treedef"] = np.frombuffer(structure.encode(), np.uint8)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        # write through a file object: np.savez(str) appends ".npz" to
        # extension-less paths, which would break the atomic rename
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_train_state(path: str,
                     template: TrainState) -> Tuple[TrainState, int]:
    """Restore ``(state, completed_epochs)`` into ``template``, a freshly
    built ``init_state(params)``: its structure, leaf shapes and dtypes are
    what the file is checked against, and its tensors (on its device) are
    overwritten in place."""
    leaves, structure = _flatten(template)
    with np.load(path) as data:
        saved = bytes(data["__treedef"]).decode()
        if saved != structure:
            raise ValueError(
                f"{path} was saved for a different train-state structure "
                f"(optimizer/model/config mismatch) — refusing to restore")
        arrs = []
        for i, t in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if arr.shape != t.shape:
                raise ValueError(f"{path}: leaf {i} shape {arr.shape} != "
                                 f"expected {t.shape}")
            want = torch.empty((), dtype=t.dtype).numpy().dtype
            if arr.dtype != want:
                # silently casting (e.g. fp32 moments into a bf16 template)
                # would resume a different trajectory with no error
                raise ValueError(f"{path}: leaf {i} dtype {arr.dtype} != "
                                 f"expected {want}")
            arrs.append(arr)
        step = int(data["__step"])
        epoch = int(data["__epoch"])
    with torch.no_grad():
        for t, arr in zip(leaves, arrs):
            t.copy_(arr)
    return TrainState(template.params, template.opt_state, step), epoch
