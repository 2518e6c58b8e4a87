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
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from mcm_tpu_torch.train.contrastive import TrainState


def _flatten(state: TrainState) -> Tuple[List[torch.Tensor], str]:
    named = list(state.params.named_parameters())
    index = {id(p): i for i, (_, p) in enumerate(named)}
    opt = state.opt_state
    leaves = [p for _, p in named]
    groups, slots = [], []
    for group in opt.param_groups:
        ids = [index[id(p)] for p in group["params"]]
        groups.append(ids)
        for i, p in zip(ids, group["params"]):
            slot = opt.state.get(p, {})
            keys = sorted(k for k, v in slot.items()
                          if isinstance(v, torch.Tensor))
            slots.append(f"{i}:{','.join(keys)}")
            leaves.extend(slot[k] for k in keys)
    names = " ".join(n for n, _ in named)
    structure = (f"mcm_tpu_torch.TrainState(params=[{names}], "
                 f"opt_state={type(opt).__name__}(groups={groups}, "
                 f"state=[{' '.join(slots)}]))")
    return leaves, structure


def save_train_state(state: TrainState, path: str, *, epoch: int) -> None:
    """Persist the full state after ``epoch`` completed epochs."""
    leaves, structure = _flatten(state)
    arrs = {f"leaf_{i}": l.detach().cpu().numpy()
            for i, l in enumerate(leaves)}
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
            if arr.shape != tuple(t.shape):
                raise ValueError(f"{path}: leaf {i} shape {arr.shape} != "
                                 f"expected {tuple(t.shape)}")
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
            t.copy_(torch.from_numpy(arr))
    return TrainState(template.params, template.opt_state, step), epoch
