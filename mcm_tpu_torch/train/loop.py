"""Epoch-level CLIP fine-tuning loop: data pipeline, shuffling, checkpoints
(the JAX package's ``train/loop.py``).

Per-epoch seeded shuffling over the (path, label) dataset, full batches
through the evaluator's decode pipeline (``drop_remainder``), caption
prompts built from class names ("a photo of a {c}", the text the
zero-shot evaluator scores with), and per-epoch ``.npz`` checkpoints that
``--model CLIP-Linear`` loads, beside a full train-state sibling for
``resume``.

On a local mesh (one process over several devices, the default form of
:func:`~mcm_tpu_torch.parallel.mesh.make_mesh`) the process decodes each
global batch whole and the step splits it over its data groups; the
checkpoint is the first group's model, written once.  Under ``python -m
torch.distributed.run`` (one rank per card, the process form) every rank
draws the same permutation, decodes its stripe of each global batch and
takes the data-parallel step; the parameters stay equal on every rank, so
rank 0 alone logs and writes both files (where JAX writes orbax for
params that span processes), and it alone decides whether ``resume``
finds a state.  A tensor-parallel model is written unsharded: both files
have the layout of a run with a model axis of 1 on one device, and a
resume shards and replicates them again, so a state saved at one
``n_devices`` or ``model_parallel``, in one process or under a launch,
resumes at another.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mcm_tpu_torch.config import CLIPConfig, Precision
from mcm_tpu_torch.data.pipeline import DataPipeline
from mcm_tpu_torch.models.convert import save_params
from mcm_tpu_torch.models.init import init_clip
from mcm_tpu_torch.parallel import multihost
from mcm_tpu_torch.parallel import tensor as ttensor
from mcm_tpu_torch.parallel.mesh import Mesh, make_mesh
from mcm_tpu_torch.train.checkpoint import load_train_state, save_train_state
from mcm_tpu_torch.train.contrastive import (OptimizerFactory, TrainState,
                                             make_train_step)


class ShuffledView:
    """Zero-copy permuted view of a (path, label) dataset."""

    def __init__(self, dataset, perm: np.ndarray):
        self.dataset = dataset
        self.perm = perm

    def __len__(self) -> int:
        return len(self.perm)

    def __getitem__(self, i: int):
        return self.dataset[int(self.perm[i])]


def train_clip(cfg: CLIPConfig, dataset, class_names: Sequence[str],
               tokenizer, *, epochs: int = 1, batch_size: int = 64,
               seed: int = 5, optimizer: Optional[OptimizerFactory] = None,
               precision: Precision = Precision.fast(), device="cuda",
               params=None, num_workers: Optional[int] = None,
               image_size: Optional[int] = None,
               ckpt_path: Optional[str] = None, resume: bool = False,
               label_permutation: Optional[np.ndarray] = None,
               log: Callable[[str], None] = print,
               mesh: Optional[Mesh] = None) -> TrainState:
    """Fine-tune CLIP contrastively on an ImageFolder-style dataset.

    ``params`` is the numpy tree to start from (default: ``init_clip(seed,
    cfg)``).  ``label_permutation`` maps a dataset label index to its row
    in ``class_names`` (``data.labels.prompt_permutation``: ImageNet100's
    class list is not in label order); ``None`` = identity.

    Each image is paired with the prompt of its class name; batches are
    reshuffled every epoch (seeded).  If ``ckpt_path`` is set, the params
    tree is saved there after every epoch, with a full-state sibling
    ``<ckpt>.train_state.npz`` (optimizer moments, step, epoch).
    ``resume=True`` restores that sibling when present and continues from
    the next epoch; the shuffle stream of completed epochs is replayed, so
    a resumed run walks the batches of an uninterrupted one.

    ``mesh`` (default: :func:`make_mesh` on ``device``: every visible card
    in this process, or under a launch the world size of the process
    group) sets the data groups: ``batch_size`` is the global batch, and
    must divide by them.  Only rank 0 calls ``log``.
    """
    if mesh is None:
        mesh = make_mesh(None, device=device)
    init_state, train_step = make_train_step(cfg, optimizer=optimizer,
                                             precision=precision, mesh=mesh)
    if multihost.process_index() != 0:
        log = _silent
    if params is None:
        params = init_clip(seed, cfg)
    state = init_state(params)

    prompts = [f"a photo of a {c}" for c in class_names]
    ids_all, mask_all = tokenizer(prompts, pad_to_multiple=8,
                                  context_length=cfg.text.context_length)
    ids_all = np.asarray(ids_all, np.int32)
    mask_all = np.asarray(mask_all, np.int32)
    if label_permutation is not None:
        # reorder prompt rows into dataset-label order once, up front
        ids_all = ids_all[label_permutation]
        mask_all = mask_all[label_permutation]

    rng = np.random.default_rng(seed)
    n = len(dataset)
    if n < batch_size:
        raise ValueError(f"dataset ({n}) smaller than batch ({batch_size})")
    size = image_size or cfg.vision.image_size

    state_path = f"{ckpt_path}.train_state.npz" if ckpt_path else None
    start_epoch = 0
    # rank 0 decides, so every rank restores (or none does)
    if multihost.broadcast_object(bool(resume and state_path
                                       and os.path.exists(state_path))):
        state, start_epoch = load_train_state(state_path, state)
        log(f"resumed from {state_path}: {start_epoch} epoch(s) done, "
            f"step {state.step}")

    for epoch in range(epochs):
        # the permutation is always drawn, so a resumed run's shuffle
        # stream is an uninterrupted run's
        perm = rng.permutation(n)
        if epoch < start_epoch:
            continue
        pipe = DataPipeline(ShuffledView(dataset, perm), batch_size,
                            image_size=size, num_workers=num_workers,
                            drop_remainder=True)
        losses = []
        t0 = time.perf_counter()
        for batch in pipe:
            state, loss = train_step(state, batch.images,
                                     ids_all[batch.labels],
                                     mask_all[batch.labels])
            losses.append(loss)
        mean_loss = float(np.mean(torch.stack(losses).cpu().numpy()))
        comm = (f"; collectives {train_step.comm_s:.1f}s"
                if mesh.data > 1 else "")
        train_step.comm_s = 0.0
        log(f"epoch {epoch + 1}/{epochs}: loss {mean_loss:.4f}  "
            f"({len(losses)} steps, {time.perf_counter() - t0:.1f}s{comm})")
        if not np.isfinite(mean_loss):
            raise FloatingPointError(f"non-finite loss at epoch {epoch + 1}")
        if ckpt_path:
            _save_checkpoint(state, ckpt_path, state_path, epoch + 1, log)
    return state


def _silent(_msg: str) -> None:
    """The log of the ranks other than 0."""


def _save_checkpoint(state: TrainState, ckpt_path: str, state_path: str,
                     epoch: int, log) -> None:
    """The params tree as ``.npz`` (the file ``--model CLIP-Linear`` and
    the JAX package's ``load_params`` read) and the full-state sibling,
    after ``epoch`` completed epochs.  Under a process group the params are
    the same on every rank, so rank 0 writes both files (JAX writes orbax
    when its params span processes) and the others wait for it."""
    if multihost.process_index() == 0:
        save_params(ttensor.host_tree(state.params), ckpt_path)
        save_train_state(state, state_path, epoch=epoch)
        log(f"checkpoint -> {ckpt_path}")
    multihost.barrier()
