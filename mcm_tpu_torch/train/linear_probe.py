"""Linear probing on frozen CLIP features (the JAX package's
``train/linear_probe.py``).

Backs the reference's ``CLIP-Linear`` / ``vit-Linear`` model variants: a
linear classifier over frozen encoder features, trained with softmax
cross-entropy.  Features are extracted once (they are frozen), so probe
training is ``[N, D]×[D, C]`` products, minibatched on the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mcm_tpu_torch.config import resolve_device
from mcm_tpu_torch.train.contrastive import OptimizerFactory, adamw


class LinearProbe(NamedTuple):
    w: torch.Tensor  # [D, C]
    b: torch.Tensor  # [C]


def init_linear_probe(seed: int, feat_dim: int, n_classes: int,
                      device="cuda") -> LinearProbe:
    """JAX's init: numpy SFC64 normals scaled by ``feat_dim ** -0.5`` and a
    zero bias, so one seed gives the same probe in both packages."""
    rng = np.random.Generator(np.random.SFC64(int(seed)))
    w = rng.standard_normal((feat_dim, n_classes),
                            dtype=np.float32) * feat_dim ** -0.5
    device = resolve_device(device)
    return LinearProbe(torch.from_numpy(w).to(device),
                       torch.zeros((n_classes,), dtype=torch.float32,
                                   device=device))


def probe_logits(probe: LinearProbe, features: torch.Tensor,
                 T: float = 1.0) -> torch.Tensor:
    logits = features.float() @ probe.w + probe.b
    return logits / T


def make_linear_probe_step(optimizer: Optional[OptimizerFactory] = None,
                           device="cuda") -> Tuple[Callable, Callable]:
    """(init_fn, step_fn): ``init_fn(seed, feat_dim, n_classes) → (probe,
    opt_state)``; ``step_fn(probe, opt_state, feats, labels) → (probe,
    opt_state, loss, accuracy)``, the probe updated in place, loss and
    accuracy 0-d tensors.  Default optimizer: ``optax.adamw(1e-3)``
    (weight decay 1e-4 on ``w`` and ``b``)."""
    optimizer = optimizer or adamw(1e-3)
    device = resolve_device(device)

    def step_fn(probe: LinearProbe, opt_state: torch.optim.Optimizer,
                feats: torch.Tensor, labels: torch.Tensor):
        opt_state.zero_grad(set_to_none=True)
        logits = probe_logits(probe, feats)
        loss = F.cross_entropy(logits, labels.long())
        acc = (logits.argmax(-1) == labels).float().mean()
        loss.backward()
        opt_state.step()
        return probe, opt_state, loss.detach(), acc

    def init_fn(seed, feat_dim, n_classes):
        probe = LinearProbe(*(t.requires_grad_() for t in init_linear_probe(
            seed, feat_dim, n_classes, device)))
        return probe, optimizer([("w", probe.w), ("b", probe.b)])

    return init_fn, step_fn


def train_linear_probe(features, labels, n_classes: int, *, epochs: int = 10,
                       batch_size: int = 1024, seed: int = 0,
                       optimizer: Optional[OptimizerFactory] = None,
                       device="cuda"):
    """Minibatch-train a probe over pre-extracted frozen features.

    Returns ``(probe, mean_loss, mean_acc)``: final-epoch averages over the
    minibatches, not the last minibatch's numbers.  Batches are full-size:
    the ragged remainder is folded into the last batch as an overlap with
    the previous one (JAX keeps one compiled step shape this way; the port
    keeps its batch order).  Features and labels go to the device once."""
    init_fn, step_fn = make_linear_probe_step(optimizer, device)
    probe, opt_state = init_fn(seed, features.shape[1], n_classes)
    dev = probe.w.device
    feats = torch.as_tensor(np.asarray(features)).to(dev)
    labs = torch.as_tensor(np.asarray(labels)).to(dev)
    n = features.shape[0]
    batch_size = min(batch_size, n)
    rng = np.random.default_rng(seed)
    mean_loss = mean_acc = float("nan")
    for _ in range(epochs):
        order = rng.permutation(n)
        losses, accs = [], []
        for lo in range(0, n, batch_size):
            if lo + batch_size > n:  # overlap, keep the batch size
                lo = n - batch_size
            idx = torch.from_numpy(order[lo:lo + batch_size]).to(dev)
            probe, opt_state, loss, acc = step_fn(probe, opt_state,
                                                  feats[idx], labs[idx])
            losses.append(loss)
            accs.append(acc)
        mean_loss = float(np.mean(torch.stack(losses).cpu().numpy()))
        mean_acc = float(np.mean(torch.stack(accs).cpu().numpy()))
    return probe, mean_loss, mean_acc
