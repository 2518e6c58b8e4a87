"""CLIP contrastive fine-tuning: the step that produces the checkpoints
``--model CLIP-Linear`` consumes (the JAX package's
``train/contrastive.py``).

* symmetric InfoNCE over ``logit_scale · img@txtᵀ``, with soft targets
  over duplicate captions (:func:`clip_contrastive_loss`);
* one train step: normalize → both towers → loss → backward → AdamW step
  → the temperature clamp, on one device, or data-parallel over the ranks
  of a process group (one per card): each rank encodes its stripe of the
  global batch, the features and captions are gathered
  (:func:`~mcm_tpu_torch.parallel.multihost.gather_rows`) into JAX's
  global B×B loss, and one all-reduce sums the gradients before the
  identical AdamW step on every rank;
* gradient checkpointing over each whole tower (``jax.checkpoint`` wraps
  ``encode_image`` and ``encode_text`` in JAX; here
  ``torch.utils.checkpoint``), trading a second forward for memory.

The parameters are fp32 master copies that the forward casts per product,
as JAX trains ``init_clip``'s fp32 tree.  An optimizer is a factory
``[(name, parameter)] → torch.optim.Optimizer`` (:func:`adamw` builds the
one optax's ``adamw`` describes), so callers choose it as they pass an
optax transformation to JAX's step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from mcm_tpu_torch.config import (CLIPConfig, Precision, apply_matmul_policy,
                                  resolve_device)
from mcm_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD, normalize_on_device
from mcm_tpu_torch.models import clip as tclip
from mcm_tpu_torch.models.convert import from_jax_params
from mcm_tpu_torch.parallel import multihost
from mcm_tpu_torch.parallel.mesh import Mesh
from mcm_tpu_torch.scores.clip_scores import l2_normalize

#: CLIP's temperature cap: logit_scale is clamped so exp(·) ≤ 100 after
#: every update (the OpenAI training recipe; pretrained checkpoints ship at
#: this cap)
MAX_LOGIT_SCALE = 4.6051702  # ln(100)

NamedParams = List[Tuple[str, torch.Tensor]]
OptimizerFactory = Callable[[NamedParams], torch.optim.Optimizer]


def decay_matrices(p: torch.Tensor) -> bool:
    """The weight-decay mask of JAX's train step and ``finetune_clip``:
    ``ndim >= 2``.  On the stacked tree that spares only the unstacked 1-D
    leaves (``pre_ln``, ``post_ln``, ``final_ln``, ``class_emb``) and
    ``logit_scale``; every per-layer LayerNorm and bias is ``[L, D]`` and
    so is decayed, as in JAX."""
    return p.dim() >= 2


def adamw(lr: float, *, weight_decay: float = 1e-4,
          mask: Optional[Callable[[torch.Tensor], bool]] = None
          ) -> OptimizerFactory:
    """``optax.adamw`` as an optimizer factory, with optax's defaults
    (betas (0.9, 0.999), eps 1e-8, weight decay 1e-4, not torch's 1e-2).  ``mask(p)`` picks the leaves
    that are decayed (None: all of them); the others go into a second
    parameter group without decay."""

    def make(named: NamedParams) -> torch.optim.Optimizer:
        decay = [p for _, p in named if mask is None or mask(p)]
        keep = [p for _, p in named if not (mask is None or mask(p))]
        groups = [{"params": ps, "weight_decay": wd}
                  for ps, wd in ((decay, weight_decay), (keep, 0.0)) if ps]
        return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)

    return make


def clip_contrastive_loss(image_feats: torch.Tensor, text_feats: torch.Tensor,
                          logit_scale: torch.Tensor,
                          positive_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Symmetric cross-entropy over the similarity matrix (fp32).

    ``positive_mask`` ([B, B] bool, diagonal always true) marks pairs whose
    captions are identical: soft targets spread each row's mass uniformly
    over its true positives (multi-positive InfoNCE), so duplicate class
    captions are not pushed apart as false negatives.  ``None`` =
    all-distinct, the classic loss."""
    img = l2_normalize(image_feats).float()
    txt = l2_normalize(text_feats).float()
    scale = torch.exp(logit_scale.float())
    logits = scale * (img @ txt.T)
    if positive_mask is None:
        # optax.softmax_cross_entropy_with_integer_labels
        diag = torch.arange(logits.shape[0], device=logits.device)
        loss_i = -_log_softmax(logits)[diag, diag]
        loss_t = -_log_softmax(logits.T)[diag, diag]
        return 0.5 * (loss_i.mean() + loss_t.mean())
    pos = positive_mask.float()
    t_i = pos / pos.sum(-1, keepdim=True)
    t_t = pos.T / pos.T.sum(-1, keepdim=True)
    loss_i = -(_log_softmax(logits) * t_i).sum(-1)
    loss_t = -(_log_softmax(logits.T) * t_t).sum(-1)
    return 0.5 * (loss_i.mean() + loss_t.mean())


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` over the last axis, its formula written out
    (the max held constant): the loss then rounds as JAX's does, which
    ``F.log_softmax``'s fused kernel does not quite."""
    shifted = x - x.amax(dim=-1, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _duplicate_caption_mask(input_ids: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """[B, B] bool: rows whose (masked) token sequences are identical."""
    ids = torch.where(mask.bool(), input_ids, -1)
    return (ids[:, None, :] == ids[None, :, :]).all(dim=-1)


class TrainState(NamedTuple):
    """The model (fp32 leaves that require grad), its optimizer (which
    holds the AdamW moments) and the count of steps taken.  The step
    updates the first two in place and returns a new tuple."""

    params: tclip.CLIP
    opt_state: torch.optim.Optimizer
    step: int


def _as_device(x, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def make_train_step(cfg: CLIPConfig,
                    optimizer: Optional[OptimizerFactory] = None,
                    precision: Precision = Precision.fast(),
                    device="cuda", remat: bool = True,
                    mesh: Optional[Mesh] = None
                    ) -> Tuple[Callable, Callable]:
    """Build ``(init_state, train_step)`` on one device, or on this rank's
    card of ``mesh`` (:func:`~mcm_tpu_torch.parallel.mesh.make_mesh`; its
    device replaces ``device``).

    ``init_state(params)`` takes the numpy tree (``init_clip``,
    ``load_params``); ``train_step(state, images_u8 [B,H,W,3], input_ids
    [B,S], mask [B,S]) → (state, loss)``, host arrays or tensors in, the
    loss a 0-d fp32 tensor on the device (read it when the host needs it).
    On a mesh of ``n`` ranks the arrays are this rank's stripe of a global
    batch of ``n·B`` and the loss is the global batch's, the same on every
    rank; ``train_step.comm_s`` accumulates the seconds of the collectives
    (with their host copies, timed from a synchronized device).

    Attention as in JAX: ``precision.attn_impl == "pallas_bsd_vjp"`` keeps
    the trainable bsd route (the kernel's forward, the math path's
    gradient) and, as JAX's, is refused on a mesh of more than one device;
    anything else trains on the math path (``"xla"``).  The MLP is always
    the unfused math path."""
    if optimizer is None:
        # CLIP recipe: weight decay on the ndim >= 2 leaves (decay_matrices)
        optimizer = adamw(1e-5, weight_decay=0.2, mask=decay_matrices)
    device = resolve_device(device) if mesh is None else mesh.device
    world = 1 if mesh is None else mesh.data
    if precision.attn_impl == "pallas_bsd_vjp":
        if world != 1:
            raise ValueError("attn_impl=pallas_bsd_vjp cannot be "
                             "pjit-partitioned — use a single-device mesh "
                             "or attn_impl='xla'")
        attn = "pallas_bsd_vjp"
    else:
        attn = "xla"
    precision = dataclasses.replace(precision, attn_impl=attn, mlp_impl="xla")
    apply_matmul_policy(precision)

    def encode_image(params, x):
        return tclip.encode_image(params, cfg.vision, x, precision)

    def encode_text(params, ids, mask):
        return tclip.encode_text(params, cfg.text, ids, mask, precision)

    def tower(fn, params, *args):
        if remat:
            return torch.utils.checkpoint.checkpoint(
                fn, params, *args, use_reentrant=False)
        return fn(params, *args)

    def collective(fn, *args):
        """``fn(*args)``, its seconds added to ``train_step.comm_s``."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = fn(*args)
        train_step.comm_s += time.perf_counter() - t
        return out

    def train_step(state: TrainState, images_u8, input_ids, mask):
        params, opt = state.params, state.opt_state
        images = _as_device(images_u8, device)
        ids = _as_device(input_ids, device)
        mask = _as_device(mask, device)
        opt.zero_grad(set_to_none=True)
        x = normalize_on_device(images, CLIP_MEAN, CLIP_STD,
                                dtype=precision.activation_dtype)
        img = tower(encode_image, params, x)
        txt = tower(encode_text, params, ids, mask)
        if world > 1:
            # JAX's global B×B loss: every rank's rows, this rank's live
            img, txt, ids, mask = (collective(multihost.gather_rows, t)
                                   for t in (img, txt, ids, mask))
        loss = clip_contrastive_loss(
            img, txt, params["logit_scale"],
            positive_mask=_duplicate_caption_mask(ids, mask))
        loss.backward()
        if world > 1:
            _sum_gradients(params, collective)
        opt.step()
        with torch.no_grad():
            # the CLIP temperature clamp (see MAX_LOGIT_SCALE)
            params["logit_scale"].clamp_(0.0, MAX_LOGIT_SCALE)
        return TrainState(params, opt, state.step + 1), loss.detach()

    def init_state(params) -> TrainState:
        model = from_jax_params(params, device, trainable=True)
        opt = optimizer(list(model.named_parameters()))
        init_optimizer_state(opt)
        return TrainState(model, opt, 0)

    train_step.comm_s = 0.0
    return init_state, train_step


def _sum_gradients(params: tclip.CLIP, collective) -> None:
    """Each rank's gradient reaches its own rows only (``gather_rows``), so
    the sum over the ranks is the global loss's gradient: one all-reduce of
    every gradient.  ``logit_scale`` is the exception: it enters the loss
    directly, and every rank computed the same global loss, so each holds
    its whole gradient already; only rank 0's copy joins the sum."""
    if multihost.process_index() != 0:
        params["logit_scale"].grad.zero_()
    grads = [p.grad for p in params.parameters() if p.grad is not None]
    collective(multihost.all_reduce_sum_, grads)


def init_optimizer_state(opt: torch.optim.Optimizer) -> None:
    """Give an Adam / AdamW its zero moments and step now rather than at
    its first step (JAX's ``optimizer.init``), so a fresh state already
    has the structure a saved one is checked against.  Values and types are
    those ``torch.optim`` sets at the first step; other optimizers keep
    their own lazy state."""
    if not isinstance(opt, torch.optim.Adam | torch.optim.AdamW):
        return
    for group in opt.param_groups:
        scalar_on_device = group["capturable"] or group["fused"]
        for p in group["params"]:
            if opt.state[p]:
                continue
            opt.state[p] = {
                "step": torch.zeros((), dtype=torch.float32,
                                    device=p.device if scalar_on_device
                                    else "cpu"),
                "exp_avg": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    p, memory_format=torch.preserve_format)}
            if group["amsgrad"]:
                opt.state[p]["max_exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
