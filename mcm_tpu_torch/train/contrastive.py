"""CLIP contrastive fine-tuning: the step that produces the checkpoints
``--model CLIP-Linear`` consumes (the JAX package's
``train/contrastive.py``).

* symmetric InfoNCE over ``logit_scale · img@txtᵀ``, with soft targets
  over duplicate captions (:func:`clip_contrastive_loss`);
* one train step: normalize → both towers → loss → backward → AdamW step
  → the temperature clamp, on one device, or data-parallel as JAX's step
  over a mesh.  On a local mesh (one process over several devices, JAX's
  single-process mesh) the global batch splits into one stripe per data
  group, each group encodes its stripe on its own devices, the features
  and captions are joined on the mesh's first device into JAX's global
  B×B loss, one backward runs through every group, and each replica's
  gradient is summed into the first's on the devices before one AdamW
  step there.  Under a launched group (one rank per card) each rank
  encodes its stripe, the features and captions are gathered
  (:func:`~mcm_tpu_torch.parallel.multihost.gather_rows`) into the same
  loss, and one all-reduce sums the gradients before the identical AdamW
  step on every rank.  On a mesh whose model axis is ``T`` > 1 both towers
  run over ``T`` shards of the model (:mod:`mcm_tpu_torch.parallel.tensor`),
  one AdamW steps every shard's leaves and their moments live on the
  shard's device;
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
from mcm_tpu_torch.parallel import tensor as ttensor
from mcm_tpu_torch.parallel.mesh import Mesh, shard_params, validate_tp
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
    """The model (fp32 leaves that require grad: a
    :class:`~mcm_tpu_torch.models.clip.CLIP`, or a
    :class:`~mcm_tpu_torch.parallel.tensor.ShardedCLIP` on a
    tensor-parallel mesh), its optimizer (which holds the AdamW moments)
    and the count of steps taken.  The step updates the first two in place
    and returns a new tuple."""

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
    """Build ``(init_state, train_step)`` on one device, or over ``mesh``
    (:func:`~mcm_tpu_torch.parallel.mesh.make_mesh`; its first device
    replaces ``device``; a model axis above 1 shards the towers over each
    data group's devices).

    ``init_state(params)`` takes the numpy tree (``init_clip``,
    ``load_params``); ``train_step(state, images_u8 [B,H,W,3], input_ids
    [B,S], mask [B,S]) → (state, loss)``, host arrays or tensors in, the
    loss a 0-d fp32 tensor on the mesh's first device (read it when the
    host needs it).

    On a local mesh of ``G`` data groups the arrays are the global batch
    (``G`` must divide ``B``), ``state.params`` is the first group's model
    and the others are replicas that ``init_state`` builds beside it: each
    step copies the parameters out to them before its forward, runs group
    ``g`` on rows ``[g·B/G, (g+1)·B/G)``, and sums their gradients into
    the first group's (shard ``j`` of a group into shard ``j`` of the
    first), on the devices and in group order, before the one AdamW step.
    Under a launched group of ``n`` ranks the arrays are this rank's stripe
    of a global batch of ``n·B`` and the loss is the global batch's, the
    same on every rank.  ``train_step.comm_s`` accumulates the seconds of
    the moves between data groups (the joins, the gradient sum, the copy
    to the replicas; under a launch the collectives with their host
    copies), timed from synchronized devices.

    Attention as in JAX: ``precision.attn_impl == "pallas_bsd_vjp"`` keeps
    the trainable bsd route (the kernel's forward, the math path's
    gradient) and, as JAX's, is refused on a mesh of more than one device;
    anything else trains on the math path (``"xla"``).  The MLP is always
    the unfused math path.  As JAX's, the towers' split is checked
    against the mesh first (``validate_tp``)."""
    if optimizer is None:
        # CLIP recipe: weight decay on the ndim >= 2 leaves (decay_matrices)
        optimizer = adamw(1e-5, weight_decay=0.2, mask=decay_matrices)
    device = resolve_device(device) if mesh is None else mesh.device
    groups = ((device,),) if mesh is None else mesh.groups
    local = len(groups)                       # data groups of this process
    world = 1 if mesh is None or local > 1 else mesh.data   # launched ranks
    tp = 1 if mesh is None else mesh.model
    if mesh is not None:
        validate_tp(cfg, mesh)
    if precision.attn_impl == "pallas_bsd_vjp":
        if mesh is not None and mesh.data * mesh.model != 1:
            raise ValueError("attn_impl=pallas_bsd_vjp cannot be "
                             "pjit-partitioned — use a single-device mesh "
                             "or attn_impl='xla'")
        attn = "pallas_bsd_vjp"
    else:
        attn = "xla"
    precision = dataclasses.replace(precision, attn_impl=attn, mlp_impl="xla")
    apply_matmul_policy(precision)
    cards = sorted({d for g in groups for d in g if d.type == "cuda"},
                   key=str)
    #: the model ``init_state`` built last and its replicas on the other
    #: data groups of a local mesh
    built: dict = {"lead": None, "replicas": []}

    def encode_image(params, x):
        return ttensor.encode_image(params, cfg.vision, x, precision)

    def encode_text(params, ids, mask):
        return ttensor.encode_text(params, cfg.text, ids, mask, precision)

    def tower(fn, params, *args):
        if remat:
            return torch.utils.checkpoint.checkpoint(
                fn, params, *args, use_reentrant=False)
        return fn(params, *args)

    def collective(fn, *args):
        """``fn(*args)``, its seconds added to ``train_step.comm_s``."""
        for card in cards:
            torch.cuda.synchronize(card)
        t = time.perf_counter()
        out = fn(*args)
        train_step.comm_s += time.perf_counter() - t
        return out

    def forward(model, group, images_u8, input_ids, mask):
        """One data group's towers on its stripe: ``(img, txt, ids,
        mask)`` on the group's first device."""
        dev = group[0]
        images, ids, mask = (_as_device(x, dev)
                             for x in (images_u8, input_ids, mask))
        x = normalize_on_device(images, CLIP_MEAN, CLIP_STD,
                                dtype=precision.activation_dtype)
        return (tower(encode_image, model, x),
                tower(encode_text, model, ids, mask), ids, mask)

    def train_step(state: TrainState, images_u8, input_ids, mask):
        params, opt = state.params, state.opt_state
        opt.zero_grad(set_to_none=True)
        if local == 1:
            img, txt, ids, mask = forward(params, groups[0], images_u8,
                                          input_ids, mask)
        else:
            if built["lead"] is not params:
                raise ValueError("a train state of another init_state: "
                                 "its replicas are not this step's")
            models = [params, *built["replicas"]]
            collective(_copy_to_replicas, models)
            n = len(images_u8)
            if n % local:
                raise ValueError(f"a batch of {n} rows does not split over "
                                 f"the {local} data groups of the mesh")
            b = n // local
            parts = [forward(m, g, *(x[i * b:(i + 1) * b] for x in
                                     (images_u8, input_ids, mask)))
                     for i, (m, g) in enumerate(zip(models, groups))]
            # JAX's global B×B loss on the first device, stripes in order
            img, txt, ids, mask = (collective(_join, p, device)
                                   for p in zip(*parts))
        if world > 1:
            # JAX's global B×B loss: every rank's rows, this rank's live
            img, txt, ids, mask = (collective(multihost.gather_rows, t)
                                   for t in (img, txt, ids, mask))
        logit_scale = ttensor.whole_leaves(params)["logit_scale"]
        loss = clip_contrastive_loss(
            img, txt, logit_scale,
            positive_mask=_duplicate_caption_mask(ids, mask))
        loss.backward()
        if world > 1:
            _sum_gradients(params, collective)
        if local > 1:
            collective(_sum_replica_gradients, models)
        opt.step()
        with torch.no_grad():
            # the CLIP temperature clamp (see MAX_LOGIT_SCALE)
            logit_scale.clamp_(0.0, MAX_LOGIT_SCALE)
        return TrainState(params, opt, state.step + 1), loss.detach()

    def init_state(params) -> TrainState:
        if tp > 1:
            models = shard_params(params, mesh, trainable=True)
            # each leaf's slices side by side, in the unsharded tree's order
            named = [(f"{name}.{j}", p)
                     for name, parts, _ in ttensor.logical_parameters(
                         models[0])
                     for j, p in enumerate(parts)]
        else:
            models = [from_jax_params(params, g[0], trainable=True)
                      for g in groups]
            named = list(models[0].named_parameters())
        built.update(lead=models[0], replicas=models[1:])
        opt = optimizer(named)
        init_optimizer_state(opt)
        return TrainState(models[0], opt, 0)

    train_step.comm_s = 0.0
    return init_state, train_step


def _join(parts, device: torch.device) -> torch.Tensor:
    """The data groups' rows, in group order, on ``device`` (a move that
    autograd follows back to each group)."""
    return torch.cat([p.to(device) for p in parts])


@torch.no_grad()
def _copy_to_replicas(models) -> None:
    """The first model's parameters into every replica (shard ``j`` into
    shard ``j``), device to device, and the replicas' gradients dropped."""
    lead = ttensor.logical_parameters(models[0])
    for model in models[1:]:
        for (_, src, _), (_, dst, _) in zip(
                lead, ttensor.logical_parameters(model)):
            for s, d in zip(src, dst):
                d.copy_(s)
                d.grad = None


@torch.no_grad()
def _sum_replica_gradients(models) -> None:
    """Every replica's gradient summed into the first model's, on the
    first model's devices and in replica order (shard ``j`` of each group
    into shard ``j`` of the first).  A leaf a replica took no gradient for
    is skipped: ``logit_scale`` enters the loss once, through the first
    model, so it counts once, as :func:`_sum_gradients` counts it over
    ranks."""
    lead = ttensor.logical_parameters(models[0])
    for model in models[1:]:
        for (_, mine, _), (_, theirs, _) in zip(
                lead, ttensor.logical_parameters(model)):
            for p, q in zip(mine, theirs):
                if q.grad is None:
                    continue
                g = q.grad.to(p.device)
                if p.grad is None:
                    p.grad = g.clone()
                else:
                    p.grad.add_(g)


def _sum_gradients(params: tclip.CLIP, collective) -> None:
    """Each rank's gradient reaches its own rows only (``gather_rows``), so
    the sum over the ranks is the global loss's gradient: one all-reduce of
    every gradient.  ``logit_scale`` is the exception: it enters the loss
    directly, and every rank computed the same global loss, so each holds
    its whole gradient already; only rank 0's copy joins the sum.  Every
    shard of a tensor-parallel model sums with its counterparts."""
    if multihost.process_index() != 0:
        ttensor.whole_leaves(params)["logit_scale"].grad.zero_()
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
