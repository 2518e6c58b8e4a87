"""Tensor parallelism: the forward of both CLIP towers over the shards of
one data group (JAX's Megatron layout, ``mcm_tpu/parallel/mesh.py``).

JAX shards the stacked layer weights over the mesh's ``model`` axis and
lets the SPMD partitioner derive the rest: each device computes its heads'
attention and its slice of the MLP hidden units, and the partitioner
all-reduces the row-parallel products.  The port writes that program out,
from :mod:`mcm_tpu_torch.models.clip`'s own primitives:

* the residual stream, the LayerNorms, the embeddings, pooling and the
  projection stay on the group's first device (shard 0, which alone holds
  the whole leaves);
* per layer, each shard takes ``ln1(x)``, computes its column-parallel
  ``q/k/v`` slices, attends over its ``H/T`` heads and computes its
  row-parallel partial ``a_j @ wo_j`` in fp32;
* the partials meet on the first device, summed in fp32 in shard order,
  then the fp32 bias, then ONE cast to the activation dtype: the single
  rounding of ``_dense`` (JAX's ``preferred_element_type=fp32`` product is
  what its partitioner all-reduces);
* the MLP the same way: ``w1`` column-parallel, QuickGELU per shard,
  ``w2`` row-parallel, then the sum, ``b2`` and the cast.

Every move between devices is a plain ``.to(device)``, so autograd
differentiates the forward (ODIN, training) with no hand-written
collective; shards on one card make the moves no-ops.  As in JAX, a
tensor-parallel forward runs the math paths: the step classes refuse a
forced kernel on such a mesh.

The module-level :func:`encode_image`, :func:`encode_text`,
:func:`whole_leaves`, :func:`logical_parameters` and :func:`host_tree`
take either model, a :class:`~mcm_tpu_torch.models.clip.CLIP` (which they
pass to :mod:`mcm_tpu_torch.models.clip` as it is) or a
:class:`ShardedCLIP`, so their callers never branch on the model's type.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from mcm_tpu_torch.config import Precision, TextConfig, VisionConfig
from mcm_tpu_torch.models import clip as tclip
from mcm_tpu_torch.models.clip import (CLIP, ParamTree, _dense, _text_mask,
                                       layer_norm, patchify)
from mcm_tpu_torch.models.convert import to_jax_params
from mcm_tpu_torch.ops.attention import encoder_attention
from mcm_tpu_torch.ops.numerics import matmul_f32
from mcm_tpu_torch.parallel.mesh import split_axis, unshard_params


class ShardedCLIP(nn.Module):
    """One data group's model: ``shards[j]`` on the group's device ``j``.
    Shard 0 is a whole :class:`~mcm_tpu_torch.models.clip.CLIP` tree whose
    split leaves are its slices; the others hold only their slices of the
    layers.  Build it with :func:`~.mesh.shard_params`."""

    def __init__(self, trees: Sequence[Dict[str, Any]],
                 devices: Sequence[torch.device], dtype: torch.dtype,
                 trainable: bool = False):
        super().__init__()
        if trainable and dtype != torch.float32:
            raise ValueError(f"trainable parameters are fp32 master copies; "
                             f"got dtype={dtype}")
        self.shards = nn.ModuleList(
            (CLIP if j == 0 else ParamTree)(tree, dev, dtype,
                                            requires_grad=trainable)
            for j, (tree, dev) in enumerate(zip(trees, devices)))

    @property
    def lead(self) -> CLIP:
        """Shard 0: the whole leaves, on the group's first device."""
        return self.shards[0]



def whole_leaves(model) -> CLIP:
    """The tree that holds the whole leaves (``logit_scale``): the model
    itself, or shard 0 of a sharded one."""
    return model.lead if isinstance(model, ShardedCLIP) else model


def logical_parameters(model) -> List[tuple]:
    """``(name, parts, axis)`` for each leaf of the unsharded tree, in its
    ``named_parameters`` order: a split leaf's slices in shard order with
    their axis, a whole leaf alone with ``None``."""
    if not isinstance(model, ShardedCLIP):
        return [(name, [p], None) for name, p in model.named_parameters()]
    out = []
    for name, p in model.lead.named_parameters():
        axis = split_axis(name)
        parts = ([s.get_parameter(name) for s in model.shards]
                 if axis is not None else [p])
        out.append((name, parts, axis))
    return out


def host_tree(model) -> Dict[str, Any]:
    """The model's whole numpy tree on the host (a sharded one joined)."""
    if isinstance(model, ShardedCLIP):
        return unshard_params(model)
    return to_jax_params(model)


def _unstack(layers: nn.Module) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Each layer's leaves of one shard out of the stacked tree, as views
    (one ``unbind`` a leaf, as :func:`mcm_tpu_torch.models.clip._unstack`,
    which needs the LayerNorms a shard other than 0 lacks)."""
    split = {name: {leaf: p.unbind(0) for leaf, p in sub.named_parameters()}
             for name, sub in layers.named_children()}
    n = len(next(iter(split["attn"].values())))
    return [{name: {leaf: ps[i] for leaf, ps in sub.items()}
             for name, sub in split.items()} for i in range(n)]


def _reduce(partials: List[torch.Tensor], bias: torch.Tensor,
            device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The row-parallel partials summed on ``device`` in fp32, in shard
    order, then the fp32 bias and one cast to ``dtype``."""
    y = partials[0].to(device)
    for p in partials[1:]:
        y = y + p.to(device)
    return (y + bias.float()).to(dtype)


def transformer_block(x: torch.Tensor, shard_layers: Sequence[Dict],
                      *, heads: int, eps: float,
                      mask: Optional[torch.Tensor],
                      precision: Precision, act: str) -> torch.Tensor:
    """One pre-LN CLIP encoder layer over the shards (``shard_layers[j]``,
    shard ``j``'s leaves of this layer; shard 0's also hold the whole ones),
    ``heads`` the heads of each shard, ``act`` the MLP's activation."""
    lead = shard_layers[0]
    cdt = precision.activation_dtype
    h = layer_norm(x, lead["ln1"]["scale"], lead["ln1"]["bias"], eps)
    partials = []
    for layer in shard_layers:
        attn = layer["attn"]
        dev = attn["wq"].device
        hj = h.to(dev)
        q = _dense(hj, attn["wq"], attn["bq"], precision)
        k = _dense(hj, attn["wk"], attn["bk"], precision)
        v = _dense(hj, attn["wv"], attn["bv"], precision)
        a = encoder_attention(q, k, v, heads=heads,
                              mask=None if mask is None else mask.to(dev),
                              precision=precision)
        partials.append(matmul_f32(a.to(cdt), attn["wo"].to(cdt)))
    x = x + _reduce(partials, lead["attn"]["bo"], x.device, cdt)

    h = layer_norm(x, lead["ln2"]["scale"], lead["ln2"]["bias"], eps)
    partials = []
    for layer in shard_layers:
        mlp = layer["mlp"]
        g = _dense(h.to(mlp["w1"].device), mlp["w1"], mlp["b1"], precision,
                   act=act)
        partials.append(matmul_f32(g.to(cdt), mlp["w2"].to(cdt)))
    return x + _reduce(partials, lead["mlp"]["b2"], x.device, cdt)


def run_transformer(x: torch.Tensor, model: ShardedCLIP, tower: str, *,
                    heads: int, eps: float, mask: Optional[torch.Tensor],
                    precision: Precision, act: str) -> torch.Tensor:
    """Loop over the stacked layers of ``tower`` on every shard."""
    per_shard = [_unstack(s[tower]["layers"]) for s in model.shards]
    tp = len(model.shards)
    for shard_layers in zip(*per_shard):
        x = transformer_block(x, shard_layers, heads=heads // tp, eps=eps,
                              mask=mask, precision=precision, act=act)
    return x


def encode_image(model, cfg: VisionConfig, pixel_values: torch.Tensor,
                 precision: Precision = Precision.parity()) -> torch.Tensor:
    """:func:`mcm_tpu_torch.models.clip.encode_image`, over the shards of a
    :class:`ShardedCLIP`: image features in the joint space, not
    L2-normalized, on the group's first device."""
    if not isinstance(model, ShardedCLIP):
        return tclip.encode_image(model, cfg, pixel_values, precision)
    v = model.lead["vision"]
    if pixel_values.shape[-1] != 3 and pixel_values.shape[1] == 3:
        pixel_values = pixel_values.permute(0, 2, 3, 1)
    cdt = precision.activation_dtype
    patches = patchify(pixel_values, cfg.patch_size)
    x = _dense(patches, v["patch_embed"], None, precision)
    cls = v["class_emb"].to(cdt).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + v["pos_emb"].to(cdt)
    x = layer_norm(x, v["pre_ln"]["scale"], v["pre_ln"]["bias"],
                   cfg.layer_norm_eps)
    x = run_transformer(x, model, "vision", heads=cfg.heads,
                        eps=cfg.layer_norm_eps, mask=None,
                        precision=precision, act=cfg.hidden_act)
    pooled = layer_norm(x[:, 0, :], v["post_ln"]["scale"],
                        v["post_ln"]["bias"], cfg.layer_norm_eps)
    return _dense(pooled, v["proj"], None, precision)


def encode_text(model, cfg: TextConfig, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                precision: Precision = Precision.parity()) -> torch.Tensor:
    """:func:`mcm_tpu_torch.models.clip.encode_text`, over the shards of a
    :class:`ShardedCLIP`: text features in the joint space, not
    L2-normalized, on the group's first device."""
    if not isinstance(model, ShardedCLIP):
        return tclip.encode_text(model, cfg, input_ids, attention_mask,
                                 precision)
    t = model.lead["text"]
    cdt = precision.activation_dtype
    b, s = input_ids.shape
    ids = input_ids.long()
    x = t["token_emb"][ids].to(cdt)
    x = x + t["pos_emb"][:s].to(cdt)
    mask = _text_mask(attention_mask, s, b, x.device)
    x = run_transformer(x, model, "text", heads=cfg.heads,
                        eps=cfg.layer_norm_eps, mask=mask,
                        precision=precision, act=cfg.hidden_act)
    x = layer_norm(x, t["final_ln"]["scale"], t["final_ln"]["bias"],
                   cfg.layer_norm_eps)
    eot_idx = torch.argmax(ids, dim=-1)  # EOT has the largest id
    pooled = x[torch.arange(b, device=x.device), eot_idx]
    return _dense(pooled, t["proj"], None, precision)
