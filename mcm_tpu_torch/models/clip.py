"""CLIP in PyTorch: the two towers of the JAX package's ``models/clip.py``.

* vision tower: patchify as one matmul (not a conv), CLS token, learned
  position embeddings, pre-LN transformer, post-LN on the CLS token,
  linear projection into the joint space;
* text tower: token + position embeddings, causal pre-LN transformer,
  final LN, EOT pooling (argmax of the ids: the OpenAI EOT id is the
  largest), linear projection.

The model state is :class:`CLIP`, an ``nn.Module`` whose ``vision`` and
``text`` towers hold the parameters under the JAX tree's names (weights
``[in, out]``, per-layer tensors stacked on a leading axis), so
``params["vision"]["layers"]["attn"]["wq"]`` reads as in JAX.  The math is
plain functions on tensors.  Numerics follow the JAX package: QuickGELU,
LayerNorm in fp32, every product accumulated in fp32
(:func:`mcm_tpu_torch.ops.numerics.matmul_f32`), activations in
``precision.activation_dtype``.  A tower whose ``hidden_act`` is ``"gelu"``
(OpenCLIP's ViT-bigG/14, which the JAX package lacks) runs the exact erf
GELU in fp32 on the biased product, before its one rounding.  What follows
a product with a bias (the bias add, the rounding, the activation or the
residual add) runs on the card as one kernel
(:mod:`mcm_tpu_torch.ops.dense_epilogue`) with the same roundings.

``precision.mlp_impl == "pallas"`` routes each layer's MLP, in both
towers, through the fused MLP kernel (:func:`mcm_tpu_torch.ops.mlp.fused_mlp`)
with the JAX package's casts: ``w1``/``w2`` in the activation dtype, fp32
biases, rows flattened to ``[B·S, D]``.  It needs no weights beyond the
tree's ``mlp.w1/b1/w2/b2``, which :func:`~mcm_tpu_torch.models.convert.from_jax_params`
already carries.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from mcm_tpu_torch.config import Precision, TextConfig, VisionConfig
from mcm_tpu_torch.ops import dense_epilogue as epi
from mcm_tpu_torch.ops.attention import encoder_attention
from mcm_tpu_torch.ops.mlp import fused_mlp
from mcm_tpu_torch.ops.numerics import matmul_f32

#: leaves the forward casts to the compute dtype, so they are stored in it;
#: LayerNorm parameters and biases are used in fp32 and stay fp32
_COMPUTE_DTYPE_LEAVES = frozenset({
    "patch_embed", "class_emb", "pos_emb", "token_emb", "proj",
    "wq", "wk", "wv", "wo", "w1", "w2"})


class ParamTree(nn.Module):
    """Nested parameters under the JAX tree's names.  Leaves named in
    ``compute_leaves`` are stored in ``dtype``, the rest in fp32; they are
    frozen (inference) unless ``requires_grad`` (training, where every leaf
    is an fp32 master copy the forward casts per product, as JAX's)."""

    def __init__(self, tree: Dict[str, Any], device: torch.device,
                 dtype: torch.dtype,
                 compute_leaves: frozenset = _COMPUTE_DTYPE_LEAVES,
                 requires_grad: bool = False):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value, device, dtype,
                                               compute_leaves, requires_grad))
            else:
                dt = dtype if key in compute_leaves else torch.float32
                t = torch.from_numpy(np.array(value, np.float32))
                self.register_parameter(key, nn.Parameter(
                    t.to(device=device, dtype=dt),
                    requires_grad=requires_grad))

    def __getitem__(self, key: str):
        return getattr(self, key)


class CLIP(ParamTree):
    """The model state: ``vision`` and ``text`` towers and ``logit_scale``.
    Build it with :func:`mcm_tpu_torch.models.convert.from_jax_params`;
    run it with :func:`encode_image` / :func:`encode_text`."""


# ---------------------------------------------------------------------------
# Primitive blocks
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in fp32 regardless of input dtype (returns input dtype)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           precision: Precision, *, act: Optional[str] = None,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w + b with fp32 accumulation and an fp32 bias add, output in
    the compute dtype; then ``quick_gelu(y)`` for ``act="quick_gelu"``, or
    ``residual + y``; ``act="gelu"`` runs the erf GELU on the fp32 sum,
    before the rounding.  The epilogue after the product runs as one kernel
    where :func:`~mcm_tpu_torch.ops.dense_epilogue.takes_kernel` allows,
    else as the plain chain: the same numbers either way.
    ``_dense.plain`` counts the calls that took the plain chain."""
    cdt = precision.activation_dtype
    y = matmul_f32(x.to(cdt), w.to(cdt))
    if epi.takes_kernel(y, b, cdt, residual):
        return epi.dense_epilogue(y, b.float(), act=act, residual=residual)
    _dense.plain += 1
    return epi.epilogue_reference(y, b, cdt, act, residual)


_dense.plain = 0


def _unstack(layers: nn.Module) -> list:
    """Each layer's parameters out of the stacked tree, as views.  One
    ``unbind`` a leaf: its gradient is one stack of the layers' gradients
    (indexing each layer would add a zero-filled full-size gradient per
    layer)."""
    split = {name: {leaf: p.unbind(0) for leaf, p in sub.named_parameters()}
             for name, sub in layers.named_children()}
    n = layers["ln1"]["scale"].shape[0]
    return [{name: {leaf: ps[i] for leaf, ps in sub.items()}
             for name, sub in split.items()} for i in range(n)]


def transformer_block(x: torch.Tensor, layer: Dict[str, Any], *, heads: int,
                      eps: float, mask: Optional[torch.Tensor],
                      precision: Precision, act: str) -> torch.Tensor:
    """One pre-LN CLIP encoder layer: x += attn(ln1(x)); x += mlp(ln2(x)),
    the MLP's activation ``act`` (the tower's ``hidden_act``)."""
    attn, mlp = layer["attn"], layer["mlp"]
    h = layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"], eps)
    q = _dense(h, attn["wq"], attn["bq"], precision)
    k = _dense(h, attn["wk"], attn["bk"], precision)
    v = _dense(h, attn["wv"], attn["bv"], precision)
    a = encoder_attention(q, k, v, heads=heads, mask=mask,
                          precision=precision)
    x = _dense(a, attn["wo"], attn["bo"], precision, residual=x)

    h = layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"], eps)
    if precision.mlp_impl == "pallas":
        cdt = precision.activation_dtype
        b, s, d = h.shape
        h = fused_mlp(h.reshape(b * s, d), mlp["w1"].to(cdt), mlp["b1"],
                      mlp["w2"].to(cdt), mlp["b2"], act=act).reshape(b, s, d)
        return x + h
    h = _dense(h, mlp["w1"], mlp["b1"], precision, act=act)
    return _dense(h, mlp["w2"], mlp["b2"], precision, residual=x)


def run_transformer(x: torch.Tensor, layers: nn.Module, *, heads: int,
                    eps: float, mask: Optional[torch.Tensor],
                    precision: Precision, act: str,
                    collect_hidden: bool = False):
    """Loop over the stacked per-layer parameters, the MLPs' activation
    ``act``.  ``collect_hidden=True`` also returns the per-layer outputs
    stacked as [L, B, S, D]."""
    hs = []
    for layer in _unstack(layers):
        x = transformer_block(x, layer, heads=heads, eps=eps,
                              mask=mask, precision=precision, act=act)
        if collect_hidden:
            hs.append(x)
    return (x, torch.stack(hs)) if collect_hidden else x


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------

def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] → [B, N, patch*patch*C] with (ph, pw, c) patch order
    (the order the checkpoint converter flattens the conv kernel in)."""
    b, h, w, c = pixel_values.shape
    p = patch_size
    x = pixel_values.reshape(b, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, H/p, W/p, p, p, C]
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def encode_image(params: nn.Module, cfg: VisionConfig,
                 pixel_values: torch.Tensor,
                 precision: Precision = Precision.parity(),
                 collect_hidden: bool = False):
    """Image features in the joint space, NOT L2-normalized.

    pixel_values: [B, H, W, C] float (resized/cropped/normalized), NHWC;
    NCHW is accepted too (auto-transposed).  ``collect_hidden=True`` →
    ``(features, hiddens)`` with hiddens [L+1, B, S, D]: the layer-0 input
    (post pre-LN) followed by every layer's output.
    """
    v = params["vision"]
    if pixel_values.shape[-1] != 3 and pixel_values.shape[1] == 3:
        pixel_values = pixel_values.permute(0, 2, 3, 1)
    cdt = precision.activation_dtype

    patches = patchify(pixel_values, cfg.patch_size)
    x = _dense(patches, v["patch_embed"], None, precision)  # [B, N, D]
    cls = v["class_emb"].to(cdt).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)  # [B, N+1, D]
    x = x + v["pos_emb"].to(cdt)

    x = layer_norm(x, v["pre_ln"]["scale"], v["pre_ln"]["bias"],
                   cfg.layer_norm_eps)
    out = run_transformer(x, v["layers"], heads=cfg.heads,
                          eps=cfg.layer_norm_eps, mask=None,
                          precision=precision, collect_hidden=collect_hidden,
                          act=cfg.hidden_act)
    hiddens = None
    if collect_hidden:
        last, hs = out
        hiddens = torch.cat([x[None], hs], dim=0)
        x = last
    else:
        x = out

    pooled = layer_norm(x[:, 0, :], v["post_ln"]["scale"],
                        v["post_ln"]["bias"], cfg.layer_norm_eps)
    feats = _dense(pooled, v["proj"], None, precision)
    return (feats, hiddens) if collect_hidden else feats


# ---------------------------------------------------------------------------
# Text tower
# ---------------------------------------------------------------------------

def _text_mask(attention_mask: Optional[torch.Tensor], seq_len: int,
               batch: int, device: torch.device) -> torch.Tensor:
    """Additive fp32 mask: causal + key-padding, -1e9.  [B, 1, S, S]."""
    neg = -1e9
    causal = torch.triu(torch.full((seq_len, seq_len), neg,
                                   dtype=torch.float32, device=device), 1)
    mask = causal[None, None].expand(batch, 1, seq_len, seq_len)
    if attention_mask is not None:
        pad = (1.0 - attention_mask.float()) * neg
        mask = mask + pad[:, None, None, :]
    return mask


def encode_text(params: nn.Module, cfg: TextConfig, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                precision: Precision = Precision.parity(),
                collect_hidden: bool = False):
    """Text features in the joint space, NOT L2-normalized.

    input_ids: [B, S] integer ids (S ≤ context_length).  Pooling takes the
    position of the largest id (the EOT token).  ``collect_hidden=True`` →
    ``(features, hiddens)``, hiddens [L+1, B, S, D].
    """
    t = params["text"]
    cdt = precision.activation_dtype
    b, s = input_ids.shape
    ids = input_ids.long()

    x = t["token_emb"][ids].to(cdt)
    x = x + t["pos_emb"][:s].to(cdt)

    mask = _text_mask(attention_mask, s, b, x.device)
    out = run_transformer(x, t["layers"], heads=cfg.heads,
                          eps=cfg.layer_norm_eps, mask=mask,
                          precision=precision, collect_hidden=collect_hidden,
                          act=cfg.hidden_act)
    hiddens = None
    if collect_hidden:
        last, hs = out
        hiddens = torch.cat([x[None], hs], dim=0)
        x = last
    else:
        x = out
    x = layer_norm(x, t["final_ln"]["scale"], t["final_ln"]["bias"],
                   cfg.layer_norm_eps)

    eot_idx = torch.argmax(ids, dim=-1)  # EOT has the largest id
    pooled = x[torch.arange(b, device=x.device), eot_idx]
    feats = _dense(pooled, t["proj"], None, precision)
    return (feats, hiddens) if collect_hidden else feats
