"""Supervised ViT classifier in PyTorch — the MSP-baseline model.

The reference's hard-OOD comparison runs a supervised
``google/vit-base-patch16-224`` with an MSP score (README ``:27``; the
``vit-Linear`` branches at ``utils/detection_util.py:124-126`` take
``last_hidden_state[:, 0]`` into a linear head).  The tower of the JAX
package's ``models/vit.py``: learned CLS and position embeddings, no
pre-LN, pre-LN blocks with an exact (erf) GELU MLP computed in fp32,
eps 1e-12 LayerNorms, a final LayerNorm on the CLS token and a
classifier head.

It reuses the CLIP tower's primitives (:func:`~mcm_tpu_torch.models.clip._dense`,
``layer_norm``, ``patchify``, and :func:`~mcm_tpu_torch.ops.attention.encoder_attention`,
which picks the bsd kernel for unmasked bf16 attention on the card), so
its numerics follow the JAX package's the same way the CLIP tower's do.
The model state is :class:`SupervisedViT`, the JAX parameter tree as an
``nn.Module`` (:func:`from_jax_vit_params`).

Weights come from an HF ``ViTForImageClassification`` state dict
(:func:`convert_hf_vit`); :func:`resolve_vit_params` finds them under
``--ckpt_dir``.
"""

from __future__ import annotations

import os
import warnings
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from mcm_tpu_torch.config import Precision, SupervisedViTConfig, resolve_device
from mcm_tpu_torch.models.clip import (_COMPUTE_DTYPE_LEAVES, ParamTree, _dense,
                                       _unstack, layer_norm, patchify)
from mcm_tpu_torch.models.convert import (_ckpt_dir, _snapshot_weight_file,
                                          _stack, load_params, load_state_dict,
                                          save_params)
from mcm_tpu_torch.ops.attention import encoder_attention

Params = Dict[str, Any]

#: the name of the converted cache and of the HF snapshot directory under
#: ``--ckpt_dir``
VIT_NPZ = "vit-base-patch16-224.npz"
VIT_SNAPSHOT = "vit-base-patch16-224"


class SupervisedViT(ParamTree):
    """The model state under the JAX tree's names: ``patch_embed``,
    ``patch_bias``, ``class_emb``, ``pos_emb``, the stacked ``layers``,
    ``final_ln`` and the classifier ``head`` {``w``, ``b``}.  The matrices
    (the head's ``w`` included) are stored in the compute dtype."""


def from_jax_vit_params(params: Params, device="cuda",
                        dtype: torch.dtype = torch.float32) -> SupervisedViT:
    """The JAX package's supervised-ViT tree (numpy arrays, as
    ``init_supervised_vit`` or :func:`convert_hf_vit` return it) → the
    port's :class:`SupervisedViT` on ``device``, matrices stored in
    ``dtype`` as :func:`~mcm_tpu_torch.models.convert.from_jax_params`
    stores CLIP's; LayerNorm parameters and biases stay fp32."""
    return SupervisedViT(params, resolve_device(device), dtype,
                         _COMPUTE_DTYPE_LEAVES | {"w"})


def _vit_block(x: torch.Tensor, layer: Dict[str, Any], *, heads: int,
               eps: float, precision: Precision) -> torch.Tensor:
    """Pre-LN ViT block with exact (erf) GELU, computed in fp32."""
    attn, mlp = layer["attn"], layer["mlp"]
    h = layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"], eps)
    q = _dense(h, attn["wq"], attn["bq"], precision)
    k = _dense(h, attn["wk"], attn["bk"], precision)
    v = _dense(h, attn["wv"], attn["bv"], precision)
    a = encoder_attention(q, k, v, heads=heads, mask=None,
                          precision=precision)
    x = x + _dense(a, attn["wo"], attn["bo"], precision)
    h = layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"], eps)
    h = _dense(h, mlp["w1"], mlp["b1"], precision)
    h = torch.nn.functional.gelu(h.float()).to(h.dtype)
    return x + _dense(h, mlp["w2"], mlp["b2"], precision)


def forward_features(params: SupervisedViT, cfg: SupervisedViTConfig,
                     pixel_values: torch.Tensor,
                     precision: Precision = Precision.parity()) -> torch.Tensor:
    """CLS-token features after the final LayerNorm ([B, width]).

    pixel_values: [B, H, W, C] normalized floats (NCHW is accepted too).
    The final LayerNorm runs on the CLS row only: LayerNorm is per token,
    so it equals the JAX package's LayerNorm of every token, then CLS."""
    if pixel_values.shape[-1] != 3 and pixel_values.shape[1] == 3:
        pixel_values = pixel_values.permute(0, 2, 3, 1)
    cdt = precision.activation_dtype

    patches = patchify(pixel_values, cfg.patch_size)
    x = _dense(patches, params["patch_embed"], params["patch_bias"],
               precision)
    cls = params["class_emb"].to(cdt).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + params["pos_emb"].to(cdt)

    for layer in _unstack(params["layers"]):
        x = _vit_block(x, layer, heads=cfg.heads,
                       eps=cfg.layer_norm_eps, precision=precision)
    return layer_norm(x[:, 0, :], params["final_ln"]["scale"],
                      params["final_ln"]["bias"], cfg.layer_norm_eps)


def forward_logits(params: SupervisedViT, cfg: SupervisedViTConfig,
                   pixel_values: torch.Tensor,
                   precision: Precision = Precision.parity()) -> torch.Tensor:
    """Classifier logits [B, num_classes] in fp32 (rounded to the compute
    dtype first, as in the JAX package)."""
    feats = forward_features(params, cfg, pixel_values, precision)
    return _dense(feats, params["head"]["w"], params["head"]["b"],
                  precision).float()


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def resolve_vit_params(cfg: SupervisedViTConfig, ckpt_dir: Optional[str] = None,
                       cache: bool = False) -> Optional[Params]:
    """Supervised-ViT weights from ``ckpt_dir`` (the converted
    ``vit-base-patch16-224.npz``, else an HF ``google/vit-base-patch16-224``
    snapshot directory beside it), or None.  A corrupt ``.npz`` warns and
    the snapshot is converted instead; ``cache=True`` writes the converted
    tree as that ``.npz``."""
    ckpt_dir = _ckpt_dir(ckpt_dir)
    native = os.path.join(ckpt_dir, VIT_NPZ)
    if os.path.exists(native):
        try:
            return load_params(native)
        except (ValueError, OSError, KeyError, zipfile.BadZipFile) as e:
            # a truncated cache must not hide the snapshot beside it
            warnings.warn(f"cached {native} is unreadable ({e}); "
                          f"re-converting from the source checkpoint")
    snapshot = os.path.join(ckpt_dir, VIT_SNAPSHOT)
    if os.path.isdir(snapshot):
        params = convert_hf_vit(load_state_dict(snapshot), cfg)
        if cache:
            try:
                os.makedirs(ckpt_dir, exist_ok=True)
                save_params(params, native)
            except OSError:
                pass
        return params
    return None


def resolve_vit_weight_source(ckpt_dir: Optional[str] = None) -> Optional[str]:
    """The file :func:`resolve_vit_params` loads weights from, or None —
    the vit-Linear half of the ``--resume`` weight fingerprint."""
    ckpt_dir = _ckpt_dir(ckpt_dir)
    native = os.path.join(ckpt_dir, VIT_NPZ)
    if os.path.exists(native):
        return native
    snapshot = os.path.join(ckpt_dir, VIT_SNAPSHOT)
    if os.path.isdir(snapshot):
        return _snapshot_weight_file(snapshot) or snapshot
    return None


def convert_hf_vit(sd: Dict[str, np.ndarray],
                   cfg: SupervisedViTConfig) -> Params:
    """Map an HF ``ViTForImageClassification`` state dict onto the tree."""
    def stack(tmpl: str, transpose: bool) -> np.ndarray:
        return _stack(sd, "vit.encoder.layer.{}" + tmpl, cfg.layers, transpose)

    def A(name):
        return sd[name].astype(np.float32)

    p = cfg.patch_size
    conv_w = sd["vit.embeddings.patch_embeddings.projection.weight"]
    # (D, 3, p, p) → (p, p, 3, D) → (p*p*3, D): the patchify order
    patch_embed = conv_w.transpose(2, 3, 1, 0).reshape(p * p * 3, cfg.width)
    layers = {
        "ln1": {"scale": stack(".layernorm_before.weight", False),
                "bias": stack(".layernorm_before.bias", False)},
        "attn": {
            "wq": stack(".attention.attention.query.weight", True),
            "bq": stack(".attention.attention.query.bias", False),
            "wk": stack(".attention.attention.key.weight", True),
            "bk": stack(".attention.attention.key.bias", False),
            "wv": stack(".attention.attention.value.weight", True),
            "bv": stack(".attention.attention.value.bias", False),
            "wo": stack(".attention.output.dense.weight", True),
            "bo": stack(".attention.output.dense.bias", False),
        },
        "ln2": {"scale": stack(".layernorm_after.weight", False),
                "bias": stack(".layernorm_after.bias", False)},
        "mlp": {
            "w1": stack(".intermediate.dense.weight", True),
            "b1": stack(".intermediate.dense.bias", False),
            "w2": stack(".output.dense.weight", True),
            "b2": stack(".output.dense.bias", False),
        },
    }
    return {
        "patch_embed": patch_embed.astype(np.float32),
        "patch_bias": A("vit.embeddings.patch_embeddings.projection.bias"),
        "class_emb": A("vit.embeddings.cls_token").reshape(-1),
        "pos_emb": A("vit.embeddings.position_embeddings")[0],
        "layers": layers,
        "final_ln": {"scale": A("vit.layernorm.weight"),
                     "bias": A("vit.layernorm.bias")},
        "head": {"w": sd["classifier.weight"].T.astype(np.float32),
                 "b": A("classifier.bias")},
    }
