"""Deterministic synthesized HF ``CLIPModel`` state dicts, from numpy alone.

The same keys, shapes and values as the JAX package's
``mcm_tpu/models/hf_synth.py`` (its numpy-only helpers, copied): every
value is a pure function of ``(key, seed)``.  They stand in for real
``openai/clip-vit-*`` weights where none can be fetched: the converter is
held against the JAX package's on them, and ``chip_smoke.py`` writes one
as an HF snapshot for the CLI to convert on a card host that has no JAX.

The same holds for the supervised ViT of the MSP baseline: an HF
``ViTForImageClassification`` state dict (``google/vit-base-patch16-224``'s
keys and shapes at the full config) from the same value rule, and
:func:`write_hf_vit_snapshot`, which saves it as the snapshot directory
the vit-Linear path converts.

It also carries the numpy-only helpers of the HF parity tools
(``mcm_tpu_torch.tools.parity_check``): the golden configs, the
deterministic probe inputs and the ``transformers.CLIPConfig`` kwargs, all
equal to the JAX package's.  :func:`build_hf_clip` alone needs
``transformers``, which it imports when called: the module imports on a
host without it.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, Tuple

import numpy as np

from mcm_tpu_torch.config import (CLIPConfig, SupervisedViTConfig, TextConfig,
                                  VisionConfig)


def golden_config() -> CLIPConfig:
    """The mid-size model of ``tests/goldens/clip_synth_6l384.npz``: 6 layers,
    384 wide, 224²/16 patches (197-token sequences), a 1000-entry vocab."""
    return CLIPConfig(
        name="synth-6L384",
        vision=VisionConfig(image_size=224, patch_size=16, width=384,
                            layers=6, heads=6, projection_dim=384),
        text=TextConfig(vocab_size=1000, context_length=77, width=384,
                        layers=6, heads=6, projection_dim=384))


def synth_scale_config(name: str) -> CLIPConfig:
    """The full-size config of a synthesized golden: ``"b16"`` → ViT-B/16,
    ``"l14"`` → ViT-L/14."""
    from mcm_tpu_torch.config import CLIP_CONFIGS

    return CLIP_CONFIGS[{"b16": "ViT-B/16", "l14": "ViT-L/14"}[name]]()


def hf_clip_key_shapes(cfg: CLIPConfig) -> Dict[str, Tuple[int, ...]]:
    """Every key of ``CLIPModel(cfg).state_dict()`` with its shape."""
    v, t = cfg.vision, cfg.text
    shapes: Dict[str, Tuple[int, ...]] = {
        "logit_scale": (),
        "text_model.embeddings.token_embedding.weight":
            (t.vocab_size, t.width),
        "text_model.embeddings.position_embedding.weight":
            (t.context_length, t.width),
        "text_model.final_layer_norm.weight": (t.width,),
        "text_model.final_layer_norm.bias": (t.width,),
        "text_projection.weight": (cfg.embed_dim, t.width),
        "vision_model.embeddings.class_embedding": (v.width,),
        "vision_model.embeddings.patch_embedding.weight":
            (v.width, 3, v.patch_size, v.patch_size),
        "vision_model.embeddings.position_embedding.weight":
            ((v.image_size // v.patch_size) ** 2 + 1, v.width),
        "vision_model.pre_layrnorm.weight": (v.width,),   # sic: HF's name
        "vision_model.pre_layrnorm.bias": (v.width,),
        "vision_model.post_layernorm.weight": (v.width,),
        "vision_model.post_layernorm.bias": (v.width,),
        "visual_projection.weight": (cfg.embed_dim, v.width),
    }
    for tower, tc in (("vision_model", v), ("text_model", t)):
        d, m = tc.width, tc.mlp_width
        for i in range(tc.layers):
            pre = f"{tower}.encoder.layers.{i}"
            for ln in ("layer_norm1", "layer_norm2"):
                shapes[f"{pre}.{ln}.weight"] = (d,)
                shapes[f"{pre}.{ln}.bias"] = (d,)
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                shapes[f"{pre}.self_attn.{proj}.weight"] = (d, d)
                shapes[f"{pre}.self_attn.{proj}.bias"] = (d,)
            shapes[f"{pre}.mlp.fc1.weight"] = (m, d)
            shapes[f"{pre}.mlp.fc1.bias"] = (m,)
            shapes[f"{pre}.mlp.fc2.weight"] = (d, m)
            shapes[f"{pre}.mlp.fc2.bias"] = (d,)
    return shapes


def _value_for(key: str, shape: Tuple[int, ...], seed: int) -> np.ndarray:
    # SFC64 with native float32 normals: fast enough for the full-size
    # dicts, and still a pure function of (key, seed)
    rng = np.random.Generator(
        np.random.SFC64([seed, zlib.crc32(key.encode())]))

    def normal(scale: float) -> np.ndarray:
        return scale * rng.standard_normal(shape, dtype=np.float32)

    if key == "logit_scale":
        return np.float32(np.log(1.0 / 0.07))
    leaf = key.rsplit(".", 1)[-1]
    norm_like = ("layer_norm" in key or "layernorm" in key
                 or "layrnorm" in key)
    if norm_like:
        if leaf == "weight":
            return (1.0 + normal(0.1)).astype(np.float32)
        return normal(0.02)
    if leaf == "bias":
        return normal(0.02)
    # small enough that activations stay O(1) through the layers
    return normal(0.03)


def synth_hf_clip_state_dict(cfg: CLIPConfig,
                             seed: int = 0) -> Dict[str, np.ndarray]:
    """A full, shape-exact HF CLIP state dict with deterministic values."""
    return {k: _value_for(k, s, seed)
            for k, s in hf_clip_key_shapes(cfg).items()}


def zeros_hf_clip_state_dict(cfg: CLIPConfig) -> Dict[str, np.ndarray]:
    """Shape-exact all-zeros dict, for key-coverage and shape checks."""
    return {k: np.zeros(s, np.float32)
            for k, s in hf_clip_key_shapes(cfg).items()}


def hf_to_openai_state_dict(hf_sd: Dict[str, np.ndarray],
                            cfg: CLIPConfig) -> Dict[str, np.ndarray]:
    """The same values in the original OpenAI (github.com/openai/CLIP) key
    layout: q/k/v packed into ``attn.in_proj_*`` (rows q, k, v),
    ``fc1``/``fc2`` as ``c_fc``/``c_proj``, the projections transposed back
    to the ``x @ proj`` orientation."""
    out: Dict[str, np.ndarray] = {
        "logit_scale": hf_sd["logit_scale"],
        "visual.conv1.weight":
            hf_sd["vision_model.embeddings.patch_embedding.weight"],
        "visual.class_embedding":
            hf_sd["vision_model.embeddings.class_embedding"],
        "visual.positional_embedding":
            hf_sd["vision_model.embeddings.position_embedding.weight"],
        "visual.ln_pre.weight": hf_sd["vision_model.pre_layrnorm.weight"],
        "visual.ln_pre.bias": hf_sd["vision_model.pre_layrnorm.bias"],
        "visual.ln_post.weight": hf_sd["vision_model.post_layernorm.weight"],
        "visual.ln_post.bias": hf_sd["vision_model.post_layernorm.bias"],
        "visual.proj": hf_sd["visual_projection.weight"].T,
        "token_embedding.weight":
            hf_sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding":
            hf_sd["text_model.embeddings.position_embedding.weight"],
        "ln_final.weight": hf_sd["text_model.final_layer_norm.weight"],
        "ln_final.bias": hf_sd["text_model.final_layer_norm.bias"],
        "text_projection": hf_sd["text_projection.weight"].T,
    }
    towers = (("vision_model", "visual.transformer", cfg.vision.layers),
              ("text_model", "transformer", cfg.text.layers))
    for hf_tower, oai_tower, n in towers:
        for i in range(n):
            hp = f"{hf_tower}.encoder.layers.{i}"
            op = f"{oai_tower}.resblocks.{i}"
            out[f"{op}.attn.in_proj_weight"] = np.concatenate(
                [hf_sd[f"{hp}.self_attn.{w}.weight"]
                 for w in ("q_proj", "k_proj", "v_proj")], axis=0)
            out[f"{op}.attn.in_proj_bias"] = np.concatenate(
                [hf_sd[f"{hp}.self_attn.{w}.bias"]
                 for w in ("q_proj", "k_proj", "v_proj")], axis=0)
            for hf_name, oai_name in (
                    ("self_attn.out_proj", "attn.out_proj"),
                    ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                    ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
                out[f"{op}.{oai_name}.weight"] = \
                    hf_sd[f"{hp}.{hf_name}.weight"]
                out[f"{op}.{oai_name}.bias"] = hf_sd[f"{hp}.{hf_name}.bias"]
    return out


# ---------------------------------------------------------------------------
# Supervised ViT (HF ViTForImageClassification)
# ---------------------------------------------------------------------------

def hf_clip_config_kwargs(cfg: CLIPConfig) -> Dict[str, object]:
    """kwargs for ``transformers.CLIPConfig`` matching ``cfg`` exactly
    (each tower's MLP width and activation; EOT = the largest id, which HF
    pools at its first occurrence as the port's argmax does)."""
    return dict(
        vision_config=dict(
            image_size=cfg.vision.image_size,
            patch_size=cfg.vision.patch_size,
            hidden_size=cfg.vision.width,
            num_hidden_layers=cfg.vision.layers,
            num_attention_heads=cfg.vision.heads,
            intermediate_size=cfg.vision.mlp_width,
            hidden_act=cfg.vision.hidden_act),
        text_config=dict(
            vocab_size=cfg.text.vocab_size,
            max_position_embeddings=cfg.text.context_length,
            hidden_size=cfg.text.width,
            num_hidden_layers=cfg.text.layers,
            num_attention_heads=cfg.text.heads,
            intermediate_size=cfg.text.mlp_width,
            hidden_act=cfg.text.hidden_act,
            eos_token_id=cfg.text.vocab_size - 1),
        projection_dim=cfg.embed_dim)


def build_hf_clip(cfg: CLIPConfig, sd: Dict[str, np.ndarray]):
    """A real HF ``CLIPModel`` (eval mode, CPU) holding ``sd`` strictly.
    Needs ``transformers``, imported here."""
    import torch
    import transformers

    model = transformers.CLIPModel(
        transformers.CLIPConfig(**hf_clip_config_kwargs(cfg)))
    model.load_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
        strict=True)
    model.eval()
    return model


def probe_inputs(seed: int = 0, batch: int = 8, n_prompts: int = 16,
                 image_size: int = 224, context: int = 77,
                 vocab_size: int = 49408):
    """Deterministic synthetic pixels (NCHW fp32), token ids and mask: BOS
    first, EOT (the largest id) at each row's length and as its padding."""
    rng = np.random.default_rng(seed)
    pixels = rng.standard_normal((batch, 3, image_size,
                                  image_size)).astype(np.float32)
    ids = rng.integers(1, vocab_size - 2,
                       size=(n_prompts, context)).astype(np.int64)
    lengths = rng.integers(5, context, size=n_prompts)
    mask = np.zeros_like(ids)
    ids[:, 0] = vocab_size - 2          # BOS
    for r, length in enumerate(lengths):
        ids[r, length - 1] = vocab_size - 1
        ids[r, length:] = vocab_size - 1
        mask[r, :length] = 1
    return pixels, ids, mask


def golden_probe_inputs(cfg: CLIPConfig):
    """The probe inputs of a golden at ``cfg``: 2 images and 4 prompts, or
    1 and 2 for a model deeper than 12 layers (L/14)."""
    big = cfg.vision.layers > 12
    return probe_inputs(batch=1 if big else 2, n_prompts=2 if big else 4,
                        image_size=cfg.vision.image_size,
                        context=cfg.text.context_length,
                        vocab_size=cfg.text.vocab_size)


def hf_vit_key_shapes(cfg: SupervisedViTConfig) -> Dict[str, Tuple[int, ...]]:
    """Every key of ``ViTForImageClassification(cfg).state_dict()`` (no
    pooler, no mask token: the classification model's defaults) with its
    shape."""
    d, m, p = cfg.width, cfg.width * cfg.mlp_ratio, cfg.patch_size
    shapes: Dict[str, Tuple[int, ...]] = {
        "vit.embeddings.cls_token": (1, 1, d),
        "vit.embeddings.position_embeddings": (1, cfg.seq_len, d),
        "vit.embeddings.patch_embeddings.projection.weight": (d, 3, p, p),
        "vit.embeddings.patch_embeddings.projection.bias": (d,),
        "vit.layernorm.weight": (d,),
        "vit.layernorm.bias": (d,),
        "classifier.weight": (cfg.num_classes, d),
        "classifier.bias": (cfg.num_classes,),
    }
    for i in range(cfg.layers):
        pre = f"vit.encoder.layer.{i}"
        for name, shape in (("attention.attention.query", (d, d)),
                            ("attention.attention.key", (d, d)),
                            ("attention.attention.value", (d, d)),
                            ("attention.output.dense", (d, d)),
                            ("intermediate.dense", (m, d)),
                            ("output.dense", (d, m))):
            shapes[f"{pre}.{name}.weight"] = shape
            shapes[f"{pre}.{name}.bias"] = (shape[0],)
        for ln in ("layernorm_before", "layernorm_after"):
            shapes[f"{pre}.{ln}.weight"] = (d,)
            shapes[f"{pre}.{ln}.bias"] = (d,)
    return shapes


def synth_hf_vit_state_dict(cfg: SupervisedViTConfig,
                            seed: int = 0) -> Dict[str, np.ndarray]:
    """A full, shape-exact HF ViT classifier state dict with deterministic
    values (the CLIP dicts' value rule)."""
    return {k: _value_for(k, s, seed)
            for k, s in hf_vit_key_shapes(cfg).items()}


def write_hf_vit_snapshot(ckpt_dir: str, cfg: SupervisedViTConfig,
                          seed: int = 0) -> str:
    """Save :func:`synth_hf_vit_state_dict` as the HF snapshot
    ``<ckpt_dir>/vit-base-patch16-224/pytorch_model.bin`` that
    :func:`~mcm_tpu_torch.models.vit.resolve_vit_params` converts; returns
    the file's path."""
    import torch

    from mcm_tpu_torch.models.vit import VIT_SNAPSHOT
    snap = os.path.join(ckpt_dir, VIT_SNAPSHOT)
    os.makedirs(snap, exist_ok=True)
    path = os.path.join(snap, "pytorch_model.bin")
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in synth_hf_vit_state_dict(cfg, seed).items()}, path)
    return path
