"""Random parameter initialization (host-side numpy).

Used for tests and smoke runs when no pretrained checkpoint is on disk.
The generator calls and their order are those of the JAX package's
``init_clip``, so one int seed gives bit-identical weights in both
packages.  The result is the framework-free parameter tree (nested dicts,
weights ``[in, out]``, layers stacked on a leading axis); hand it to
:func:`mcm_tpu_torch.models.convert.from_jax_params` to get a model.
"""

from __future__ import annotations

import numpy as np

from mcm_tpu_torch.config import CLIPConfig, TextConfig, VisionConfig


def _seed_of(key) -> np.random.SeedSequence:
    if isinstance(key, np.random.SeedSequence):
        return key
    if isinstance(key, (int, np.integer)):
        return np.random.SeedSequence(int(key))
    raise TypeError(f"seed must be an int or a numpy SeedSequence, "
                    f"got {type(key).__name__}")


def _rng_for(key) -> np.random.Generator:
    return np.random.default_rng(_seed_of(key))


def _ln(dim: int):
    return {"scale": np.ones((dim,), np.float32),
            "bias": np.zeros((dim,), np.float32)}


def _ln_stack(layers: int, dim: int):
    return {"scale": np.ones((layers, dim), np.float32),
            "bias": np.zeros((layers, dim), np.float32)}


def _stacked_layers(rng: np.random.Generator, layers: int, width: int,
                    mlp_ratio: int) -> dict:
    hidden = width * mlp_ratio
    std = width ** -0.5

    def norm(shape, s):
        return (rng.standard_normal(shape, dtype=np.float32) * s)

    return {
        "ln1": _ln_stack(layers, width),
        "attn": {
            "wq": norm((layers, width, width), std),
            "wk": norm((layers, width, width), std),
            "wv": norm((layers, width, width), std),
            "wo": norm((layers, width, width), std),
            "bq": np.zeros((layers, width), np.float32),
            "bk": np.zeros((layers, width), np.float32),
            "bv": np.zeros((layers, width), np.float32),
            "bo": np.zeros((layers, width), np.float32),
        },
        "ln2": _ln_stack(layers, width),
        "mlp": {
            "w1": norm((layers, width, hidden), std),
            "b1": np.zeros((layers, hidden), np.float32),
            "w2": norm((layers, hidden, width), hidden ** -0.5),
            "b2": np.zeros((layers, width), np.float32),
        },
    }


def init_vision(key, cfg: VisionConfig) -> dict:
    rng = _rng_for(key)
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    return {
        "patch_embed": rng.standard_normal(
            (patch_dim, cfg.width), dtype=np.float32) * cfg.width ** -0.5,
        "class_emb": rng.standard_normal(
            (cfg.width,), dtype=np.float32) * cfg.width ** -0.5,
        "pos_emb": rng.standard_normal(
            (cfg.seq_len, cfg.width), dtype=np.float32) * 0.01,
        "pre_ln": _ln(cfg.width),
        "layers": _stacked_layers(rng, cfg.layers, cfg.width, cfg.mlp_ratio),
        "post_ln": _ln(cfg.width),
        "proj": rng.standard_normal(
            (cfg.width, cfg.projection_dim),
            dtype=np.float32) * cfg.width ** -0.5,
    }


def init_text(key, cfg: TextConfig) -> dict:
    rng = _rng_for(key)
    return {
        "token_emb": rng.standard_normal(
            (cfg.vocab_size, cfg.width), dtype=np.float32) * 0.02,
        "pos_emb": rng.standard_normal(
            (cfg.context_length, cfg.width), dtype=np.float32) * 0.01,
        "layers": _stacked_layers(rng, cfg.layers, cfg.width, cfg.mlp_ratio),
        "final_ln": _ln(cfg.width),
        "proj": rng.standard_normal(
            (cfg.width, cfg.projection_dim),
            dtype=np.float32) * cfg.width ** -0.5,
    }


def init_clip(key, cfg: CLIPConfig) -> dict:
    kv, kt = _seed_of(key).spawn(2)
    return {
        "vision": init_vision(kv, cfg.vision),
        "text": init_text(kt, cfg.text),
        "logit_scale": np.float32(4.6052),  # ln(100)
    }
