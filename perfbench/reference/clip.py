"""CLIP's two towers and the MCM score in plain PyTorch, float32.

Follows OpenAI CLIP (Radford et al., 2021, and the published
``openai/clip-vit-*`` checkpoints): the image tower is a ViT with a patch
embedding (no bias), a class token, learned positions, a LayerNorm before
the blocks, pre-LN blocks with MLPs, LayerNorm on the class token and a
projection; the text tower adds token and position embeddings, runs
causal pre-LN blocks, a final LayerNorm, pools at the end-of-text token
(the largest id) and projects.  The MCM score (Ming et al., 2022) of an
image is minus the largest softmax over its cosine similarities to the
class prompts, divided by T.

The MLP's activation is each tower's ``hidden_act``, as HF's ``ACT2FN``
names it: ``quick_gelu`` (``h * sigmoid(1.702 h)``, OpenAI CLIP's) and
``gelu`` (the exact erf GELU, OpenCLIP's larger towers').  Any other name
raises.

The weights are the ``.npz`` tree's arrays: matrices ``[in, out]``, layers
stacked on a leading axis, the patch embedding's rows in (row, column,
channel) order of a patch.  ``gemm="fp8"`` rounds both operands of every
dense product to float8 e4m3 with a per-tensor scale before a float32
product: the control, the reference one precision step below the
program's bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
GEMMS = ("fp32", "fp8")
ACTIVATIONS = ("quick_gelu", "gelu")


def float32_only() -> None:
    """True float32 products: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_device(tree: Dict, device) -> Dict:
    return {k: to_device(v, device) if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in tree.items()}


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def dense(x, w, b, gemm: str):
    if gemm == "fp8":
        x, w = _fp8(x), _fp8(w)
    y = x @ w
    return y if b is None else y + b


def _ln(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def activation(h: torch.Tensor, name: str) -> torch.Tensor:
    if name == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if name == "gelu":
        return F.gelu(h)
    raise ValueError(f"hidden_act {name!r}: the reference implements "
                     f"{', '.join(ACTIVATIONS)}")


def _block(x, p, i: int, d: dict, mask, gemm: str):
    a, m = p["attn"], p["mlp"]
    heads, eps = d["heads"], d["eps"]
    h = _ln(x, {"scale": p["ln1"]["scale"][i], "bias": p["ln1"]["bias"][i]},
            eps)
    b, s, w = h.shape
    dh = w // heads

    def split(t):
        return t.reshape(b, s, heads, dh).transpose(1, 2)

    q = split(dense(h, a["wq"][i], a["bq"][i], gemm))
    k = split(dense(h, a["wk"][i], a["bk"][i], gemm))
    v = split(dense(h, a["wv"][i], a["bv"][i], gemm))
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    if mask is not None:
        logits = logits + mask
    o = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(b, s, w)
    x = x + dense(o, a["wo"][i], a["bo"][i], gemm)
    h = _ln(x, {"scale": p["ln2"]["scale"][i], "bias": p["ln2"]["bias"][i]},
            eps)
    h = dense(h, m["w1"][i], m["b1"][i], gemm)
    h = activation(h, d["hidden_act"])
    return x + dense(h, m["w2"][i], m["b2"][i], gemm)


def encode_image(tree: Dict, dims: dict, pixels_u8: torch.Tensor,
                 gemm: str = "fp32") -> torch.Tensor:
    """uint8 [B, H, W, 3] → image features [B, E] (not normalized)."""
    v, d = tree["vision"], dims["vision"]
    mean = torch.tensor(CLIP_MEAN, device=pixels_u8.device)
    std = torch.tensor(CLIP_STD, device=pixels_u8.device)
    x = (pixels_u8.float() / 255.0 - mean) / std
    b, hh, ww, c = x.shape
    p = d["patch_size"]
    x = x.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
    x = dense(x.reshape(b, (hh // p) * (ww // p), p * p * c),
              v["patch_embed"], None, gemm)
    x = torch.cat([v["class_emb"].expand(b, 1, -1), x], dim=1) + v["pos_emb"]
    x = _ln(x, v["pre_ln"], d["eps"])
    for i in range(d["layers"]):
        x = _block(x, v["layers"], i, d, None, gemm)
    return dense(_ln(x[:, 0], v["post_ln"], d["eps"]), v["proj"], None, gemm)


def encode_text(tree: Dict, dims: dict, ids: torch.Tensor,
                attention_mask: torch.Tensor,
                gemm: str = "fp32") -> torch.Tensor:
    """int ids [N, S] and their 0/1 mask → text features [N, E] (not
    normalized)."""
    t, d = tree["text"], dims["text"]
    n, s = ids.shape
    ids = ids.long()
    x = t["token_emb"][ids] + t["pos_emb"][:s]
    neg = torch.finfo(torch.float32).min / 2
    causal = torch.triu(torch.full((s, s), neg, device=x.device), 1)
    pad = (1.0 - attention_mask.float()) * neg
    mask = causal[None, None] + pad[:, None, None, :]
    for i in range(d["layers"]):
        x = _block(x, t["layers"], i, d, mask, gemm)
    x = _ln(x, t["final_ln"], d["eps"])
    pooled = x[torch.arange(n, device=x.device), ids.argmax(dim=-1)]
    return dense(pooled, t["proj"], None, gemm)


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


def mcm_scores(image_feats: torch.Tensor, text_feats_n: torch.Tensor,
               T: float = 1.0) -> torch.Tensor:
    """[B] MCM scores, lower = more in-distribution."""
    logits = normalize(image_feats) @ text_feats_n.T
    return -torch.softmax(logits / T, dim=-1).amax(dim=-1)


@torch.no_grad()
def pool_scores(tree_host: Dict, dims: dict, pixels_u8: np.ndarray,
                ids: np.ndarray, mask: np.ndarray, T: float, device,
                gemm: str = "fp32", block: int = 128) -> np.ndarray:
    """MCM scores of ``pixels_u8`` [N, H, W, 3] against the prompts'
    ``ids`` / ``mask``, in blocks of ``block`` images."""
    if gemm not in GEMMS:
        raise ValueError(f"gemm must be one of {GEMMS}, got {gemm!r}")
    float32_only()
    tree = to_device(tree_host, device)
    text = normalize(encode_text(tree, dims, torch.as_tensor(ids, device=device),
                                 torch.as_tensor(mask, device=device), gemm))
    out = []
    for lo in range(0, len(pixels_u8), block):
        px = torch.as_tensor(pixels_u8[lo:lo + block], device=device)
        out.append(mcm_scores(encode_image(tree, dims, px, gemm), text,
                              T).cpu().numpy())
    del tree, text
    return np.concatenate(out).astype(np.float64)


def score_of_paths(tree_host: Dict, dims: dict, paths: Sequence[str],
                   ids: np.ndarray, mask: np.ndarray, T: float, device,
                   gemm: str = "fp32") -> np.ndarray:
    from perfbench.reference.pixels import load_many
    return pool_scores(tree_host, dims,
                       load_many(paths, dims["vision"]["image_size"]),
                       ids, mask, T, device, gemm)
