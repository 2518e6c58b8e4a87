"""Model and evaluation configuration.

The same CLI names as the JAX package (``ViT-B/16 | ViT-B/32 | ViT-L/14``)
map to the same static architecture configs; ``Precision`` holds torch
dtypes.  Every entry point takes an explicit ``device`` (default
``"cuda"``); :func:`resolve_device` refuses to run without a card unless
the caller asked for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP vision tower (ViT) architecture."""

    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS token

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """CLIP text tower (causal transformer) architecture."""

    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    mlp_ratio: int = 4
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    vision: VisionConfig
    text: TextConfig

    @property
    def embed_dim(self) -> int:
        return self.vision.projection_dim


def clip_vit_b32() -> CLIPConfig:
    return CLIPConfig(
        name="ViT-B/32",
        vision=VisionConfig(patch_size=32, width=768, layers=12, heads=12,
                            projection_dim=512),
        text=TextConfig(width=512, layers=12, heads=8, projection_dim=512),
    )


def clip_vit_b16() -> CLIPConfig:
    if os.environ.get("MCM_TPU_TEST_TINY_B16"):
        # test double for CLI-subprocess tests: structurally identical —
        # 224²/16 patches (197-token sequences), full vocab, pre-LN, EOT
        # pooling — but 2 layers/128 wide so a CPU forward is instant.
        # NEVER set outside tests: scores are architecture-meaningless.
        warnings.warn("MCM_TPU_TEST_TINY_B16 active: ViT-B/16 resolves to "
                      "a 2-layer/128-wide test double")
        return CLIPConfig(
            name="ViT-B/16",
            vision=VisionConfig(patch_size=16, width=128, layers=2, heads=4,
                                projection_dim=64),
            text=TextConfig(width=128, layers=2, heads=4, projection_dim=64),
        )
    return CLIPConfig(
        name="ViT-B/16",
        vision=VisionConfig(patch_size=16, width=768, layers=12, heads=12,
                            projection_dim=512),
        text=TextConfig(width=512, layers=12, heads=8, projection_dim=512),
    )


def clip_vit_l14() -> CLIPConfig:
    return CLIPConfig(
        name="ViT-L/14",
        vision=VisionConfig(patch_size=14, width=1024, layers=24, heads=16,
                            projection_dim=768),
        text=TextConfig(width=768, layers=12, heads=12, projection_dim=768),
    )


#: CLI checkpoint-name → architecture (the ``--CLIP_ckpt`` surface).
CLIP_CONFIGS = {
    "ViT-B/32": clip_vit_b32,
    "ViT-B/16": clip_vit_b16,
    "ViT-L/14": clip_vit_l14,
}

#: Feature dim per checkpoint (replaces the reference's manual --feat_dim).
CLIP_FEAT_DIMS = {"ViT-B/32": 512, "ViT-B/16": 512, "ViT-L/14": 768}

#: HF hub ids of the checkpoints, for finding a snapshot to convert
#: (reference ``train_eval_util.py:19-21``).
HF_CKPT_MAPPING = {
    "ViT-B/16": "openai/clip-vit-base-patch16",
    "ViT-B/32": "openai/clip-vit-base-patch32",
    "ViT-L/14": "openai/clip-vit-large-patch14",
}


@dataclasses.dataclass(frozen=True)
class Precision:
    """Numerical policy for the compute path.

    ``parity`` — fp32 activations and true-fp32 matrix products: TF32 is
                 switched off for both cuBLAS and cuDNN
                 (:func:`apply_matmul_policy`).
    ``fast``   — bf16 activations with fp32 accumulation, and a bf16
                 attention-probability tensor off the kernel path.
    """

    activation_dtype: torch.dtype = torch.bfloat16
    #: "highest" = true fp32 products (parity); "default" = whatever the
    #: activation dtype implies.
    matmul_precision: str = "default"
    #: attention implementation for unmasked (vision) attention: "auto" —
    #: the bsd kernel on a CUDA tensor in bf16, the math path elsewhere —
    #: or force "xla" (the math path) / "pallas_bsd" (the bsd kernel) /
    #: "pallas" | "pallas_mh" | "pallas_batched" (the split-heads kernel
    #: in one of its three launch shapes) / "flash" (the flash kernel).
    #: "pallas_bsd_vjp" is the trainable route: the "auto" forward and the
    #: math path's gradient; any other name takes the math path, as in the
    #: JAX package.  Masked (text-tower) calls take the math path.
    attn_impl: str = "auto"
    #: MLP implementation: "pallas" — the fused MLP kernel, in both towers;
    #: anything else ("auto", "xla") — plain matmuls.
    mlp_impl: str = "auto"
    #: dtype of the math path's [B, H, S, S] logits/probability tensor.
    softmax_dtype: torch.dtype = torch.float32
    # LayerNorm always runs in fp32 regardless of activation dtype.

    @staticmethod
    def parity() -> "Precision":
        return Precision(activation_dtype=torch.float32,
                         matmul_precision="highest",
                         softmax_dtype=torch.float32)

    @staticmethod
    def fast() -> "Precision":
        return Precision(activation_dtype=torch.bfloat16,
                         softmax_dtype=torch.bfloat16)


def resolve_precision(name: str) -> Precision:
    if name in ("parity", "float32", "fp32", "highest"):
        return Precision.parity()
    if name in ("fast", "bfloat16", "bf16", "default"):
        return Precision.fast()
    raise ValueError(f"unknown precision policy: {name!r}")


def apply_matmul_policy(precision: Precision) -> None:
    """Parity mode turns TF32 off for cuBLAS products and cuDNN
    convolutions (TF32 keeps ~3 decimal digits, far outside the fp32
    parity tolerance).  Fast mode leaves the flags alone: its products
    are bf16 with fp32 accumulation either way."""
    if precision.matmul_precision == "highest":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  A CUDA device without a card
    raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class SupervisedViTConfig:
    """Supervised ViT classifier (MSP baseline; the reference README's
    google/vit-base-patch16-224 comparison path, ``detection_util.py:124-126``).

    Construct via :func:`supervised_vit_config` on CLI paths — it applies
    the ``MCM_TPU_TEST_TINY_VIT=1`` test-double override."""

    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    num_classes: int = 1000
    layer_norm_eps: float = 1e-12

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


def supervised_vit_config() -> SupervisedViTConfig:
    """The CLI's ViT-base config, honoring the test-double override: with
    ``MCM_TPU_TEST_TINY_VIT`` set (CLI-subprocess tests only) it is
    2 layers, width 128, 4 heads, at the same 224²/16 patch grid."""
    if os.environ.get("MCM_TPU_TEST_TINY_VIT"):
        warnings.warn("MCM_TPU_TEST_TINY_VIT active: the supervised ViT "
                      "resolves to a 2-layer/128-wide test double")
        return SupervisedViTConfig(width=128, layers=2, heads=4)
    return SupervisedViTConfig()
