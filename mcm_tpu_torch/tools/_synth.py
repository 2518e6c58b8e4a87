"""Synthetic JPEG trees and a CLIP BPE vocab for the port's tools.

Copies of ``tests/util_synth.py``'s ``make_imagefolder_tree`` and
``make_clip_vocab`` (an installed package cannot reach ``tests/``): the
same JPEG bytes for the same seed, the same vocab files.  ``scale_soak``
builds its ImageNet-layout tree with them; ``parity_check``'s tests lay out
an HF snapshot's tokenizer files.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
from PIL import Image


def _write_jpeg(path: str, rng: np.random.Generator, size=(40, 32),
                color_bias: int = 0) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = rng.integers(0, 200, size=(size[1], size[0], 3), dtype=np.uint8)
    arr = np.clip(arr.astype(np.int32) + color_bias, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path, quality=90)


def make_imagefolder_tree(root: str, classes: Sequence[str], per_class: int = 3,
                          seed: int = 0, color_bias: int = 0) -> str:
    """``per_class`` 40x32 JPEGs under ``root/<class>/img_NNN.jpg`` for each
    class, from one generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    for cls in classes:
        for i in range(per_class):
            _write_jpeg(os.path.join(root, cls, f"img_{i:03d}.jpg"), rng,
                        color_bias=color_bias)
    return root


def make_clip_vocab(out_dir: str, vocab_size: int = 49408) -> str:
    """A structurally real CLIP BPE vocab (HF ``vocab.json`` +
    ``merges.txt``): the byte alphabet, its ``</w>`` variants, a few real
    merges, filler up to ``vocab_size - 2``, and ``<|startoftext|>`` /
    ``<|endoftext|>`` as the two largest ids.  HF's ``CLIPTokenizer`` and
    the port's both load it offline."""
    from mcm_tpu_torch.text.tokenizer import (BOS_TOKEN, EOS_TOKEN,
                                              bytes_to_unicode)

    os.makedirs(out_dir, exist_ok=True)
    alphabet = list(bytes_to_unicode().values())
    tokens = alphabet + [c + "</w>" for c in alphabet]
    merges = [
        ("c", "a"), ("ca", "t</w>"), ("p", "h"), ("ph", "o"),
        ("pho", "t"), ("phot", "o</w>"), ("o", "f</w>"), ("a", "t</w>"),
        ("t", "h"), ("th", "e</w>"), ("i", "n"), ("e", "r"),
    ]
    tokens += ["".join(m) for m in merges]
    # unreachable filler (BPE emits only byte-derived tokens) pads the id
    # space to the text tower's embedding size
    tokens += [f"<fill{i}>" for i in range(vocab_size - 2 - len(tokens))]
    tokens += [BOS_TOKEN, EOS_TOKEN]
    if len(tokens) != vocab_size:
        raise ValueError(f"vocab_size {vocab_size} is below the "
                         f"{len(tokens)} tokens a CLIP vocab needs")
    vocab = {t: i for i, t in enumerate(tokens)}
    with open(os.path.join(out_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(out_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" +
                "\n".join(" ".join(m) for m in merges) + "\n")
    return out_dir
