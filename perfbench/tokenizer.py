"""The prompts of a run and their token ids, handed to the program and to
the reference alike.

A frozen copy, taken at commit b04a33a3cbafb71359a53ebe2f5b87902b3e3f1b, of
``mcm_tpu_torch/runner.py::_HashTokenizer`` and
``mcm_tpu_torch/text/tokenizer.py::pad_token_rows``: no CLIP vocabulary is
in the repository, so each word hashes into the id space (BOS and EOS are
the two largest ids, EOS pads).  The classes are ImageNet-1k's 1000, a copy
of ``mcm_tpu_torch/data/assets/imagenet1k_names.txt`` from that commit, and
the template is the evaluator's single prompt
(``mcm_tpu_torch/text/prompts.py::DEFAULT_TEMPLATE``).
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Sequence, Tuple

import numpy as np

TEMPLATE = "a photo of a {}"
_NAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "imagenet1k_names.txt")


def class_names() -> List[str]:
    with open(_NAMES, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def prompts(names: Sequence[str]) -> List[str]:
    return [TEMPLATE.format(c) for c in names]


def tokenize(texts: Sequence[str], vocab_size: int, context_length: int,
             pad_to_multiple: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """``(ids [N, S], mask [N, S])`` int32, S the longest row rounded up to
    ``pad_to_multiple`` and clamped to ``context_length``."""
    bos, eos = vocab_size - 2, vocab_size - 1
    rows = []
    for t in texts:
        ids = [bos]
        for w in t.lower().split():
            h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
            ids.append(h % (vocab_size - 2))
        ids.append(eos)
        if len(ids) > context_length:
            ids = ids[:context_length - 1] + [eos]
        rows.append(ids)
    width = max(len(r) for r in rows)
    width = -(-width // pad_to_multiple) * pad_to_multiple
    width = min(width, context_length)
    out = np.full((len(rows), width), eos, dtype=np.int32)
    mask = np.zeros((len(rows), width), dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return out, mask
