"""CLIP byte-pair-encoding tokenizer — pure Python, fully offline.

The reference calls HF ``CLIPTokenizer.from_pretrained`` inside the scoring
hot loop (``utils/detection_util.py:216,228``).  Here
tokenization is a host-side, once-per-dataset step.  The implementation is
the standard byte-level BPE used by GPT-2/CLIP:

* the HF pre-tokenizer pass (HF runs a ``BasicTokenizer`` when ftfy is
  absent — the reference's realized environment): control-char removal,
  spaces inserted around CJK codepoints, NFC normalization, whitespace
  cleanup, lowercasing.  In-domain prompts are pure English so scores
  never depended on the CJK/control handling, but id-for-id HF parity
  holds out-of-domain too (fuzz-tested against CLIPTokenizer);
* the CLIP split regex (``'s|'t|'re|...|letters|digit|other``);
* byte→printable-unicode remapping so merges operate on visible chars;
* greedy lowest-rank pair merging with the ``</w>`` end-of-word marker;
* ``<|startoftext|> tokens <|endoftext|>`` framing, right-padding with the
  EOT token and a 0/1 attention mask (HF ``padding=True`` semantics).

Vocabulary and merges load from the same ``vocab.json`` / ``merges.txt``
files that ship with any ``openai/clip-vit-*`` checkpoint; nothing is
fetched at runtime.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import regex as re

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)
_WHITESPACE = re.compile(r"\s+")

# BasicTokenizer's CJK blocks: each such codepoint becomes its own word
_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
               (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
               (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _pre_clean(text: str) -> str:
    """HF ``BasicTokenizer``-equivalent pre-pass (the path HF's
    CLIPTokenizer takes when ftfy is not installed, as in the reference's
    environment): drop NUL/replacement/control chars, map all whitespace
    to plain spaces, and space-separate CJK codepoints."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        if ch not in "\t\n\r" and unicodedata.category(ch).startswith("C"):
            continue  # control/format chars (Cc/Cf/...)
        if any(lo <= cp <= hi for lo, hi in _CJK_RANGES):
            out.append(f" {ch} ")
        elif ch in "\t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        else:
            out.append(ch)
    return unicodedata.normalize("NFC", "".join(out))

BOS_TOKEN = "<|startoftext|>"
EOS_TOKEN = "<|endoftext|>"


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte→unicode table: every byte maps to a printable char."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def pad_token_rows(rows: List[List[int]], pad_id: int,
                   pad_to_multiple: Optional[int] = None,
                   context_length: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad variable-length id rows → (ids [B, S], mask [B, S]) int32.

    Width = longest row, rounded up to ``pad_to_multiple`` (accelerator-friendly
    static shapes), clamped to ``context_length``.  Rows are assumed already
    truncated to the context window."""
    width = max(len(r) for r in rows)
    if pad_to_multiple:
        width = -(-width // pad_to_multiple) * pad_to_multiple
    if context_length is not None:
        width = min(width, context_length)
    ids = np.full((len(rows), width), pad_id, dtype=np.int32)
    mask = np.zeros((len(rows), width), dtype=np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return ids, mask


class CLIPTokenizer:
    """Drop-in offline CLIP tokenizer.

    Parameters
    ----------
    vocab_file / merges_file:
        paths to an HF-format ``vocab.json`` and ``merges.txt``.
    """

    def __init__(self, vocab_file: str, merges_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}

        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # skip the "#version" header; ignore trailing blanks
        merges = [tuple(line.split()) for line in lines
                  if line and not line.startswith("#version")]
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_id = self.encoder[BOS_TOKEN]
        self.eos_id = self.encoder[EOS_TOKEN]
        self.pad_id = self.eos_id  # HF CLIPTokenizer pads with EOT
        self._bpe_cache: Dict[str, List[str]] = {}

    # -- resolution helpers -------------------------------------------------

    @classmethod
    def from_dir(cls, path: str) -> "CLIPTokenizer":
        return cls(os.path.join(path, "vocab.json"),
                   os.path.join(path, "merges.txt"))

    @classmethod
    def resolve(cls, ckpt_dir: Optional[str] = None) -> Optional["CLIPTokenizer"]:
        """Look for vocab/merges under MCM_TPU_CKPT_DIR or the HF cache."""
        d = cls.resolve_dir(ckpt_dir)
        return cls.from_dir(d) if d else None

    @classmethod
    def resolve_dir(cls, ckpt_dir: Optional[str] = None) -> Optional[str]:
        """The directory :meth:`resolve` would load vocab/merges from, or
        None.  Exposed separately so the ``--resume`` cache fingerprint can
        record the tokenizer files' content identity: swapping vocab.json /
        merges.txt changes every text feature and score while every flag
        stays equal."""
        search = []
        ckpt_dir = ckpt_dir or os.environ.get("MCM_TPU_CKPT_DIR",
                                              "checkpoints")
        search.append(ckpt_dir)
        for repo in ("clip-vit-base-patch16", "clip-vit-base-patch32",
                     "clip-vit-large-patch14"):
            search.append(os.path.join(ckpt_dir, repo))
        cache = os.environ.get("HF_HOME",
                               os.path.expanduser("~/.cache/huggingface"))
        hub = os.path.join(cache, "hub")
        if os.path.isdir(hub):
            for d in os.listdir(hub):
                if d.startswith("models--openai--clip"):
                    snaps = os.path.join(hub, d, "snapshots")
                    if os.path.isdir(snaps):
                        search += [os.path.join(snaps, s)
                                   for s in os.listdir(snaps)]
        for d in search:
            if (os.path.exists(os.path.join(d, "vocab.json"))
                    and os.path.exists(os.path.join(d, "merges.txt"))):
                return d
        return None

    # -- core BPE ------------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            out = [token + "</w>"]
            self._bpe_cache[token] = out
            return out

        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._bpe_cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids WITHOUT bos/eos framing.  Literal special tokens in the
        text map to their special ids (the split regex matches them whole)."""
        text = _WHITESPACE.sub(" ", _pre_clean(text)).strip().lower()
        ids: List[int] = []
        for tok in _PAT.findall(text):
            if tok == BOS_TOKEN:
                ids.append(self.bos_id)
                continue
            if tok == EOS_TOKEN:
                ids.append(self.eos_id)
                continue
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids
                       if i not in (self.bos_id, self.eos_id))
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    # -- batch API (what the scoring path consumes) ---------------------------

    def __call__(self, texts: Sequence[str], context_length: Optional[int] = None,
                 pad_to_multiple: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch encode → (input_ids [B, S] int32, attention_mask [B, S] int32).

        ``padding=True`` semantics (pad to the longest row) like the
        reference call at ``detection_util.py:228``; optionally pad S up to a
        multiple (accelerator-friendly static shapes) or clamp/pad to
        ``context_length``.
        """
        rows = [[self.bos_id] + self.encode(t) + [self.eos_id] for t in texts]
        if context_length is not None:
            # truncate but keep EOS last (HF behavior) — the text tower
            # pools at argmax(ids), which must find the EOT token
            rows = [r if len(r) <= context_length
                    else r[:context_length - 1] + [self.eos_id]
                    for r in rows]
        return pad_token_rows(rows, self.pad_id, pad_to_multiple,
                              context_length)
