"""Caption-experiment utilities (capability parity).

The reference carries two vestigial caption-scoring helpers: a caption TSV
loader (``utils/file_ops.py:54-64``, ``prepare_dataframe``) and a text
Dataset wrapper for batched caption encoding
(``utils/detection_util.py:267-283``, ``TextDataset``).  They are dead in
its eval path but part of its public surface; equivalents live here so a
migrating user finds them.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple


def prepare_dataframe(captions_dir: str = "gen_captions",
                      dataset_name: str = "imagenet_val",
                      multiple: bool = False):
    """Load a generated-captions TSV into a DataFrame with columns
    (image_id, caption, cls).  ``multiple=True`` reproduces the
    reference's branch verbatim (``file_ops.py:54-64``) — which is a
    no-op (isin over the full id set keeps every row); preserved for
    behavioral parity, not because it deduplicates anything."""
    import pandas as pd

    path = os.path.join(captions_dir, f"{dataset_name}_captions.tsv")
    df = pd.read_csv(path, sep="\t")
    df.columns = ["image_id", "caption", "cls"]
    if multiple:
        keep = list(set(df["image_id"].values))
        df = df[df["image_id"].isin(keep)].reset_index(drop=True)
    return df


class TextDataset:
    """Pairs of (caption, label) with list semantics — the batched caption
    container (reference ``detection_util.py:267-283``).  Feed slices to
    ``CLIPTokenizer`` + ``EvalStep.encode_text`` for caption scoring."""

    def __init__(self, texts: Sequence[str], labels: Sequence[int]):
        if len(texts) != len(labels):
            raise ValueError(f"{len(texts)} texts but {len(labels)} labels")
        self.texts = list(texts)
        self.labels = list(labels)

    def __len__(self) -> int:
        return len(self.texts)

    def __getitem__(self, index: int) -> Tuple[str, int]:
        return self.texts[index], self.labels[index]

    def batches(self, batch_size: int) -> List[Tuple[List[str], List[int]]]:
        out = []
        for lo in range(0, len(self.texts), batch_size):
            out.append((self.texts[lo:lo + batch_size],
                        self.labels[lo:lo + batch_size]))
        return out
