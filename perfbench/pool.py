"""The JPEG pool of a run: distinct files with natural image statistics,
made from the seed in a fresh directory under ``TMPDIR``.

A traffic mix's ``pool`` entry gives the count, the shapes (``[width,
height, share]``), the JPEG quality range and the grayscale share.  Every
seed gets the same files' shapes, qualities and colour modes, in another
order, so seeds change the pixels and not the work.  Each image is
a smooth random base (a low-resolution field upsampled bicubically, with
its own colour cast and contrast) plus pixel noise, the pattern of the
program's earlier bench trees.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np

#: stream of the pool in the run's seed sequence (the weights use another)
POOL_STREAM = 1


def _fixed_counts(shares: Sequence[float], n: int) -> List[int]:
    """``n`` split by ``shares`` into whole counts that sum to ``n``
    (largest remainders first)."""
    shares = np.asarray(shares, np.float64) / float(np.sum(shares))
    raw = shares * n
    counts = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - counts), kind="stable")[:n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def pool_plan(mix: dict, seed: int) -> List[dict]:
    """One dict per file: ``w``, ``h``, ``quality``, ``gray``, and the
    ``seed`` of its pixels."""
    n = int(mix["count"])
    shapes = mix["shapes"]
    ss = np.random.SeedSequence([int(seed), POOL_STREAM])
    order_ss, pixel_ss = ss.spawn(2)
    rng = np.random.default_rng(order_ss)
    sizes = []
    for (w, h, _), c in zip(shapes, _fixed_counts([s[2] for s in shapes], n)):
        sizes += [(int(w), int(h))] * c
    # the joint set of (shape, quality, grayscale) is the same for every
    # seed: a fixed spread of qualities and grayscale files over the shapes
    fixed = np.random.default_rng(0)
    lo, hi = mix["quality"]
    qualities = np.round(np.linspace(lo, hi, n)).astype(int)[fixed.permutation(n)]
    gray = np.zeros(n, bool)
    gray[fixed.permutation(n)[:int(round(float(mix["gray_share"]) * n))]] = True
    order = rng.permutation(n)
    sizes = [sizes[i] for i in order]
    qualities, gray = qualities[order], gray[order]
    pixel_seeds = pixel_ss.generate_state(n, np.uint64)
    return [{"w": w, "h": h, "quality": int(q), "gray": bool(g),
             "seed": int(s)}
            for (w, h), q, g, s in zip(sizes, qualities, gray, pixel_seeds)]


def render(item: dict, noise: int) -> "PIL.Image.Image":  # noqa: F821
    from PIL import Image
    rng = np.random.default_rng(item["seed"])
    w, h = item["w"], item["h"]
    base = rng.integers(0, 256, size=(max(4, h // 16), max(4, w // 16), 3))
    cast = rng.uniform(40.0, 215.0, size=3)
    contrast = rng.uniform(0.3, 1.0)
    base = np.clip(cast + contrast * (base - 128.0), 0, 255).astype(np.uint8)
    img = np.asarray(Image.fromarray(base).resize((w, h), Image.BICUBIC),
                     dtype=np.int16)
    img = img + rng.integers(-noise, noise + 1, size=img.shape,
                             dtype=np.int16)
    out = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    return out.convert("L") if item["gray"] else out


def make_pool(mix: dict, seed: int, directory: str,
              threads: int = 8) -> List[str]:
    """Write the pool's files into ``directory``; return their paths in
    pool order."""
    plan = pool_plan(mix, seed)
    noise = int(mix["noise"])

    def write(i: int) -> str:
        path = os.path.join(directory, f"{i:05d}.jpg")
        render(plan[i], noise).save(path, quality=plan[i]["quality"])
        return path

    with ThreadPoolExecutor(max(1, min(threads, os.cpu_count() or 1))) as ex:
        return list(ex.map(write, range(len(plan))))
