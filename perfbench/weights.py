"""Random CLIP weights from the seed, made on the device in one call.

The tree is the program's parameter layout (the JAX package's ``.npz``
tree: weights ``[in, out]``, per-layer leaves stacked on a leading axis).
Every number comes from one ``torch.randn`` on the device with a
``torch.Generator`` seeded from the run's seed, and the tree reaches the
host in one copy.  Matrices and embeddings are drawn N(0, std) and rounded
to the type they are served in (bfloat16 for ``torch_dtype`` bfloat16);
LayerNorm scales are 1 + N(0, 0.1) and biases N(0, 0.02), in float32.  The
program and the reference get the same arrays.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

#: stream of the weights in the run's seed sequence (the pool uses another)
WEIGHT_STREAM = 2


def _layers(prefix: str, n: int, width: int, hidden: int) -> List[tuple]:
    return [
        (f"{prefix}/ln1/scale", (n, width), "scale", 0.1),
        (f"{prefix}/ln1/bias", (n, width), "bias", 0.02),
        *[(f"{prefix}/attn/w{x}", (n, width, width), "matrix", width ** -0.5)
          for x in "qkvo"],
        *[(f"{prefix}/attn/b{x}", (n, width), "bias", 0.02) for x in "qkvo"],
        (f"{prefix}/ln2/scale", (n, width), "scale", 0.1),
        (f"{prefix}/ln2/bias", (n, width), "bias", 0.02),
        (f"{prefix}/mlp/w1", (n, width, hidden), "matrix", width ** -0.5),
        (f"{prefix}/mlp/b1", (n, hidden), "bias", 0.02),
        (f"{prefix}/mlp/w2", (n, hidden, width), "matrix", hidden ** -0.5),
        (f"{prefix}/mlp/b2", (n, width), "bias", 0.02),
    ]


def leaves(dims: dict) -> List[Tuple[str, tuple, str, float]]:
    """(path, shape, kind, std) of every leaf, in generation order."""
    v, t, e = dims["vision"], dims["text"], dims["embed_dim"]
    w, p = v["width"], v["patch_size"]
    seq = (v["image_size"] // p) ** 2 + 1
    tw = t["width"]
    return [
        ("vision/patch_embed", (p * p * 3, w), "matrix", (p * p * 3) ** -0.5),
        ("vision/class_emb", (w,), "matrix", w ** -0.5),
        ("vision/pos_emb", (seq, w), "matrix", 0.01),
        ("vision/pre_ln/scale", (w,), "scale", 0.1),
        ("vision/pre_ln/bias", (w,), "bias", 0.02),
        *_layers("vision/layers", v["layers"], w, v["mlp"]),
        ("vision/post_ln/scale", (w,), "scale", 0.1),
        ("vision/post_ln/bias", (w,), "bias", 0.02),
        ("vision/proj", (w, e), "matrix", w ** -0.5),
        ("text/token_emb", (t["vocab_size"], tw), "matrix", 0.02),
        ("text/pos_emb", (t["context_length"], tw), "matrix", 0.01),
        *_layers("text/layers", t["layers"], tw, t["mlp"]),
        ("text/final_ln/scale", (tw,), "scale", 0.1),
        ("text/final_ln/bias", (tw,), "bias", 0.02),
        ("text/proj", (tw, e), "matrix", tw ** -0.5),
    ]


def make_weights(dims: dict, seed: int, device) -> Dict:
    """The host parameter tree (float32 numpy, nested dicts) for ``dims``
    (:func:`perfbench.modelcfg.dims`)."""
    import torch

    spec = leaves(dims)
    sizes = [int(np.prod(shape)) for _, shape, _, _ in spec]
    ss = np.random.SeedSequence([int(seed), WEIGHT_STREAM])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    served = getattr(torch, dims["dtype"])
    lo = 0
    for (_, _, kind, std), n in zip(spec, sizes):
        part = flat[lo:lo + n]
        part.mul_(std)
        if kind == "scale":
            part.add_(1.0)
        elif kind == "matrix":
            part.copy_(part.to(served).float())
        lo += n
    host = flat.cpu().numpy()
    del flat
    tree: Dict = {"logit_scale": np.float32(4.6052)}
    lo = 0
    for (path, shape, _, _), n in zip(spec, sizes):
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = host[lo:lo + n].reshape(shape)
        lo += n
    return tree
