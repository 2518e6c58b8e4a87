"""Convert an HF or OpenAI checkpoint into the ``.npz`` parameter tree.

    python -m mcm_tpu_torch.tools.convert_checkpoint --model clip \
        --ckpt ViT-B/16 --src /path/to/clip-vit-base-patch16 --out checkpoints/
    python -m mcm_tpu_torch.tools.convert_checkpoint --model clip \
        --ckpt ViT-B/16 --src /path/to/ViT-B-16.pt --out checkpoints/
    python -m mcm_tpu_torch.tools.convert_checkpoint --model vit \
        --src /path/to/vit-base-patch16-224 --out checkpoints/

``--src`` is an HF snapshot directory (``model.safetensors`` or
``pytorch_model.bin``) or, for CLIP, an original OpenAI ``.pt``
(TorchScript archive); the CLIP layout is sniffed.  Writes
``<out>/<sanitized ckpt>.npz`` (e.g. ``ViT-B-16.npz``) for CLIP and
``<out>/vit-base-patch16-224.npz`` for the supervised ViT
(``ViTForImageClassification``, 1000 classes): the files both the port
and the JAX package load first.  ``--format orbax`` is accepted as the
JAX package's tool accepts it, and raises: orbax is a JAX library.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=["clip", "vit"], required=True)
    p.add_argument("--ckpt", default="ViT-B/16",
                   choices=["ViT-B/32", "ViT-B/16", "ViT-L/14"],
                   help="CLIP architecture (ignored for --model vit)")
    p.add_argument("--src", required=True, help="HF snapshot dir or file")
    p.add_argument("--out", default="checkpoints", help="output directory")
    p.add_argument("--format", default="npz", choices=["npz", "orbax"])
    args = p.parse_args(argv)

    if args.format == "orbax":
        raise NotImplementedError(
            "--format orbax writes a JAX (orbax) checkpoint; the port writes "
            "--format npz only (ROADMAP.md Queue 3)")

    from mcm_tpu_torch.config import CLIP_CONFIGS, SupervisedViTConfig
    from mcm_tpu_torch.models.convert import (_flatten, _sanitize,
                                              convert_clip_state_dict,
                                              load_state_dict, save_params)

    sd = load_state_dict(args.src)
    if args.model == "clip":
        params = convert_clip_state_dict(sd, CLIP_CONFIGS[args.ckpt]())
        name = f"{_sanitize(args.ckpt)}.npz"
    else:
        from mcm_tpu_torch.models.vit import VIT_NPZ, convert_hf_vit
        params = convert_hf_vit(sd, SupervisedViTConfig(num_classes=1000))
        name = VIT_NPZ
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, name)
    save_params(params, path)
    n = sum(np.asarray(x).size for x in _flatten(params).values())
    print(f"wrote {path} ({n / 1e6:.1f}M params)")
    return path


if __name__ == "__main__":
    main()
