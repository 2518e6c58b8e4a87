"""A configuration file (``configs/<name>.json``, the published HF
``CLIPConfig`` keys) read into plain sizes, and into the program's config
object."""

from __future__ import annotations

import json


def load(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def dims(cfg: dict) -> dict:
    """Plain sizes of both towers: what the weights, the reference and the
    roofline arithmetic read."""
    v, t = cfg["vision_config"], cfg["text_config"]
    return {
        "vision": {"width": v["hidden_size"], "layers": v["num_hidden_layers"],
                   "heads": v["num_attention_heads"], "mlp": v["intermediate_size"],
                   "patch_size": v["patch_size"], "image_size": v["image_size"],
                   "eps": v["layer_norm_eps"]},
        "text": {"width": t["hidden_size"], "layers": t["num_hidden_layers"],
                 "heads": t["num_attention_heads"], "mlp": t["intermediate_size"],
                 "vocab_size": t["vocab_size"],
                 "context_length": t["max_position_embeddings"],
                 "eps": t["layer_norm_eps"]},
        "embed_dim": cfg["projection_dim"],
        "dtype": cfg["torch_dtype"],
        "precision": cfg["precision"],
    }


def program_config(cfg: dict):
    """The program's ``CLIPConfig`` for these sizes."""
    from mcm_tpu_torch.config import CLIPConfig, TextConfig, VisionConfig
    d = dims(cfg)
    v, t = d["vision"], d["text"]
    for tower in (v, t):
        if tower["mlp"] % tower["width"]:
            raise ValueError(f"intermediate size {tower['mlp']} is not a "
                             f"multiple of the width {tower['width']}")
    return CLIPConfig(
        name=cfg["program_name"],
        vision=VisionConfig(image_size=v["image_size"],
                            patch_size=v["patch_size"], width=v["width"],
                            layers=v["layers"], heads=v["heads"],
                            mlp_ratio=v["mlp"] // v["width"],
                            projection_dim=d["embed_dim"],
                            layer_norm_eps=v["eps"]),
        text=TextConfig(vocab_size=t["vocab_size"],
                        context_length=t["context_length"], width=t["width"],
                        layers=t["layers"], heads=t["heads"],
                        mlp_ratio=t["mlp"] // t["width"],
                        projection_dim=d["embed_dim"], layer_norm_eps=t["eps"]))
