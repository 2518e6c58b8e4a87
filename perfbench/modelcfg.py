"""A configuration file (``configs/<name>.json``, the published HF
``CLIPConfig`` keys) read into plain sizes, into the plain reference it
names, and into the program's config object."""

from __future__ import annotations

import json
import os
import re
from types import ModuleType


def load(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def dims(cfg: dict) -> dict:
    """Plain sizes of both towers: what the weights, the reference and the
    roofline arithmetic read.  A key missing from the file raises."""
    v, t = cfg["vision_config"], cfg["text_config"]
    return {
        "vision": {"width": v["hidden_size"], "layers": v["num_hidden_layers"],
                   "heads": v["num_attention_heads"], "mlp": v["intermediate_size"],
                   "patch_size": v["patch_size"], "image_size": v["image_size"],
                   "eps": v["layer_norm_eps"], "hidden_act": v["hidden_act"]},
        "text": {"width": t["hidden_size"], "layers": t["num_hidden_layers"],
                 "heads": t["num_attention_heads"], "mlp": t["intermediate_size"],
                 "vocab_size": t["vocab_size"],
                 "context_length": t["max_position_embeddings"],
                 "eps": t["layer_norm_eps"], "hidden_act": t["hidden_act"]},
        "embed_dim": cfg["projection_dim"],
        "dtype": cfg["torch_dtype"],
        "precision": cfg["precision"],
    }


def reference(root: str, cfg: dict) -> ModuleType:
    """The plain reference module that the configuration's ``reference``
    key names: a path relative to the checkout ``root``, loaded by that
    path."""
    from perfbench.spec import load_module
    rel, root = cfg["reference"], os.path.abspath(root)
    path = os.path.normpath(os.path.join(root, rel))
    if os.path.isabs(rel) or os.path.commonpath([root, path]) != root:
        raise ValueError(f"reference {rel!r} is not a path inside the "
                         f"checkout")
    return load_module(path, re.sub(r"\W", "_", os.path.splitext(rel)[0]))


def program_config(cfg: dict):
    """The program's ``CLIPConfig`` for this configuration.  Where the
    program reads the published keys itself
    (``mcm_tpu_torch.config.clip_config_from_hf(cfg, name)``), the
    program's reading is the config, and what it cannot run it refuses;
    without that reader, :func:`_mapped_config`."""
    from mcm_tpu_torch import config
    read = getattr(config, "clip_config_from_hf", None)
    if read is not None:
        return read(cfg, cfg["program_name"])
    return _mapped_config(cfg)


def _mapped_config(cfg: dict):
    """The published keys mapped onto the fields that the program's
    ``CLIPConfig`` has: QuickGELU, three channels and an MLP whose width is
    a whole multiple of the tower's.  Anything else raises, naming the key
    and its value."""
    from mcm_tpu_torch.config import CLIPConfig, TextConfig, VisionConfig
    d = dims(cfg)
    v, t = d["vision"], d["text"]
    channels = cfg["vision_config"]["num_channels"]
    if channels != 3:
        raise ValueError(f"vision_config.num_channels {channels!r}: the "
                         f"program reads 3")
    for key, tower in (("vision_config", v), ("text_config", t)):
        if tower["hidden_act"] != "quick_gelu":
            raise ValueError(f"{key}.hidden_act {tower['hidden_act']!r}: the "
                             f"program runs quick_gelu")
        if tower["mlp"] % tower["width"]:
            raise ValueError(f"{key}.intermediate_size {tower['mlp']} is not "
                             f"a multiple of hidden_size {tower['width']}")
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
