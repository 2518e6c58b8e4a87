"""Weights: checkpoint conversion, the framework-free ``.npz`` parameter
tree, and its carry-across into the port's model.

The tree is the JAX package's (nested dicts; weights stored ``[in, out]``;
per-layer tensors stacked on a leading axis).  :func:`save_params` /
:func:`load_params` read and write the same flattened ``.npz`` the JAX
package writes, so one converted checkpoint serves both packages.
:func:`from_jax_params` turns such a tree into the port's model state.

Conversion accepts a local HF ``openai/clip-vit-*`` snapshot
(``model.safetensors`` or ``pytorch_model.bin``) or an original OpenAI
``ViT-*-*.pt`` TorchScript archive; both converge to the same tree.  The
``.safetensors`` format is read here (no ``safetensors`` package needed).

Resolution order for a checkpoint name (e.g. ``ViT-B/16``), under
``--ckpt_dir`` or ``$MCM_TPU_CKPT_DIR`` (default ``checkpoints``):
  1. ``<ckpt_dir>/<sanitized-name>.npz``  (the converted cache)
  2. ``<ckpt_dir>/<sanitized-name>.pt``   (OpenAI checkpoint)
  3. ``<ckpt_dir>/<hf-repo-basename>/``   (local HF snapshot)
  4. the HF hub cache under ``$HF_HOME`` (``~/.cache/huggingface``)
A converted checkpoint is cached as the ``.npz`` of route 1.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import struct
import warnings
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from mcm_tpu_torch.config import (CLIP_CONFIGS, HF_CKPT_MAPPING, CLIPConfig,
                                  resolve_device)
from mcm_tpu_torch.models.clip import CLIP

Params = Dict[str, Any]

_CKPT_DIR_ENV = "MCM_TPU_CKPT_DIR"


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "-", name)


# ---------------------------------------------------------------------------
# Raw state-dict loading
# ---------------------------------------------------------------------------

_SAFETENSORS_NUMPY = {"F32": "<f4", "F16": "<f2"}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file → {name: array}: a little-endian u64 header
    length, a JSON header of ``{name: {dtype, shape, data_offsets}}``, then
    the raw bytes.  F32 and F16 come back in their own type, as
    ``safetensors.numpy.load_file`` returns them; BF16 (which numpy lacks)
    comes back as float32.  Any other dtype raises."""
    size = os.path.getsize(path)
    data = bytearray(size)
    with open(path, "rb") as f:
        f.readinto(data)
    if size < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > size:
        raise ValueError(f"{path}: header of {n} bytes past the end of the "
                         f"file ({size} bytes)")
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype, shape = info["dtype"], tuple(info["shape"])
        lo, hi = info["data_offsets"]
        itemsize = 2 if dtype in ("F16", "BF16") else 4
        if dtype not in _SAFETENSORS_NUMPY and dtype != "BF16":
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}; "
                             f"only F32, F16 and BF16 are read")
        if hi - lo != int(np.prod(shape)) * itemsize or hi > len(body):
            raise ValueError(f"{path}: tensor {name!r} ({dtype}, {shape}) "
                             f"does not match its data_offsets {lo}..{hi}")
        buf = body[lo:hi]
        if dtype == "BF16":
            arr = (torch.frombuffer(buf, dtype=torch.bfloat16).float().numpy()
                   if hi > lo else np.zeros(0, np.float32))
        else:
            arr = np.frombuffer(buf, dtype=_SAFETENSORS_NUMPY[dtype])
        out[name] = arr.reshape(shape)
    return out


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load an HF checkpoint directory or file into {name: np.ndarray}."""
    if os.path.isdir(path):
        for fname in ("model.safetensors", "pytorch_model.bin"):
            cand = os.path.join(path, fname)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"no model.safetensors / pytorch_model.bin under {path}")
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    # a torch pickle; OpenAI's published CLIP checkpoints are TorchScript
    # archives, which torch.load cannot unpickle and torch.jit.load can
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as plain_err:  # noqa: BLE001 (maybe a jit archive)
        try:
            sd = torch.jit.load(path, map_location="cpu").state_dict()
        except Exception:
            # neither format: surface the original torch.load failure, not
            # a misleading "not a TorchScript archive"
            raise RuntimeError(
                f"{path} loads as neither a plain state dict nor a "
                f"TorchScript archive") from plain_err
    return {k: v.float().numpy() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# HF CLIPModel state dict → tree
# ---------------------------------------------------------------------------

def _stack(sd: Dict[str, np.ndarray], tmpl: str, n: int,
           transpose: bool) -> np.ndarray:
    mats = [sd[tmpl.format(i)] for i in range(n)]
    if transpose:  # torch Linear stores (out, in)
        return np.ascontiguousarray(np.stack(mats).transpose(0, 2, 1),
                                    dtype=np.float32)
    return np.stack(mats).astype(np.float32)


def _tower_layers(sd: Dict[str, np.ndarray], prefix: str, n: int) -> Params:
    def w(name):  # stacked, transposed weights
        return _stack(sd, f"{prefix}.encoder.layers.{{}}.{name}.weight", n, True)

    def b(name):
        return _stack(sd, f"{prefix}.encoder.layers.{{}}.{name}.bias", n, False)

    return {
        "ln1": {"scale": _stack(sd, f"{prefix}.encoder.layers.{{}}.layer_norm1.weight", n, False),
                "bias": b("layer_norm1")},
        "attn": {
            "wq": w("self_attn.q_proj"), "bq": b("self_attn.q_proj"),
            "wk": w("self_attn.k_proj"), "bk": b("self_attn.k_proj"),
            "wv": w("self_attn.v_proj"), "bv": b("self_attn.v_proj"),
            "wo": w("self_attn.out_proj"), "bo": b("self_attn.out_proj"),
        },
        "ln2": {"scale": _stack(sd, f"{prefix}.encoder.layers.{{}}.layer_norm2.weight", n, False),
                "bias": b("layer_norm2")},
        "mlp": {
            "w1": w("mlp.fc1"), "b1": b("mlp.fc1"),
            "w2": w("mlp.fc2"), "b2": b("mlp.fc2"),
        },
    }


def convert_hf_clip(sd: Dict[str, np.ndarray], cfg: CLIPConfig) -> Params:
    """Map an HF ``CLIPModel`` state dict onto the tree layout."""
    # some HF dumps prefix every key with "clip."
    if any(k.startswith("clip.") for k in sd):
        sd = {k.removeprefix("clip."): v for k, v in sd.items()}

    p = cfg.vision.patch_size
    conv_w = sd["vision_model.embeddings.patch_embedding.weight"]
    # (D, 3, p, p) → (p, p, 3, D) → (p*p*3, D): the patchify order
    patch_embed = conv_w.transpose(2, 3, 1, 0).reshape(p * p * 3,
                                                       cfg.vision.width)

    vision = {
        "patch_embed": patch_embed.astype(np.float32),
        "class_emb": sd["vision_model.embeddings.class_embedding"].astype(np.float32),
        "pos_emb": sd["vision_model.embeddings.position_embedding.weight"].astype(np.float32),
        # HF's (sic) "pre_layrnorm"
        "pre_ln": {"scale": sd["vision_model.pre_layrnorm.weight"].astype(np.float32),
                   "bias": sd["vision_model.pre_layrnorm.bias"].astype(np.float32)},
        "layers": _tower_layers(sd, "vision_model", cfg.vision.layers),
        "post_ln": {"scale": sd["vision_model.post_layernorm.weight"].astype(np.float32),
                    "bias": sd["vision_model.post_layernorm.bias"].astype(np.float32)},
        "proj": sd["visual_projection.weight"].T.astype(np.float32),
    }
    text = {
        "token_emb": sd["text_model.embeddings.token_embedding.weight"].astype(np.float32),
        "pos_emb": sd["text_model.embeddings.position_embedding.weight"].astype(np.float32),
        "layers": _tower_layers(sd, "text_model", cfg.text.layers),
        "final_ln": {"scale": sd["text_model.final_layer_norm.weight"].astype(np.float32),
                     "bias": sd["text_model.final_layer_norm.bias"].astype(np.float32)},
        "proj": sd["text_projection.weight"].T.astype(np.float32),
    }
    return {"vision": vision, "text": text,
            "logit_scale": _scalar(sd["logit_scale"])}


def _scalar(x) -> np.ndarray:
    """logit_scale as a () fp32 array (checkpoints store it 0-d or (1,))."""
    return np.asarray(x, np.float32).reshape(())


# ---------------------------------------------------------------------------
# OpenAI (github.com/openai/CLIP) state dict → tree
# ---------------------------------------------------------------------------

def _openai_tower_layers(sd: Dict[str, np.ndarray], prefix: str,
                         n: int, width: int) -> Params:
    """OpenAI packs q/k/v as one ``attn.in_proj_weight`` [3D, D] (rows q,
    k, v) and names the MLP matrices ``c_fc``/``c_proj``; everything else
    maps one to one onto the HF layout."""
    def g(i, name):
        return sd[f"{prefix}.resblocks.{i}.{name}"]

    def stack(name, transpose):
        mats = [g(i, name) for i in range(n)]
        if transpose:
            mats = [m.T for m in mats]
        return np.stack(mats).astype(np.float32)

    def qkv(sl, bias):
        leaf = "attn.in_proj_bias" if bias else "attn.in_proj_weight"
        mats = [g(i, leaf)[sl] for i in range(n)]
        if not bias:
            mats = [m.T for m in mats]
        return np.stack(mats).astype(np.float32)

    d = width
    q, k, v = slice(0, d), slice(d, 2 * d), slice(2 * d, 3 * d)
    return {
        "ln1": {"scale": stack("ln_1.weight", False),
                "bias": stack("ln_1.bias", False)},
        "attn": {
            "wq": qkv(q, False), "bq": qkv(q, True),
            "wk": qkv(k, False), "bk": qkv(k, True),
            "wv": qkv(v, False), "bv": qkv(v, True),
            "wo": stack("attn.out_proj.weight", True),
            "bo": stack("attn.out_proj.bias", False),
        },
        "ln2": {"scale": stack("ln_2.weight", False),
                "bias": stack("ln_2.bias", False)},
        "mlp": {
            "w1": stack("mlp.c_fc.weight", True),
            "b1": stack("mlp.c_fc.bias", False),
            "w2": stack("mlp.c_proj.weight", True),
            "b2": stack("mlp.c_proj.bias", False),
        },
    }


def convert_openai_clip(sd: Dict[str, np.ndarray],
                        cfg: CLIPConfig) -> Params:
    """Map an original OpenAI CLIP state dict (``ViT-B-16.pt`` et al.)
    onto the tree.  OpenAI's ``visual.proj`` / ``text_projection`` are
    stored already oriented for ``x @ proj``: no transpose, unlike HF
    Linear weights."""
    p = cfg.vision.patch_size
    conv_w = sd["visual.conv1.weight"]  # (D, 3, p, p), no bias in OpenAI
    patch_embed = conv_w.transpose(2, 3, 1, 0).reshape(p * p * 3,
                                                       cfg.vision.width)
    vision = {
        "patch_embed": patch_embed.astype(np.float32),
        "class_emb": sd["visual.class_embedding"].astype(np.float32),
        "pos_emb": sd["visual.positional_embedding"].astype(np.float32),
        "pre_ln": {"scale": sd["visual.ln_pre.weight"].astype(np.float32),
                   "bias": sd["visual.ln_pre.bias"].astype(np.float32)},
        "layers": _openai_tower_layers(sd, "visual.transformer",
                                       cfg.vision.layers, cfg.vision.width),
        "post_ln": {"scale": sd["visual.ln_post.weight"].astype(np.float32),
                    "bias": sd["visual.ln_post.bias"].astype(np.float32)},
        "proj": sd["visual.proj"].astype(np.float32),
    }
    text = {
        "token_emb": sd["token_embedding.weight"].astype(np.float32),
        "pos_emb": sd["positional_embedding"].astype(np.float32),
        "layers": _openai_tower_layers(sd, "transformer",
                                       cfg.text.layers, cfg.text.width),
        "final_ln": {"scale": sd["ln_final.weight"].astype(np.float32),
                     "bias": sd["ln_final.bias"].astype(np.float32)},
        "proj": sd["text_projection"].astype(np.float32),
    }
    return {"vision": vision, "text": text,
            "logit_scale": _scalar(sd["logit_scale"])}


def convert_clip_state_dict(sd: Dict[str, np.ndarray],
                            cfg: CLIPConfig) -> Params:
    """Format-sniffing entry point: HF ``CLIPModel`` or OpenAI layout."""
    if "visual.proj" in sd or "visual.conv1.weight" in sd:
        return convert_openai_clip(sd, cfg)
    return convert_hf_clip(sd, cfg)


# ---------------------------------------------------------------------------
# The .npz tree
# ---------------------------------------------------------------------------

def _flatten(tree: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Params:
    tree: Params = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params(params: Params, path: str) -> None:
    """Atomic write to EXACTLY ``path`` (``np.savez`` on a path would
    append ``.npz`` to an extension-less name, and a crash mid-save must
    not leave a truncated zip behind)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **_flatten(params))
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_params(path: str) -> Params:
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


def from_jax_params(params: Params, device="cuda",
                    dtype: torch.dtype = torch.float32,
                    trainable: bool = False) -> CLIP:
    """The JAX package's parameter tree (numpy arrays, as ``init_clip`` or
    ``load_params`` return it) → the port's :class:`CLIP` module on
    ``device``.  ``dtype`` is the storage type of the matrices and
    embeddings (what the forward casts them to anyway); LayerNorm
    parameters, biases and ``logit_scale`` stay fp32, as the forward uses
    them in fp32.  ``trainable=True`` gives every leaf in fp32 with
    ``requires_grad``: the master parameters of training, as JAX trains
    ``init_clip``'s fp32 tree."""
    if trainable and dtype != torch.float32:
        raise ValueError(f"trainable parameters are fp32 master copies; "
                         f"got dtype={dtype}")
    return CLIP(params, resolve_device(device), dtype,
                requires_grad=trainable)


def to_jax_params(model: torch.nn.Module) -> Params:
    """The inverse of :func:`from_jax_params`: the module's leaves as the
    JAX package's numpy tree (fp32, ``init_clip``'s keys and shapes), on
    the host, ready for :func:`save_params`."""
    tree: Params = {name: to_jax_params(sub)
                    for name, sub in model.named_children()}
    for name, p in model.named_parameters(recurse=False):
        tree[name] = p.detach().to("cpu", torch.float32, copy=True).numpy()
    return tree


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

def file_identity(path: Optional[str]) -> Optional[Dict[str, object]]:
    """Path + size + sha256 over the first, middle and last MiB of a weight
    file: enough to record in the log which file fed a run.  An unreadable
    file gives its path and the error's name rather than raising."""
    if path is None:
        return None
    try:
        st = os.stat(path)
        h = hashlib.sha256()
        with open(path, "rb") as f:
            h.update(f.read(1 << 20))
            if st.st_size > (3 << 20):
                f.seek((st.st_size >> 1) - (1 << 19))
                h.update(f.read(1 << 20))
            if st.st_size > (2 << 20):
                f.seek(-(1 << 20), os.SEEK_END)
            h.update(f.read(1 << 20))
        return {"path": os.path.abspath(path), "size": st.st_size,
                "sha256_sampled": h.hexdigest()}
    except OSError as e:
        return {"path": os.path.abspath(path), "error": type(e).__name__}


def _ckpt_dir(ckpt_dir: Optional[str]) -> str:
    return ckpt_dir or os.environ.get(_CKPT_DIR_ENV, "checkpoints")


def _snapshot_weight_file(d: str) -> Optional[str]:
    """The weight file inside an HF snapshot directory."""
    for fname in ("model.safetensors", "pytorch_model.bin"):
        cand = os.path.join(d, fname)
        if os.path.exists(cand):
            return cand
    return None


def _hf_cache_snapshot(repo_id: str) -> Optional[str]:
    cache = os.environ.get("HF_HOME",
                           os.path.expanduser("~/.cache/huggingface"))
    base = os.path.join(cache, "hub",
                        "models--" + repo_id.replace("/", "--"), "snapshots")
    if not os.path.isdir(base):
        return None
    for snap in sorted(os.listdir(base)):
        d = os.path.join(base, snap)
        if _snapshot_weight_file(d):
            return d
    return None


def resolve_clip_weight_source(ckpt_name: str,
                               ckpt_dir: Optional[str] = None
                               ) -> Optional[str]:
    """The file :func:`resolve_clip_params` loads weights from, or None, in
    the same order.  Call it after the params resolved, so that a cache
    the conversion just wrote is what is named."""
    ckpt_dir = _ckpt_dir(ckpt_dir)
    native = os.path.join(ckpt_dir, _sanitize(ckpt_name) + ".npz")
    if os.path.exists(native):
        return native
    repo_id = HF_CKPT_MAPPING[ckpt_name]
    pt = os.path.join(ckpt_dir, _sanitize(ckpt_name) + ".pt")
    if os.path.exists(pt):
        return pt
    local_snap = os.path.join(ckpt_dir, repo_id.split("/")[-1])
    if os.path.isdir(local_snap):
        return _snapshot_weight_file(local_snap) or local_snap
    snap = _hf_cache_snapshot(repo_id)
    if snap:
        return _snapshot_weight_file(snap) or snap
    return None


def resolve_clip_params(ckpt_name: str,
                        ckpt_dir: Optional[str] = None) -> Optional[Params]:
    """Find and convert pretrained weights for a checkpoint name, or return
    None (the runner then refuses, or warns and takes random weights under
    ``--allow_random_weights``)."""
    cfg = CLIP_CONFIGS[ckpt_name]()
    ckpt_dir = _ckpt_dir(ckpt_dir)
    native = os.path.join(ckpt_dir, _sanitize(ckpt_name) + ".npz")
    if os.path.exists(native):
        try:
            return load_params(native)
        except (ValueError, OSError, KeyError, zipfile.BadZipFile) as e:
            # a corrupt cache must not hide a valid source checkpoint
            # beside it: fall through and convert again
            warnings.warn(f"cached {native} is unreadable ({e}); "
                          f"re-converting from the source checkpoint")

    repo_id = HF_CKPT_MAPPING[ckpt_name]
    # OpenAI's published filename is the sanitized name ("ViT-B-16.pt")
    candidates = [os.path.join(ckpt_dir, _sanitize(ckpt_name) + ".pt"),
                  os.path.join(ckpt_dir, repo_id.split("/")[-1])]
    snap = _hf_cache_snapshot(repo_id)
    if snap:
        candidates.append(snap)
    for cand in candidates:
        if os.path.isdir(cand) or (cand.endswith(".pt")
                                   and os.path.exists(cand)):
            params = convert_clip_state_dict(load_state_dict(cand), cfg)
            try:  # cache the converted tree for the next run
                os.makedirs(ckpt_dir, exist_ok=True)
                save_params(params, native)
            except OSError:
                pass
            return params
    return None
