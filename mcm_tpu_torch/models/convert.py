"""Weights: the framework-free ``.npz`` parameter tree and its carry-across
into the port's model.

The tree is the JAX package's (nested dicts; weights stored ``[in, out]``;
per-layer tensors stacked on a leading axis).  :func:`save_params` /
:func:`load_params` read and write the same flattened ``.npz`` the JAX
package writes, so one converted checkpoint serves both packages.
:func:`from_jax_params` turns such a tree into the port's model state.

Resolution here is restricted to a converted ``.npz`` under ``--ckpt_dir``
(or ``$MCM_TPU_CKPT_DIR``).  Conversion from HF snapshots or OpenAI ``.pt``
archives is not ported yet (``ROADMAP.md`` Queue 1, item 1).
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from mcm_tpu_torch.config import resolve_device
from mcm_tpu_torch.models.clip import CLIP

Params = Dict[str, Any]

_CKPT_DIR_ENV = "MCM_TPU_CKPT_DIR"


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "-", name)


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
                    dtype: torch.dtype = torch.float32) -> CLIP:
    """The JAX package's parameter tree (numpy arrays, as ``init_clip`` or
    ``load_params`` return it) → the port's :class:`CLIP` module on
    ``device``.  ``dtype`` is the storage type of the matrices and
    embeddings (what the forward casts them to anyway); LayerNorm
    parameters, biases and ``logit_scale`` stay fp32, as the forward uses
    them in fp32."""
    return CLIP(params, resolve_device(device), dtype)


def file_identity(path: Optional[str]) -> Optional[Dict[str, object]]:
    """Path + size + sha256 over the first, middle and last MiB of a weight
    file: enough to record in the log which file fed a run."""
    if path is None:
        return None
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


def _ckpt_dir(ckpt_dir: Optional[str]) -> str:
    return ckpt_dir or os.environ.get(_CKPT_DIR_ENV, "checkpoints")


def resolve_clip_weight_source(ckpt_name: str,
                               ckpt_dir: Optional[str] = None
                               ) -> Optional[str]:
    """The converted ``.npz`` :func:`resolve_clip_params` loads, or None."""
    native = os.path.join(_ckpt_dir(ckpt_dir), _sanitize(ckpt_name) + ".npz")
    return native if os.path.exists(native) else None


def resolve_clip_params(ckpt_name: str,
                        ckpt_dir: Optional[str] = None) -> Optional[Params]:
    """Load ``<ckpt_dir>/<sanitized-name>.npz`` (e.g. ``ViT-B-16.npz``), or
    return None when there is none.  An unconverted OpenAI ``.pt`` archive
    beside it raises instead of being ignored: the run would otherwise go
    on to random weights while real ones sit on disk."""
    native = resolve_clip_weight_source(ckpt_name, ckpt_dir)
    if native is not None:
        return load_params(native)
    pt = os.path.join(_ckpt_dir(ckpt_dir), _sanitize(ckpt_name) + ".pt")
    if os.path.exists(pt):
        raise NotImplementedError(
            f"{pt} is an unconverted checkpoint; HF/OpenAI conversion is not "
            f"ported yet (ROADMAP.md Queue 1, item 1). Convert it to "
            f"{_sanitize(ckpt_name)}.npz with tools/convert_checkpoint.py")
    return None
