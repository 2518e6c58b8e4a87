"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  The libraries
go into ``build/mcm_tpu_torch/`` beside the package, named by a hash of
the source, every ``csrc`` header it includes (``#include "..."``,
followed through headers) and the flags, so an edited source or header
rebuilds and an unchanged one is reused.  :func:`build_all` starts one
``nvcc`` per source, all at once.  A failed build raises with ``nvcc``'s
output.

Nothing here runs at import: the wrappers import this module inside their
CUDA branch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "mcm_tpu_torch")

#: every kernel source of the port
SOURCES = ("bsd_attention", "mcm_score", "fused_mlp", "split_attention",
           "flash_attention", "bsd_probe")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output per source of the builds this process ran (ptxas lines)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (not on PATH, nor under "
                           "$CUDA_HOME/bin): the CUDA kernels cannot be built")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _inputs(name: str) -> List[str]:
    """``csrc/<name>.cu`` and every header of ``csrc`` it includes, directly
    or through another header, in the order first reached."""
    files = [f"{name}.cu"]
    for rel in files:
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                inc = inc.decode()
                if (inc not in files
                        and os.path.exists(os.path.join(CSRC_DIR, inc))):
                    files.append(inc)
    return files


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in _inputs(name):
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _start(name: str) -> Tuple[subprocess.Popen, str, str]:
    out = _lib_path(name)
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job: Tuple[subprocess.Popen, str, str]) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Sequence[str] = SOURCES) -> List[str]:
    """Build every listed source that has no current library, one ``nvcc``
    per source, all started together.  Returns the library paths."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {n: _start(n) for n in names if not os.path.exists(_lib_path(n))}
    errors = []
    for n, job in jobs.items():
        try:
            _finish(n, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n\n".join(errors))
    return [_lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[0]
            lib = ctypes.CDLL(path)
            _declare(name, lib)
            _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """argtypes/restype of every exported function: pointers and the
    stream as c_void_p, so ctypes never truncates them to 32 bits."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    if name == "bsd_attention":
        lib.mcm_bsd_attention.argtypes = [p, p, p, p, i, i, i, i, ll, ll, i, p]
        lib.mcm_bsd_attention.restype = i
        lib.mcm_bsd_attention_smem_bytes.argtypes = [i, i, i]
        lib.mcm_bsd_attention_smem_bytes.restype = ctypes.c_size_t
        lib.mcm_bsd_attention_error_string.argtypes = [i]
        lib.mcm_bsd_attention_error_string.restype = ctypes.c_char_p
    elif name == "mcm_score":
        lib.mcm_score.argtypes = [p, p, p, p, i, i, i, f, i, p]
        lib.mcm_score.restype = i
        lib.mcm_score_error_string.argtypes = [i]
        lib.mcm_score_error_string.restype = ctypes.c_char_p
    elif name == "fused_mlp":
        lib.mcm_fused_mlp.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.mcm_fused_mlp.restype = i
        lib.mcm_fused_mlp_tensor_cores.argtypes = [i, i, i]
        lib.mcm_fused_mlp_tensor_cores.restype = i
        lib.mcm_fused_mlp_smem_bytes.argtypes = [i, i, i]
        lib.mcm_fused_mlp_smem_bytes.restype = ctypes.c_size_t
        lib.mcm_fused_mlp_error_string.argtypes = [i]
        lib.mcm_fused_mlp_error_string.restype = ctypes.c_char_p
    elif name == "split_attention":
        lib.mcm_split_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        lib.mcm_split_attention.restype = i
        lib.mcm_split_attention_smem_bytes.argtypes = [i, i, i]
        lib.mcm_split_attention_smem_bytes.restype = ctypes.c_size_t
        lib.mcm_split_attention_error_string.argtypes = [i]
        lib.mcm_split_attention_error_string.restype = ctypes.c_char_p
    elif name == "flash_attention":
        lib.mcm_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.mcm_flash_attention.restype = i
        lib.mcm_flash_attention_smem_bytes.argtypes = [i, i]
        lib.mcm_flash_attention_smem_bytes.restype = ctypes.c_size_t
        lib.mcm_flash_attention_error_string.argtypes = [i]
        lib.mcm_flash_attention_error_string.restype = ctypes.c_char_p
    elif name == "bsd_probe":
        lib.mcm_bsd_probe.argtypes = [p, p, p, p, i, i, i, i, ll, ll, i, i, p]
        lib.mcm_bsd_probe.restype = i
        lib.mcm_bsd_probe_error_string.argtypes = [i]
        lib.mcm_bsd_probe_error_string.restype = ctypes.c_char_p
    else:
        raise ValueError(f"unknown kernel source {name!r}")
