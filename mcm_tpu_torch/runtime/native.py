"""ctypes bindings and build for the port's native host decoder.

``decoder.cpp`` (the port's copy of the JAX package's libjpeg decoder, with
the same C ABI) is compiled on first use with ``g++ -O3 -march=native``
against the ABI-62 libjpeg headers vendored in ``include/`` and linked to
the first ABI-62 libjpeg :func:`find_libjpeg` finds on the host: the
system's ``libjpeg.so.62``, else the copy of libjpeg-turbo that Pillow's
wheel bundles (``pillow.libs/libjpeg-*.so.62*``), which is what a host
without a system libjpeg has.  The library is linked by its full path
with an absolute rpath to its directory, so the loader needs no search
path.

The build goes into ``build/mcm_tpu_torch/`` beside the package, never
beside the source, under a name keyed by the host's CPU (``-march=native``
code SIGILLs on another CPU, and dlopen cannot tell), the libjpeg's path
and a hash of the source and headers; it is published atomically
(temporary file, then ``os.replace``), so concurrent builds each publish
a whole library.  After loading, a self-test decodes a small JPEG embedded
below and compares the pixels with stored ones: a header/library mismatch
(``JERR_BAD_STRUCT_SIZE``, a shifted struct layout) makes the route
unavailable with its reason instead of decoding wrong pixels.

Without a compiler, a libjpeg, or with ``MCM_TPU_DISABLE_NATIVE=1`` (the
JAX package's variable, honoured under the same name), the callers fall
back to PIL: :func:`native_available` gates the fast path and
:func:`native_info` names the route and why.  The native resize matches
PIL to ±2 LSB; ``fast=True`` (DCT-prescaled decode, fast IDCT) is a
throughput mode, not a parity one.

Nothing here runs at import.
"""

from __future__ import annotations

import base64
import ctypes
import glob
import hashlib
import importlib.util
import os
import platform
import subprocess
import sysconfig
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mcm_tpu_torch.ops._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "decoder.cpp")
_INCLUDE = os.path.join(_DIR, "include")
_HEADERS = ("jpeglib.h", "jmorecfg.h", "jerror.h", "jconfig.h")

#: the variable that forces the PIL route (the JAX package's name)
DISABLE_ENV = "MCM_TPU_DISABLE_NATIVE"

# The self-test: an 8x8 baseline JPEG without chroma subsampling, decoded
# at its own size (the crop copies it through, no resample), so the pixels
# are libjpeg's accurate-integer IDCT and colour conversion alone, the
# same in every ABI-62 libjpeg; and those pixels.
_SELFTEST_JPEG = base64.b64decode(
    b"/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoH"
    b"BwYIDAoMDAsKCwsNDhIQDQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/2wBDAQME"
    b"BAUEBQkFBQkUDQsNFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQU"
    b"FBQUFBQUFBQUFBQUFBT/wAARCAAIAAgDAREAAhEBAxEB/8QAHwAAAQUBAQEBAQEA"
    b"AAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIh"
    b"MUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6"
    b"Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZ"
    b"mqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx"
    b"8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA"
    b"AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAV"
    b"YnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hp"
    b"anN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPE"
    b"xcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwDI"
    b"/ZW+EJittLtVgGZSrPxyFGMce57+1ZcaYmWEy/DZNRteu+aequoQacU1ZtKUtVJN"
    b"fw2tU3Z8eeHPNOrUcNv6/r1P/9k=")
_SELFTEST_SIZE = 8
_SELFTEST_PIXELS = base64.b64decode(
    b"DggACSQ1CURUA3R8EYWqDqPdAsoHDOU+JAYSMC9BIUxuHmaMJ4TSL5v1H9IUKec/"
    b"RgUtUSlLPkuCTmWxUI7ZTrQTPMoqT+NpZgdBaydWXUWTc2rHbXv1YaUSX8RAcOV8"
    b"hwdaiCyBhEieiGrcgJAAfaUqjNBHiut4pgpToyuNqkbCqmj9pYcDoakyrsZ4p+So"
    b"ywSBySWeyUTdzWDxzowuz6VPx8R3yuW65QmE8irI4kzf2W0T3odE96hl4sWj5+2v")


class NativeUnavailable(RuntimeError):
    """The native route cannot be built, loaded or trusted here; the
    message is the reason."""


def _host_tag() -> str:
    """Identifies the CPU a library is built for: -march=native code moved
    to a different machine (shared checkout, copied build directory) would
    SIGILL at first call, so the cache key must hold it."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = line
                    break
    except OSError:
        pass
    return (platform.machine() + ":"
            + hashlib.md5(flags.encode()).hexdigest()[:12])


# -- which libjpeg -----------------------------------------------------------

def system_libjpeg_candidates() -> List[str]:
    """``libjpeg.so.62`` in the system's library directories."""
    arch = sysconfig.get_config_var("MULTIARCH") or ""
    dirs = [os.path.join(root, arch) for root in ("/usr/lib", "/lib")
            if arch] + ["/usr/lib64", "/lib64", "/usr/lib", "/usr/local/lib"]
    return [os.path.join(d, "libjpeg.so.62") for d in dirs]


def pillow_libjpeg_candidates() -> List[str]:
    """The libjpeg that Pillow's wheel bundles, ``pillow.libs/libjpeg-*.so.62*``
    beside the installed ``PIL`` package (without importing it)."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.origin:
        return []
    site = os.path.dirname(os.path.dirname(spec.origin))
    return sorted(glob.glob(os.path.join(site, "pillow.libs",
                                         "libjpeg-*.so.62*")))


def find_libjpeg(candidates: Optional[Sequence[str]] = None) -> Optional[str]:
    """The first of ``candidates`` that exists (default: the system's
    ``libjpeg.so.62``, then Pillow's bundled copy), as an absolute path;
    None if there is none."""
    if candidates is None:
        candidates = system_libjpeg_candidates() + pillow_libjpeg_candidates()
    for path in candidates:
        if os.path.isfile(path):
            return os.path.abspath(path)
    return None


# -- build -------------------------------------------------------------------

def _source_digest() -> str:
    digest = hashlib.sha256()
    for path in [_SRC] + [os.path.join(_INCLUDE, h) for h in _HEADERS]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return digest.hexdigest()


def library_path(libjpeg: str, build_dir: str = BUILD_DIR) -> str:
    """Where the decoder built against ``libjpeg`` on this host lives: the
    name is keyed by the host tag, the libjpeg's resolved path and the hash
    of the source and headers."""
    key = "\0".join((_host_tag(), os.path.realpath(libjpeg),
                     _source_digest()))
    return os.path.join(
        build_dir,
        f"libmcmdecoder_{hashlib.sha256(key.encode()).hexdigest()[:16]}.so")


def build(libjpeg: str, build_dir: str = BUILD_DIR) -> str:
    """Compile the decoder against ``libjpeg`` into ``build_dir`` (to a
    temporary file, published with ``os.replace``); returns its path.
    Raises :class:`NativeUnavailable` with the compiler's output."""
    out = library_path(libjpeg, build_dir)
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.build.{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           f"-I{_INCLUDE}", _SRC, "-o", tmp, libjpeg,
           f"-Wl,-rpath,{os.path.dirname(os.path.abspath(libjpeg))}",
           "-pthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=240)
        os.replace(tmp, out)
    except (subprocess.SubprocessError, OSError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise NativeUnavailable(f"build failed: {detail[-400:]}") from e
    return out


# -- the library -------------------------------------------------------------

def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


class Decoder:
    """One loaded decoder library and the libjpeg it is linked to."""

    def __init__(self, path: str, libjpeg: str):
        lib = ctypes.CDLL(path)
        u8p, i32p = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)
        c_int, c_long, c_char_p = ctypes.c_int, ctypes.c_long, ctypes.c_char_p
        lib.mcm_decode_one.restype = c_int
        lib.mcm_decode_one.argtypes = [c_char_p, c_int, u8p, c_int]
        lib.mcm_decode_batch.restype = c_int
        lib.mcm_decode_batch.argtypes = [
            ctypes.POINTER(c_char_p), c_int, c_int, u8p, c_int, c_int, i32p]
        lib.mcm_decode_mem.restype = c_int
        lib.mcm_decode_mem.argtypes = [c_char_p, c_long, c_int, u8p, c_int]
        lib.mcm_decode_mem_batch.restype = c_int
        lib.mcm_decode_mem_batch.argtypes = [
            ctypes.POINTER(c_char_p), ctypes.POINTER(c_long), c_int, c_int,
            u8p, c_int, c_int, i32p]
        self.lib, self.path, self.libjpeg = lib, path, libjpeg

    def self_test(self) -> None:
        """Decode the embedded JPEG; raise :class:`NativeUnavailable` unless
        the pixels are the stored ones."""
        s = _SELFTEST_SIZE
        out = np.zeros((s, s, 3), np.uint8)
        rc = self.lib.mcm_decode_mem(_SELFTEST_JPEG, len(_SELFTEST_JPEG), s,
                                     _u8p(out), 0)
        if rc != 0:
            raise NativeUnavailable(
                f"self-test decode failed (status {rc}) with {self.libjpeg}")
        if out.tobytes() != _SELFTEST_PIXELS:
            want = np.frombuffer(_SELFTEST_PIXELS, np.uint8).reshape(s, s, 3)
            delta = int(np.abs(out.astype(np.int16) - want).max())
            raise NativeUnavailable(
                f"self-test pixels differ (max |delta| {delta}) with "
                f"{self.libjpeg}")

    def decode_one(self, path: str, size: int = 224,
                   fast: bool = False) -> Optional[np.ndarray]:
        """uint8 [size, size, 3], or None if the native path can't decode
        it."""
        out = np.empty((size, size, 3), dtype=np.uint8)
        rc = self.lib.mcm_decode_one(os.fsencode(path), size, _u8p(out),
                                     int(fast))
        return out if rc == 0 else None

    def decode_one_mem(self, data: bytes, size: int = 224,
                       fast: bool = False) -> Optional[np.ndarray]:
        """One in-memory JPEG (a request body) → uint8 [size, size, 3], or
        None if the native path can't decode it."""
        out = np.empty((size, size, 3), dtype=np.uint8)
        rc = self.lib.mcm_decode_mem(data, len(data), size, _u8p(out),
                                     int(fast))
        return out if rc == 0 else None

    def decode_mem_batch(self, datas: Sequence[bytes], size: int = 224,
                         n_threads: int = 0, fast: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """In-memory JPEGs on the thread pool: (uint8 [N, size, size, 3],
        int32 status [N]); rows with status ≠ 0 failed."""
        n = len(datas)
        out = np.empty((n, size, size, 3), dtype=np.uint8)
        status = np.zeros((n,), dtype=np.int32)
        arr = (ctypes.c_char_p * n)(*datas)
        lens = (ctypes.c_long * n)(*[len(d) for d in datas])
        self.lib.mcm_decode_mem_batch(
            arr, lens, n, size, _u8p(out),
            n_threads or default_decode_threads(), int(fast),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return out, status

    def decode_batch(self, paths: Sequence[str], size: int = 224,
                     n_threads: int = 0, fast: bool = False,
                     out: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Image files on the thread pool: (uint8 [N, size, size, 3], int32
        status [N]); rows with status ≠ 0 failed (and may hold partial
        writes).  ``out``: a C-contiguous uint8 [N, size, size, 3] to
        decode into (the pipeline's batch buffer)."""
        n = len(paths)
        if out is None:
            out = np.empty((n, size, size, 3), dtype=np.uint8)
        elif (out.shape != (n, size, size, 3) or out.dtype != np.uint8
                or not out.flags.c_contiguous):
            raise ValueError(f"out must be C-contiguous uint8 "
                             f"[{n}, {size}, {size}, 3]")
        status = np.zeros((n,), dtype=np.int32)
        # fsencode: surrogateescape filenames (as os.listdir yields them)
        # reach the decoder as their on-disk bytes
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        self.lib.mcm_decode_batch(
            arr, n, size, _u8p(out), n_threads or default_decode_threads(),
            int(fast), status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return out, status


def load_decoder(candidates: Optional[Sequence[str]] = None,
                 build_dir: str = BUILD_DIR) -> Decoder:
    """Find a libjpeg (:func:`find_libjpeg` over ``candidates``), build the
    decoder against it unless ``build_dir`` already holds this host's
    current build, load it and run the self-test.  Raises
    :class:`NativeUnavailable` with the reason."""
    libjpeg = find_libjpeg(candidates)
    if libjpeg is None:
        searched = (candidates if candidates is not None
                    else ["the system's libjpeg.so.62",
                          "Pillow's pillow.libs/libjpeg-*.so.62*"])
        raise NativeUnavailable(f"no ABI-62 libjpeg found "
                                f"(searched {', '.join(searched)})")
    path = library_path(libjpeg, build_dir)
    if not os.path.exists(path):
        build(libjpeg, build_dir)
    try:
        decoder = Decoder(path, libjpeg)
    except OSError:
        # a corrupt cache (a truncated file) is healed by building again,
        # never by unlinking: a transient dlopen failure in this process
        # must not delete a library other processes load
        build(libjpeg, build_dir)
        try:
            decoder = Decoder(path, libjpeg)
        except OSError as e:
            raise NativeUnavailable(f"load failed: {e}") from e
    decoder.self_test()
    return decoder


# -- the process's default decoder ------------------------------------------

_lock = threading.Lock()
_default: Dict[str, object] = {}   # "decoder" or "reason", once tried


def _decoder() -> Optional[Decoder]:
    """The process's decoder, loaded on first use; None when the route is
    disabled or unavailable."""
    if os.environ.get(DISABLE_ENV):
        return None
    with _lock:
        if not _default:
            try:
                _default["decoder"] = load_decoder(build_dir=BUILD_DIR)
            except NativeUnavailable as e:
                _default["reason"] = str(e)
        return _default.get("decoder")


def native_info() -> Dict[str, object]:
    """The decode route: ``{"available", "libjpeg", "reason"}`` (the
    libjpeg linked when available, why not otherwise)."""
    if os.environ.get(DISABLE_ENV):
        return {"available": False, "libjpeg": None,
                "reason": f"{DISABLE_ENV} is set"}
    dec = _decoder()
    if dec is None:
        return {"available": False, "libjpeg": None,
                "reason": _default.get("reason")}
    return {"available": True, "libjpeg": dec.libjpeg, "reason": None}


def native_available() -> bool:
    return _decoder() is not None


def default_decode_threads() -> int:
    """Decode-pool width when the caller doesn't pin one, shared by the
    file and memory batch entry points and ``DataPipeline``."""
    return min(32, os.cpu_count() or 4)


def decode_one(path: str, size: int = 224,
               fast: bool = False) -> Optional[np.ndarray]:
    """uint8 [size, size, 3] or None if the native path can't decode it."""
    dec = _decoder()
    return None if dec is None else dec.decode_one(path, size, fast)


def decode_one_mem(data: bytes, size: int = 224,
                   fast: bool = False) -> Optional[np.ndarray]:
    """Decode one in-memory JPEG (serving request body) → uint8
    [size, size, 3], or None if the native path can't decode it (the
    caller falls back to PIL, which also covers non-JPEG formats)."""
    dec = _decoder()
    return None if dec is None else dec.decode_one_mem(data, size, fast)


def decode_mem_batch(datas: Sequence[bytes], size: int = 224,
                     n_threads: int = 0, fast: bool = False
                     ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Threaded in-memory decode (serving bulk requests): (uint8 [N, size,
    size, 3], status [N]); status ≠ 0 rows failed and must be re-decoded by
    the PIL fallback.  (None, None) when the native route is unavailable."""
    dec = _decoder()
    if dec is None:
        return None, None
    return dec.decode_mem_batch(datas, size, n_threads, fast)


def decode_batch(paths: Sequence[str], size: int = 224,
                 n_threads: int = 0, fast: bool = False,
                 out: Optional[np.ndarray] = None
                 ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(uint8 [N, size, size, 3], status [N]); status ≠ 0 rows failed and
    must be re-decoded by the fallback.  (None, None) when unavailable.
    ``out``: an optional preallocated C-contiguous uint8 [N, size, size, 3]
    decode target (the pipeline decodes straight into its batch buffer;
    failed rows may hold partial writes, which the fallback overwrites)."""
    dec = _decoder()
    if dec is None:
        return None, None
    return dec.decode_batch(paths, size, n_threads, fast, out)
