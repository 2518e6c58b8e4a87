"""The port's native decoder (``mcm_tpu_torch.runtime.native``) against the
JAX package's (``mcm_tpu.runtime.native``) on the CPU: bit-equal pixels
and equal statuses for ``decode_one``, ``decode_batch`` (into ``out=``),
``decode_one_mem`` and ``decode_mem_batch``, in exact and fast mode, on
seeded JPEGs (4:4:4, 4:2:2 and 4:2:0 subsampling, quality 60-95, 80x100
to 1200x900, grayscale) and on the failure cases of ``tests/test_native.py``
(truncated, PNG, extraneous data, declared-pixels bomb, crop rounding);
a hypothesis case over random geometries, after ``tests/test_native_fuzz.py``.

The route the card host takes is built here too: through
:func:`find_libjpeg` with Pillow's bundled libjpeg as the only candidate,
into a temporary directory, held bit-equal to the JAX package's decoder.
Also: the libjpeg search order, the cache key's host tag, the atomic
publish under concurrent builds, ``MCM_TPU_DISABLE_NATIVE``, and the
load-time self-test refusing a wrong library (a stand-in libjpeg that
fails struct-size checking, and one that decodes wrong pixels)."""

import io
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from mcm_tpu.runtime import native as jnative
from mcm_tpu_torch.runtime import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNTIME = os.path.join(REPO, "mcm_tpu_torch", "runtime")

# (h, w, subsampling (0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0), quality)
SHAPES = [(256, 256, 2, 75), (375, 500, 2, 87), (300, 400, 0, 95),
          (400, 300, 1, 60), (900, 1200, 1, 80), (80, 100, 0, 92),
          (446, 336, 2, 95)]


def _natural(rng, h, w):
    """Smooth content with noise, as a photo has (upsampled noise)."""
    base = rng.integers(0, 256, size=(max(2, h // 12), max(2, w // 12), 3),
                        dtype=np.uint8)
    arr = np.asarray(Image.fromarray(base).resize((w, h), Image.BICUBIC),
                     np.int16)
    arr = arr + rng.integers(-12, 12, size=arr.shape)
    return np.clip(arr, 0, 255).astype(np.uint8)


def _jpeg_bytes(arr, quality=90, subsampling=-1, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", quality=quality,
                                    subsampling=subsampling)
    return buf.getvalue()


@pytest.fixture(scope="module")
def decoders():
    """Both packages' default decoders, built here (g++ and a libjpeg)."""
    if not jnative.native_available():
        pytest.skip("the JAX package's native decoder does not build here")
    info = native.native_info()
    assert info["available"], info["reason"]
    return jnative, native


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_native_jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w, sub, q) in enumerate(SHAPES):
        p = tmp / f"img{i}_{h}x{w}_s{sub}_q{q}.jpg"
        p.write_bytes(_jpeg_bytes(_natural(rng, h, w), q, sub))
        paths.append(str(p))
    gray = tmp / "gray.jpg"
    gray.write_bytes(_jpeg_bytes(
        (np.mgrid[0:50, 0:70][0] % 256).astype(np.uint8), mode="L"))
    paths.append(str(gray))
    return paths


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_decode_one_bit_equal_to_jax(decoders, jpegs, fast):
    j, t = decoders
    for p in jpegs:
        want = j.decode_one(p, 224, fast=fast)
        got = t.decode_one(p, 224, fast=fast)
        assert want is not None, p
        np.testing.assert_array_equal(got, want, err_msg=p)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_decode_batch_into_out_bit_equal_to_jax(decoders, jpegs, fast):
    j, t = decoders
    want, want_status = j.decode_batch(jpegs, 160, n_threads=3, fast=fast)
    buf = np.empty((len(jpegs), 160, 160, 3), np.uint8)
    out, status = t.decode_batch(jpegs, 160, n_threads=3, fast=fast, out=buf)
    assert out is buf
    np.testing.assert_array_equal(status, want_status)
    assert not status.any()
    np.testing.assert_array_equal(buf, want)
    with pytest.raises(ValueError, match="C-contiguous"):
        t.decode_batch(jpegs, 160, out=buf[:, ::2])
    with pytest.raises(ValueError, match="C-contiguous"):
        t.decode_batch(jpegs, 160, out=buf[1:])


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_decode_one_mem_bit_equal_to_jax(decoders, jpegs, fast):
    j, t = decoders
    for p in jpegs:
        data = _read(p)
        want = j.decode_one_mem(data, 224, fast=fast)
        np.testing.assert_array_equal(t.decode_one_mem(data, 224, fast=fast),
                                      want, err_msg=p)
        # and equal to the file decode
        np.testing.assert_array_equal(t.decode_one(p, 224, fast=fast), want)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_decode_mem_batch_bit_equal_to_jax(decoders, jpegs, fast):
    j, t = decoders
    datas = [_read(p) for p in jpegs]
    want, want_status = j.decode_mem_batch(datas, 200, n_threads=4, fast=fast)
    got, status = t.decode_mem_batch(datas, 200, n_threads=4, fast=fast)
    np.testing.assert_array_equal(status, want_status)
    np.testing.assert_array_equal(got, want)


def _patch_sof_dims(data: bytes, h: int, w: int) -> bytes:
    """Rewrite the SOF0/SOF2 declared dimensions of a baseline JPEG."""
    i = 2
    while i < len(data) - 1:
        assert data[i] == 0xFF, "marker stream desync"
        marker = data[i + 1]
        seg_len = int.from_bytes(data[i + 2:i + 4], "big")
        if marker in (0xC0, 0xC2):
            return (data[:i + 5] + h.to_bytes(2, "big")
                    + w.to_bytes(2, "big") + data[i + 9:])
        i += 2 + seg_len
    raise AssertionError("no SOF marker found")


def _failure_case(name, tmp_path):
    """(path, bytes) of one of ``tests/test_native.py``'s cases."""
    rng = np.random.default_rng(0)
    good = _jpeg_bytes(rng.integers(0, 255, (96, 128, 3), dtype=np.uint8))
    if name == "truncated":
        data = good[:len(good) // 2]
    elif name == "png":
        buf = io.BytesIO()
        Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(buf, "PNG")
        data = buf.getvalue()
    elif name == "extraneous":
        data = good[:-2] + bytes([1, 2, 3, 4] * 8) + b"\xff\xd9"
    elif name == "bomb":
        data = _patch_sof_dims(good, 60000, 60000)
    elif name == "crop_rounding":   # 336x446 → 224x297: offset 36.5
        yy, xx = np.mgrid[0:446, 0:336]
        data = _jpeg_bytes(np.stack([yy % 256, xx % 256, (yy + xx) % 256],
                                    -1).astype(np.uint8), 95)
    elif name == "empty":
        data = b""
    else:
        raise ValueError(name)
    p = tmp_path / f"{name}.jpg"
    p.write_bytes(data)
    return str(p), data


# the JAX package's verdict on each case (tests/test_native.py)
FAILURE_CASES = {"truncated": False, "png": False, "extraneous": True,
                 "bomb": False, "crop_rounding": True, "empty": False}


@pytest.mark.parametrize("case", sorted(FAILURE_CASES))
def test_failure_statuses_match_jax(decoders, tmp_path, case):
    j, t = decoders
    path, data = _failure_case(case, tmp_path)
    missing = str(tmp_path / "missing.jpg")
    for fast in (False, True):
        want, want_status = j.decode_batch([path, missing], 224, n_threads=2,
                                           fast=fast)
        got, status = t.decode_batch([path, missing], 224, n_threads=2,
                                     fast=fast)
        np.testing.assert_array_equal(status, want_status)
        assert (status[0] == 0) == FAILURE_CASES[case] and status[1] != 0
        if status[0] == 0:
            np.testing.assert_array_equal(got[0], want[0])
        mwant, mws = j.decode_mem_batch([data], 224, n_threads=1, fast=fast)
        mgot, ms = t.decode_mem_batch([data], 224, n_threads=1, fast=fast)
        np.testing.assert_array_equal(ms, mws)
        if ms[0] == 0:
            np.testing.assert_array_equal(mgot, mwant)
        assert ((t.decode_one_mem(data, 224, fast=fast) is None)
                == (j.decode_one_mem(data, 224, fast=fast) is None))


@settings(max_examples=20, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(h=st.integers(8, 1200), w=st.integers(8, 1200),
       quality=st.integers(60, 95), subsampling=st.sampled_from([0, 1, 2]),
       size=st.sampled_from([64, 224]), seed=st.integers(0, 2 ** 16))
def test_random_geometries_bit_equal_to_jax(decoders, h, w, quality,
                                            subsampling, size, seed):
    """Upscales, near-target sizes, extreme aspect ratios and odd sides:
    bit-equal to the JAX package's decoder in both modes, and within the
    ±2 LSB of PIL that ``tests/test_native_fuzz.py`` holds JAX's to."""
    from mcm_tpu_torch.data.transforms import preprocess_uint8
    j, t = decoders
    rng = np.random.default_rng(seed)
    data = _jpeg_bytes(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8),
                       quality, subsampling)
    for fast in (False, True):
        want = j.decode_one_mem(data, size, fast=fast)
        got = t.decode_one_mem(data, size, fast=fast)
        assert want is not None and got is not None, (h, w)
        np.testing.assert_array_equal(got, want)
    with Image.open(io.BytesIO(data)) as img:
        ref = preprocess_uint8(img, size).astype(np.int32)
    diff = np.abs(ref - t.decode_one_mem(data, size).astype(np.int32))
    assert diff.max() <= 2 and diff.mean() < 0.5, (h, w, diff.max())


# -- the card host's route: Pillow's bundled libjpeg -----------------------------

@pytest.fixture(scope="module")
def pillow_decoder(tmp_path_factory, decoders):
    cands = native.pillow_libjpeg_candidates()
    if not cands:
        pytest.skip("this Pillow bundles no libjpeg (a distribution build)")
    build_dir = tmp_path_factory.mktemp("pillow_route")
    return native.load_decoder(candidates=cands[:1],
                               build_dir=str(build_dir))


def test_pillow_route_links_pillows_libjpeg(pillow_decoder):
    """The library loads Pillow's copy alone, from its absolute rpath, in
    a fresh process that imports neither PIL nor the system libjpeg."""
    dec = pillow_decoder
    assert "pillow.libs" in dec.libjpeg
    assert os.path.dirname(dec.path) != RUNTIME
    code = ("import ctypes, sys; ctypes.CDLL(sys.argv[1]); "
            "print(open('/proc/self/maps').read())")
    maps = subprocess.run([sys.executable, "-c", code, dec.path],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout
    loaded = {line.split()[-1] for line in maps.splitlines()
              if "libjpeg" in line}
    assert loaded == {os.path.realpath(dec.libjpeg)}, loaded


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_pillow_route_bit_equal_to_jax(decoders, pillow_decoder, jpegs,
                                       tmp_path, fast):
    j, _ = decoders
    dec = pillow_decoder
    want, want_status = j.decode_batch(jpegs, 224, n_threads=3, fast=fast)
    got, status = dec.decode_batch(jpegs, 224, n_threads=3, fast=fast)
    np.testing.assert_array_equal(status, want_status)
    np.testing.assert_array_equal(got, want)
    datas = [_read(p) for p in jpegs]
    mwant, _ = j.decode_mem_batch(datas, 224, n_threads=3, fast=fast)
    mgot, _ = dec.decode_mem_batch(datas, 224, n_threads=3, fast=fast)
    np.testing.assert_array_equal(mgot, mwant)
    for case, ok in FAILURE_CASES.items():
        path, data = _failure_case(case, tmp_path)
        assert (dec.decode_one(path, 224, fast=fast) is not None) == ok, case
        assert (j.decode_one(path, 224, fast=fast) is not None) == ok, case
        if ok:
            np.testing.assert_array_equal(dec.decode_one_mem(data, 224, fast),
                                          j.decode_one_mem(data, 224, fast))


# -- the libjpeg search, the cache key, the build -------------------------------

def test_find_libjpeg_order(tmp_path):
    a, b = tmp_path / "libjpeg.so.62", tmp_path / "libjpeg-x.so.62.4.0"
    b.write_bytes(b"")
    assert native.find_libjpeg([str(a), str(b)]) == str(b)
    a.write_bytes(b"")
    assert native.find_libjpeg([str(a), str(b)]) == str(a)
    assert native.find_libjpeg([]) is None
    with pytest.raises(native.NativeUnavailable, match="no ABI-62 libjpeg"):
        native.load_decoder(candidates=[str(tmp_path / "nothing.so.62")],
                            build_dir=str(tmp_path / "build"))
    # the default: the system's libjpeg.so.62 first, Pillow's copy after
    default = [p for p in native.system_libjpeg_candidates()
               + native.pillow_libjpeg_candidates() if os.path.isfile(p)]
    assert native.find_libjpeg() == (os.path.abspath(default[0]) if default
                                     else None)
    assert all("pillow.libs" in p and ".so.62" in p
               for p in native.pillow_libjpeg_candidates())


def test_default_build_lives_in_the_build_dir(decoders):
    """The default decoder is built under build/mcm_tpu_torch/, keyed by
    the host, the libjpeg and the source; nothing is written beside the
    source."""
    info = native.native_info()
    path = native.library_path(info["libjpeg"])
    assert os.path.dirname(path) == os.path.join(REPO, "build",
                                                 "mcm_tpu_torch")
    assert os.path.exists(path)
    assert not [f for f in os.listdir(RUNTIME) if ".so" in f]


def test_host_tag_staleness(decoders, tmp_path, monkeypatch):
    """A library built on another CPU (another host tag) is not reused:
    the key names a new library, built beside the old one."""
    libjpeg = native.native_info()["libjpeg"]
    build_dir = str(tmp_path)
    first = native.load_decoder([libjpeg], build_dir)
    assert first.path == native.library_path(libjpeg, build_dir)
    monkeypatch.setattr(native, "_host_tag", lambda: "othermachine:deadbeef")
    stale_key = native.library_path(libjpeg, build_dir)
    assert stale_key != first.path and not os.path.exists(stale_key)
    second = native.load_decoder([libjpeg], build_dir)
    assert second.path == stale_key and os.path.exists(first.path)
    # and the libjpeg's path is part of the key
    monkeypatch.undo()
    other = tmp_path / "libjpeg.so.62"
    other.write_bytes(b"")
    assert native.library_path(str(other), build_dir) != first.path


def test_concurrent_builds_publish_one_whole_library(decoders, tmp_path):
    libjpeg = native.native_info()["libjpeg"]
    with ThreadPoolExecutor(3) as pool:
        paths = list(pool.map(lambda _: native.build(libjpeg, str(tmp_path)),
                              range(3)))
    assert len(set(paths)) == 1
    assert os.listdir(tmp_path) == [os.path.basename(paths[0])]
    native.Decoder(paths[0], libjpeg).self_test()


def test_build_failure_is_a_reason(tmp_path):
    """Linking against something that is not a library fails the build,
    which surfaces as the reason, with no file left behind."""
    fake = tmp_path / "libjpeg.so.62"
    fake.write_bytes(b"not an ELF file")
    with pytest.raises(native.NativeUnavailable, match="build failed"):
        native.load_decoder([str(fake)], str(tmp_path / "build"))
    assert os.listdir(tmp_path / "build") == []


def test_disable_native_env(decoders, jpegs, monkeypatch):
    monkeypatch.setenv("MCM_TPU_DISABLE_NATIVE", "1")
    info = native.native_info()
    assert not info["available"] and "MCM_TPU_DISABLE_NATIVE" in info["reason"]
    assert not native.native_available()
    assert native.decode_one(jpegs[0]) is None
    assert native.decode_one_mem(_read(jpegs[0])) is None
    assert native.decode_batch(jpegs) == (None, None)
    assert native.decode_mem_batch([_read(jpegs[0])]) == (None, None)
    monkeypatch.delenv("MCM_TPU_DISABLE_NATIVE")
    assert native.native_info()["available"]


def test_selftest_pixels_are_libjpegs(decoders):
    """The stored self-test pixels are what PIL's libjpeg decodes from the
    embedded JPEG (4:4:4, decoded at its own size: no resample)."""
    with Image.open(io.BytesIO(native._SELFTEST_JPEG)) as img:
        assert img.size == (native._SELFTEST_SIZE,) * 2
        ref = np.asarray(img.convert("RGB"))
    assert ref.tobytes() == native._SELFTEST_PIXELS
    assert native.decode_one_mem(native._SELFTEST_JPEG,
                                 native._SELFTEST_SIZE).tobytes() == \
        native._SELFTEST_PIXELS


# A stand-in libjpeg with the ABI-62 entry points: BAD_STRUCT makes
# jpeg_CreateDecompress fail as a struct-size mismatch does; otherwise it
# "decodes" an 8x8 image of flat grey, as a wrong struct layout could.
_SHIM = r"""
#include <stdio.h>
#include <string.h>
#include <jpeglib.h>
#include <jerror.h>

struct jpeg_error_mgr *jpeg_std_error(struct jpeg_error_mgr *err) {
  memset(err, 0, sizeof(*err));
  return err;
}
void jpeg_CreateDecompress(j_decompress_ptr cinfo, int version,
                           size_t structsize) {
  struct jpeg_error_mgr *err = cinfo->err;
#ifdef BAD_STRUCT
  err->msg_code = JERR_BAD_STRUCT_SIZE;
  err->error_exit((j_common_ptr)cinfo);
#else
  memset(cinfo, 0, structsize);
  cinfo->err = err;
#endif
}
void jpeg_destroy_decompress(j_decompress_ptr cinfo) {}
void jpeg_stdio_src(j_decompress_ptr cinfo, FILE *f) {}
void jpeg_mem_src(j_decompress_ptr cinfo, const unsigned char *b,
                  unsigned long n) {}
int jpeg_read_header(j_decompress_ptr cinfo, boolean require_image) {
  cinfo->image_width = cinfo->image_height = 8;
  return JPEG_HEADER_OK;
}
boolean jpeg_start_decompress(j_decompress_ptr cinfo) {
  cinfo->output_width = cinfo->image_width;
  cinfo->output_height = cinfo->image_height;
  cinfo->output_components = 3;
  cinfo->output_scanline = 0;
  return TRUE;
}
JDIMENSION jpeg_read_scanlines(j_decompress_ptr cinfo, JSAMPARRAY rows,
                               JDIMENSION n) {
  memset(rows[0], 0x80, cinfo->output_width * 3);
  cinfo->output_scanline++;
  return 1;
}
boolean jpeg_finish_decompress(j_decompress_ptr cinfo) { return TRUE; }
"""


@pytest.mark.parametrize("flavour,match", [
    ("bad_struct", r"self-test decode failed \(status 1\)"),
    ("wrong_pixels", "self-test pixels differ")])
def test_selftest_refuses_a_wrong_library(tmp_path, monkeypatch, flavour,
                                          match):
    src = tmp_path / "shim.c"
    src.write_text(_SHIM)
    # a soname of its own: the loader must not take an already loaded
    # libjpeg.so.62 for it
    lib = tmp_path / f"libjpeg-{flavour}.so.62"
    cmd = ["gcc", "-shared", "-fPIC", f"-I{native._INCLUDE}", str(src),
           "-o", str(lib), f"-Wl,-soname,{lib.name}"]
    if flavour == "bad_struct":
        cmd.insert(1, "-DBAD_STRUCT")
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except FileNotFoundError:
        pytest.skip("no gcc")
    with pytest.raises(native.NativeUnavailable, match=match):
        native.load_decoder([str(lib)], str(tmp_path / "build"))
    # as the process's default route: unavailable, with that reason
    monkeypatch.delenv("MCM_TPU_DISABLE_NATIVE", raising=False)
    monkeypatch.setattr(native, "_default", {})
    monkeypatch.setattr(native, "system_libjpeg_candidates", lambda: [])
    monkeypatch.setattr(native, "pillow_libjpeg_candidates",
                        lambda: [str(lib)])
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    info = native.native_info()
    assert not info["available"] and info["libjpeg"] is None
    assert "self-test" in info["reason"], info
    assert native.decode_one_mem(native._SELFTEST_JPEG, 8) is None
