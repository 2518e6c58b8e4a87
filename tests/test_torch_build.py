"""The kernel build's library names (``mcm_tpu_torch/ops/_build.py``) on
the CPU, no ``nvcc`` needed: a library is named by its source, every
``csrc`` header the source includes and the flags, so an edited header
rebuilds every library that includes it and no other.  Every source's
exported functions get their ctypes argument and result types."""

import ctypes
import os
import shutil
import types

import pytest

from mcm_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc`` that the build module reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    return copy


def test_every_source_is_in_the_tree():
    for name in _build.SOURCES:
        for rel in _build._inputs(name):
            assert os.path.exists(os.path.join(_build.CSRC_DIR, rel)), rel


def test_inputs_follow_includes_through_headers():
    assert _build._inputs("bsd_attention") == [
        "bsd_attention.cu", "bsd_attention.cuh", "attention_common.cuh",
        "attention_mma.cuh"]
    assert _build._inputs("bsd_probe") == [
        "bsd_probe.cu", "bsd_attention.cuh", "attention_common.cuh",
        "attention_mma.cuh"]
    assert _build._inputs("split_attention") == [
        "split_attention.cu", "attention_common.cuh", "attention_mma.cuh"]
    assert _build._inputs("flash_attention") == [
        "flash_attention.cu", "attention_common.cuh", "attention_mma.cuh"]
    assert _build._inputs("mcm_score") == ["mcm_score.cu"]
    assert _build._inputs("fused_mlp") == ["fused_mlp.cu"]
    assert _build._inputs("dense_epilogue") == ["dense_epilogue.cu"]
    assert _build._inputs("layer_norm") == ["layer_norm.cu"]


@pytest.mark.parametrize("header,changed", [
    ("bsd_attention.cuh", {"bsd_attention", "bsd_probe"}),
    ("attention_common.cuh", {"bsd_attention", "bsd_probe",
                              "split_attention", "flash_attention"}),
    ("attention_mma.cuh", {"bsd_attention", "bsd_probe", "split_attention",
                           "flash_attention"}),
])
def test_header_edit_changes_the_library_name(csrc, header, changed):
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert {n for n in _build.SOURCES if before[n] != after[n]} == changed
    assert all(p.startswith(_build.BUILD_DIR) for p in after.values())


def test_source_edit_changes_only_its_library(csrc):
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    with open(csrc / "flash_attention.cu", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert {n for n in _build.SOURCES if before[n] != after[n]} == {
        "flash_attention"}


class _Lib:
    """Stands in for a loaded library: each attribute read is a function
    object that ``_declare`` sets types on."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, types.SimpleNamespace())


@pytest.mark.parametrize("name", _build.SOURCES)
def test_declare_types_every_source(name):
    lib = _Lib()
    _build._declare(name, lib)
    errors = [f for f in lib.fns if f.endswith("_error_string")]
    assert len(errors) == 1
    assert lib.fns[errors[0]].restype is ctypes.c_char_p
    assert len(lib.fns) >= 2
    for fn in lib.fns.values():
        assert fn.restype is not None
        assert all(t in (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float) for t in fn.argtypes)


def test_declare_dense_epilogue_passes_pointers_and_64_bit_sizes():
    lib = _Lib()
    _build._declare("dense_epilogue", lib)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    assert lib.fns["mcm_dense_epilogue"].argtypes == [p, p, p, p, ll, ll, i, p]
    assert lib.fns["mcm_dense_epilogue"].restype is i


def test_declare_layer_norm_passes_64_bit_sizes_and_fp32_scalars():
    lib = _Lib()
    _build._declare("layer_norm", lib)
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    assert lib.fns["mcm_layer_norm"].argtypes == [p, ll, p, p, p, ll, i, f, f,
                                                  p]
    assert lib.fns["mcm_layer_norm"].restype is i


def test_declare_refuses_an_unknown_source():
    with pytest.raises(ValueError, match="unknown kernel source"):
        _build._declare("nope", _Lib())
