"""The kernel build's library names (``mcm_tpu_torch/ops/_build.py``) on
the CPU, no ``nvcc`` needed: a library is named by its source, every
``csrc`` header the source includes and the flags, so an edited header
rebuilds every library that includes it and no other."""

import os
import shutil

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
