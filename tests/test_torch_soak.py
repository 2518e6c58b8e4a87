"""The serving soak tools (``mcm_tpu_torch.tools.serve_soak`` and
``http_soak``) on the CPU with the tiny ViT-B/16 double
(``MCM_TPU_TEST_TINY_B16``) and their constants patched small: every phase
runs, the JSON line carries its numbers and the native decode route, and
the default device raises without a card."""

import json

import numpy as np
import pytest
import torch

from mcm_tpu_torch.tools import http_soak, serve_soak

pytestmark = pytest.mark.filterwarnings("ignore:MCM_TPU_TEST_TINY_B16")


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setenv("MCM_TPU_TEST_TINY_B16", "1")


def test_serve_soak_runs_every_phase(tiny, monkeypatch, capsys):
    for name, value in dict(BUCKETS=(1, 4), N_CLASSES=3, N_FILES=20,
                            N_SERIAL=4, N_REQUESTS=24, N_CLIENTS=6,
                            REPS=1).items():
        monkeypatch.setattr(serve_soak, name, value)
    row = serve_soak.main("cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == row
    assert row["device"] == "cpu" and row["decoder"]["available"]
    assert set(row["bucket_ms"]) == {"1", "4"}
    assert row["files"] == 20 and row["files_img_per_s"] > 0
    assert 0.90 <= row["called_id_fraction"] <= 1.0
    assert row["bucket_invariance_max_delta"] < serve_soak.BUCKET_ATOL
    assert row["batcher_images"] == 24
    assert row["batcher_batches"] < row["batcher_images"]
    assert 0 < row["concurrent_p50_ms"] <= row["concurrent_p99_ms"]
    assert np.isfinite(row["calibrated_threshold"])


def test_http_soak_runs_every_phase(tiny, monkeypatch, capsys):
    for name, value in dict(BUCKETS=(1, 4), N_CLASSES=3, SERIAL_N=4,
                            BURST_THREADS=4, BURST_PER_THREAD=3,
                            BATCH_CLIENTS=2, BATCH_SIZE=4).items():
        monkeypatch.setattr(http_soak, name, value)
    row = http_soak.main("cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == row
    assert row["device"] == "cpu" and row["decoder"]["available"]
    assert row["burst_requests"] == 12 and row["bulk_requests"] == 2
    for phase in ("serial", "burst", "bulk"):
        assert 0 < row[f"{phase}_p50_ms"] <= row[f"{phase}_p99_ms"]
    assert row["bulk_json_img_per_sec"] > 0
    assert set(row["decode"]) == {"native_ms_per_image", "pil_ms_per_image",
                                  "bulk_ms_per_image"}
    assert row["coalescing_img_per_batch"] >= 1


def test_http_soak_decode_split_without_the_native_route(monkeypatch):
    monkeypatch.setenv("MCM_TPU_DISABLE_NATIVE", "1")
    split = http_soak.decode_split(http_soak.make_jpegs(2), 224)
    assert set(split) == {"pil_ms_per_image", "bulk_ms_per_image"}


@pytest.mark.parametrize("tool", [serve_soak, http_soak],
                         ids=["serve_soak", "http_soak"])
def test_soak_tools_default_to_the_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.cli([])
