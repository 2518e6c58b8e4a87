"""A tiny benchmark beside a copy of the harness, for CPU runs of every
cell's path: the ViT-B/16 test double's sizes (2 layers, width 128; the
program's ``MCM_TPU_TEST_TINY_B16``), a pool of 48 JPEGs and batches of 16.
Every file is new and made here, as a later change would add a cell."""

import copy
import json
import os
import shutil
import tempfile

import pytest

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HARNESS)

TINY_CONFIG = {
    "name": "tiny-b16", "source": "test double", "program_name": "ViT-B/16",
    "precision": "fast", "torch_dtype": "bfloat16", "projection_dim": 64,
    "vision_config": {"hidden_size": 128, "intermediate_size": 512,
                      "num_hidden_layers": 2, "num_attention_heads": 4,
                      "patch_size": 16, "image_size": 224, "num_channels": 3,
                      "layer_norm_eps": 1e-05, "hidden_act": "quick_gelu"},
    "text_config": {"hidden_size": 128, "intermediate_size": 512,
                    "num_hidden_layers": 2, "num_attention_heads": 4,
                    "max_position_embeddings": 77, "vocab_size": 49408,
                    "layer_norm_eps": 1e-05, "hidden_act": "quick_gelu"},
    "reference": "perfbench/reference/clip.py",
}


def _bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A checkout-shaped directory: a copy of the harness, a tiny config,
    two tiny traffic mixes and two tiny cells (offline, and the serving
    cell with its metrics, which ``BENCHMARK.json`` does not hold yet), in
    a BENCHMARK.json of its own.  Returns (root, bench dict)."""
    root = tmp_path / "root"
    shutil.copytree(HARNESS, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "perfbench" / "configs" / "tiny-b16.json").write_text(
        json.dumps(TINY_CONFIG))
    for name in ("offline-jpeg", "serve-open"):
        with open(os.path.join(HARNESS, "traffic", name + ".json")) as f:
            mix = json.load(f)
        mix["pool"]["count"] = 48
        if "batch_size" in mix:
            mix["batch_size"] = 16
        if "warmup_s" in mix:
            mix["warmup_s"], mix["grace_s"] = 0.5, 20.0
        (root / "perfbench" / "traffic" / f"tiny-{name}.json").write_text(
            json.dumps(mix))
    bench = _bench()
    bench["configs"].append({"name": "tiny-b16", "source": "test double",
                             "file": "perfbench/configs/tiny-b16.json",
                             "reduced": [], "why": "CPU runs"})
    for cell, traffic in (("tiny.offline", "tiny-offline-jpeg"),
                          ("tiny.serve", "tiny-serve-open")):
        bench["workloads"].append({"name": cell, "config": "tiny-b16",
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU runs"})
    # both tiny cells are held to the limits of the B/16 offline cell: the
    # same configuration, pool and control
    with open(os.path.join(HARNESS, "workloads",
                           "clip-b16.offline-jpeg.json")) as f:
        params = json.load(f)
    (root / "perfbench" / "workloads" / "tiny.offline.json").write_text(
        json.dumps(dict(params, nominal_images_per_s=48)))
    (root / "perfbench" / "workloads" / "tiny.serve.json").write_text(
        json.dumps({"rate_rps": 40.0,
                    "limits": dict(params["limits"], missing=0)}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "clip-b16.offline-jpeg" in m.get("workloads", ()):
            m["workloads"].append("tiny.offline")
    # the serving cell's entries, as a later change adds them
    bench["end_to_end"] += [
        {"name": n, "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["tiny.serve"]}
        for n in ("request_p95_ms", "request_p50_ms")]
    bench["per_layer"] += [
        {"name": "device.idle_pct.serve", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "request_p95_ms", "workloads": ["tiny.serve"]},
        {"name": "batcher.images_per_batch", "unit": "img/batch",
         "better": "higher", "source": "program_counter", "layer": "batcher",
         "moves": "request_p95_ms", "workloads": ["tiny.serve"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setenv("MCM_TPU_TEST_TINY_B16", "1")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return str(root), copy.deepcopy(bench)
