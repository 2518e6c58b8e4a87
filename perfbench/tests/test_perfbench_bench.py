"""The benchmark's files against its contract, and its arithmetic against
hand counts: names and units, the files each entry finds by name, the
imports, the roofline counts, the trace reduction, the pool and weights."""

import ast
import json
import math
import os
import re

import numpy as np
import pytest

from perfbench import modelcfg, pool, roofline, spec, tracing, weights

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HARNESS)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == []
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_name_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = spec.load(os.path.join(REPO, "BENCHMARK.json"), w["name"])
        assert os.path.isfile(cell.config_file)
        assert os.path.isfile(cell.harness_path(
            "drivers", cell.traffic["driver"] + ".py"))
        assert "limits" in cell.params
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert callable(cell.module("metrics", m["name"]).read)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(HARNESS):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        found = set(_imports(path)) & {"jax", "jaxlib", "flax", "mcm_tpu"}
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(HARNESS, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            assert "mcm_tpu_torch" not in set(_imports(
                os.path.join(ref_dir, f))), f


def _dims(name):
    return modelcfg.dims(modelcfg.load(os.path.join(HARNESS, "configs",
                                                    name + ".json")))


def test_flops_per_image_by_hand():
    # ViT-B/16: S = 197, D = 768, 12 layers, MLP 3072, E = 512, C = 1000
    s, d, m = 197, 768, 3072
    layer = 8 * s * d * d + 4 * s * s * d + 4 * s * d * m
    b16 = 2 * 196 * 768 * d + 12 * layer + 2 * d * 512 + 2 * 512 * 1000
    assert roofline.vit_flops_per_image(_dims("clip-vit-b16"), 1000) == b16
    assert b16 == pytest.approx(35.13e9, rel=1e-3)
    assert roofline.vit_flops_per_image(_dims("clip-vit-l14"), 1000) == \
        pytest.approx(162.03e9, rel=1e-3)


def test_kernel_bounds_by_hand():
    # bsd at B = 512: q, k, v, o of 512·197·768 bf16 over 3.35 TB/s
    assert roofline.bsd_attention_bound_s(512, 197, 768) == pytest.approx(
        4 * 512 * 197 * 768 * 2 / 3.35e12)
    assert roofline.bsd_attention_bound_s(512, 197, 768) == pytest.approx(
        184.96e-6, rel=1e-3)
    assert roofline.bsd_attention_bound_s(512, 257, 1024) == pytest.approx(
        321.7e-6, rel=1e-3)
    # one L = 1 row at S = 600: the operations bound it
    assert roofline.bsd_attention_bound_s(1, 600, 64) == pytest.approx(
        4 * 600 * 600 * 64 / 989e12)
    # the MCM score at B = 512, C = 1000: operations at the fp32 peak
    assert roofline.mcm_score_bound_s(512, 1000, 512) == pytest.approx(
        2 * 512 * 1000 * 512 / 67e12)
    assert roofline.mcm_score_bound_s(512, 1000, 768) == pytest.approx(
        11.74e-6, rel=1e-3)


def test_kernel_names_of_the_trace():
    k = roofline.KERNELS
    bsd = ("void (anonymous namespace)::bsd_attention_mma_kernel<64, 0>("
           "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*,"
           " __nv_bfloat16*, int, int, long long, long long, float, bool)")
    logits = ("(anonymous namespace)::logits_kernel(float const*, float "
              "const*, float*, int, int, int)")
    ours = "(anonymous namespace)::reduce_kernel(float const*, float*, int, float)"
    torch_reduce = ("void at::native::reduce_kernel<512, 1, at::native::"
                    "ReduceOp<float, at::native::MeanOps<float, float, float, "
                    "float>, unsigned int, float, 4, 4> >(at::native::"
                    "ReduceOp<float, at::native::MeanOps<float, float, float,"
                    " float>, unsigned int, float, 4, 4>)")
    assert k["bsd_attention"]["match"].search(bsd)
    assert k["mcm_score"]["match"].search(logits)
    assert k["mcm_score"]["match"].search(ours)
    assert not k["mcm_score"]["match"].search(torch_reduce)
    assert not k["mcm_score"]["calls"].search(ours)
    secs = {logits: 3.0, ours: 1.0, torch_reduce: 50.0, bsd: 24.0}
    counts = {logits: 2, ours: 2, torch_reduce: 9, bsd: 12}
    assert roofline.mean_call_s(secs, counts, "mcm_score") == 2.0
    assert roofline.mean_call_s(secs, counts, "bsd_attention") == 2.0
    assert roofline.mean_call_s({}, {}, "bsd_attention") is None


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        _ev(tracing.WINDOW_SPAN, "user_annotation", 0, 1000),
        _ev("perfbench.runner.score_dataset", "user_annotation", 0, 1000),
        _ev("k1", "kernel", 100, 200),        # 100-300
        _ev("k2", "kernel", 250, 100),        # 250-350, overlaps k1
        _ev("Memcpy HtoD", "gpu_memcpy", 600, 50),
        _ev("k1", "kernel", 950, 100),        # clipped at the window's end
        _ev("aten::copy_", "cpu_op", 400, 100),
        _ev("k0", "kernel", -50, 40),         # before the window
    ]
    t = tracing.Trace(events)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx((250 + 50 + 50) * 1e-6)
    assert t.kernel_only_s == pytest.approx((200 + 100 + 50) * 1e-6)
    assert t.kernel_counts == {"k1": 2, "k2": 1, "Memcpy HtoD": 1}
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(250e-6)]
    gaps = dict((round(s * 1e6), n) for n, s in b["idle_gaps"])
    assert gaps[250] == "aten::copy_"                   # 350-600
    assert gaps[100] == "perfbench.runner.score_dataset: no op (Python)"
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(
        t.window_s - t.busy_s)


def test_pool_has_the_same_files_on_every_seed():
    with open(os.path.join(HARNESS, "traffic", "offline-jpeg.json")) as f:
        mix = json.load(f)["pool"]
    a, b = pool.pool_plan(mix, 7), pool.pool_plan(mix, 2**31 + 5)
    key = lambda p: sorted((x["w"], x["h"], x["quality"], x["gray"])  # noqa: E731
                           for x in p)
    assert key(a) == key(b) and a != b
    assert pool.pool_plan(mix, 7) == a
    assert len(a) == mix["count"]
    assert sum(x["gray"] for x in a) == round(mix["gray_share"] * mix["count"])


def test_weights_are_the_seeds_and_served_in_bf16():
    import torch
    d = _dims("clip-vit-b16")
    d["vision"].update(width=64, layers=1, heads=2, mlp=256)
    d["text"].update(width=64, layers=1, heads=2, mlp=256, vocab_size=100)
    d["embed_dim"] = 32
    a = weights.make_weights(d, 3, "cpu")
    b = weights.make_weights(d, 3, "cpu")
    c = weights.make_weights(d, 4, "cpu")
    w = a["vision"]["layers"]["attn"]["wq"]
    assert np.array_equal(w, b["vision"]["layers"]["attn"]["wq"])
    assert not np.array_equal(w, c["vision"]["layers"]["attn"]["wq"])
    t = torch.from_numpy(w)
    assert torch.equal(t.to(torch.bfloat16).float(), t)
    assert w.shape == (1, 64, 64)
    assert abs(float(w.std()) - 64 ** -0.5) < 0.02
    scale = a["vision"]["layers"]["ln1"]["scale"]
    assert math.isclose(float(scale.mean()), 1.0, abs_tol=0.05)
    assert a["text"]["token_emb"].shape == (100, 64)



def test_arrivals_fixed_by_the_rate():
    from perfbench.drivers.serve_open import schedule
    a, b = schedule(150, 30, 2048, 1, 5), schedule(150, 30, 2048, 2**31, 5)
    assert len(a) == len(b) == 4500 and a != b
    assert all(0 <= o < 30 for o, _ in a) and a == sorted(a)
