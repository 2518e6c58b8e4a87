"""The port's attention tools (``mcm_tpu_torch.tools``) on the CPU: each
bsd probe mode's plain version against ``tools/bsd_probe.py::_call`` and
the packed bsd's against ``tools/qkv_probe.py::_bsd_fused``, both in
interpret mode, and each tool's ``main`` at tiny shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tools import bsd_probe as jbsd_probe
from tools import qkv_probe as jqkv_probe

from mcm_tpu_torch.ops import attention
from mcm_tpu_torch.tools import _timing, attn_shootout, bsd_probe, qkv_probe


def _arrays(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _bf16_ulp(scale: float) -> float:
    """One bf16 ulp at the magnitude ``scale`` (8 bits of mantissa)."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", bsd_probe.MODES)
def test_probe_plain_matches_jax_tool(rng, mode, dtype):
    """Each mode at (2, 37, 256) (two lane tiles of two 64-wide heads),
    ``block_b=2``.  fp32 at 2e-5; bf16 — and ``bf16sm`` in either dtype,
    which rounds its softmax to bf16 by design — within one bf16 ulp of
    the output's largest |x| (XLA on the CPU may skip a bf16 round trip
    that the plain version takes, which moves a p by one ulp)."""
    q, k, v = _arrays(rng, (2, 37, 256))
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jbsd_probe._call(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), mode=mode,
            block_b=2).astype(jnp.float32))
    got = bsd_probe.probe_reference(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        mode)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32" and mode != "bf16sm":
        tol = 2e-5
    else:
        tol = _bf16_ulp(float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 1.6e-2)])
def test_bsd_fused_plain_matches_jax_tool(rng, dtype, tol):
    """The packed [B, S, 3D] bsd against ``_bsd_fused`` (each BlockSpec
    index map offset into its tensor's lane tiles), D = 256."""
    qkv = rng.standard_normal((2, 37, 3 * 256)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jqkv_probe._bsd_fused(
            jnp.asarray(qkv, getattr(jnp, dtype)), 256,
            block_b=2).astype(jnp.float32))
    t = torch.from_numpy(qkv).to(getattr(torch, dtype))
    before = qkv_probe.bsd_fused.launches
    got = qkv_probe.bsd_fused(t, 256, 4)
    assert qkv_probe.bsd_fused.launches == before        # CPU: plain version
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    torch.testing.assert_close(got, attention.bsd_attention_reference(
        *t.split(256, dim=-1), 4), rtol=0, atol=0)


def test_dense_matches_jax_tool(rng):
    """``_dense``: the fp32 product plus the fp32 bias, rounded once to
    bf16 (one bf16 ulp at |y| < 2 between the two summation orders)."""
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 96)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((96,)) * 0.1).astype(np.float32)
    want = np.asarray(jqkv_probe._dense(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))).astype(
            jnp.float32))
    got = qkv_probe._dense(*(torch.from_numpy(a).bfloat16() for a in (x, w, b)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_bf16_ulp(float(np.abs(want).max())))


def test_probe_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((2, 8, 128))
    with pytest.raises(ValueError, match="mode"):
        bsd_probe.probe(q, q, q, "nomode")
    with pytest.raises(ValueError, match=r"\[B, S, D\]"):
        bsd_probe.probe(q[0], q[0], q[0], "full")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bsd_probe.probe(q.half(), q.half(), q.half(), "full")
    with pytest.raises(ValueError, match="divide"):
        bsd_probe.probe(q[..., :96], q[..., :96], q[..., :96], "full")
    with pytest.raises(ValueError, match="3D"):
        qkv_probe.bsd_fused(q, 128, 2)


def test_time_chain_runs_dependent_applications(monkeypatch):
    """One warm-up chain, then OUTER chains of CHAIN applications, each
    fed the previous result."""
    monkeypatch.setattr(_timing, "CHAIN", 3)
    monkeypatch.setattr(_timing, "OUTER", 2)
    seen = []

    def step(x):
        seen.append(float(x[0]))
        return x + 1
    assert _timing.time_chain(step, torch.zeros(1)) >= 0
    assert seen == [0.0, 1.0, 2.0] * 3


def test_cli_exit_status(monkeypatch):
    ok = {"a": 1e-3}
    bad = {"a": 1e-3, "b": "FAILED: RuntimeError: x"}
    assert _timing.failed(bad) == ["b"]
    assert _timing.cli(lambda device: ok, ["--device", "cpu"]) == 0
    assert _timing.cli(lambda device: bad, ["--device", "cpu"]) == 1
    rows = {}
    _timing.measure(rows, "boom", lambda x: 1 / 0, torch.zeros(1), 1.0)
    assert rows["boom"].startswith("FAILED: ZeroDivisionError")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            bsd_probe.main()


TINY_SHAPES = {
    bsd_probe: {"B": 2, "S": 17, "D": 128, "HEADS": 2},
    qkv_probe: {"B": 2, "S": 17, "D": 128, "HEADS": 2},
    attn_shootout: {"B": 2, "H": 2, "S": 17, "S_PAD": 32},
}
ROWS = {
    bsd_probe: list(bsd_probe.MODES),
    qkv_probe: list(qkv_probe.MODES),
    attn_shootout: ["xla_bf16sm", "pallas_fullS", "pallas_mh_h6",
                    "pallas_mh_h3", "pallas_mh_h12", "pallas_batched_b8",
                    "pallas_batched_b16", "pallas_batched_b32", "flash",
                    "flash_pad256_mask", "flash_pad256_nomask",
                    "xla_S256_presized_mask", "xla_S256_presized_nomask"],
}


@pytest.mark.parametrize("tool", [bsd_probe, qkv_probe, attn_shootout],
                         ids=lambda t: t.__name__.rsplit(".", 1)[1])
def test_tool_main_on_the_cpu(tool, monkeypatch, capsys):
    """Each tool's rows at tiny shapes on the CPU, every row timed (none
    FAILED) and printed; the wrappers take their plain versions, so no
    kernel is launched."""
    for name, value in TINY_SHAPES[tool].items():
        monkeypatch.setattr(tool, name, value)
    monkeypatch.setattr(_timing, "CHAIN", 2)
    monkeypatch.setattr(_timing, "OUTER", 1)
    counters = (bsd_probe.probe, qkv_probe.bsd_fused, attention.bsd_attention,
                attention.flash_attention, attention.pallas_attention,
                attention.mh_attention, attention.batched_attention)
    before = [c.launches for c in counters]
    rows = tool.main(device="cpu")
    assert [c.launches for c in counters] == before
    assert list(rows) == ROWS[tool]
    assert all(isinstance(v, float) and v > 0 for v in rows.values())
    out = capsys.readouterr().out
    assert all(f"{name}" in out for name in rows)
    assert "FAILED" not in out


# -- the card probes and the measurement tools ----------------------------------

from mcm_tpu_torch.tools import (bsd_block_probe, check_pallas_mh,  # noqa: E402
                                 h2d_probe, h2d_probe2, int8_probe,
                                 mfu_breakdown, parity_check, scale_soak)

#: each tool's ``main`` with ``--device cuda``
CUDA_ARGV = {
    "bsd_block_probe": (bsd_block_probe.main, "cuda"),
    "check_pallas_mh": (check_pallas_mh.main, ["--device", "cuda"]),
    "int8_probe": (int8_probe.main, ["--device", "cuda"]),
    "h2d_probe": (h2d_probe.main, ["--device", "cuda"]),
    "h2d_probe2": (h2d_probe2.main, ["--device", "cuda"]),
    "mfu_breakdown": (mfu_breakdown.main, ["--device", "cuda"]),
    "scale_soak": (scale_soak.main, ["--device", "cuda", "--root",
                                     "/nonexistent/soak"]),
    "parity_check": (parity_check.main, ["check", "--goldens", "g.npz",
                                         "--device", "cuda"]),
}


@pytest.mark.parametrize("tool", sorted(CUDA_ARGV))
def test_tools_raise_without_a_card(tool):
    """``--device cuda`` (each tool's default) raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a card")
    main, argv = CUDA_ARGV[tool]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(argv)


def test_h2d_buffers_are_distinct_and_jax_s(monkeypatch):
    """The probes' buffers at a tiny size: pairwise distinct, and equal to
    the JAX tool's for the same seed (``tools/h2d_probe.py::make_buffers``)."""
    from tools import h2d_probe as jh2d
    for mod in (h2d_probe, jh2d):
        monkeypatch.setattr(mod, "B", 3)
        monkeypatch.setattr(mod, "S", 8)
    bufs = h2d_probe.make_buffers(5)
    assert all(b.shape == (3, 8, 8, 3) and b.dtype == torch.uint8
               for b in bufs)
    assert len({b.numpy().tobytes() for b in bufs}) == 5
    for got, want in zip(bufs, jh2d.make_buffers(5)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert h2d_probe.buffer_bytes() == 3 * 8 * 8 * 3


def test_h2d_concurrent_copies_every_buffer_once(monkeypatch):
    """Each way takes its round-robin share; every buffer is copied once."""
    class Seen:
        def __init__(self):
            self.got = []

        def transfer(self, b):
            self.got.append(int(b[0]))
    lanes = [Seen() for _ in range(3)]
    bufs = [torch.full((2,), i, dtype=torch.uint8) for i in range(7)]
    h2d_probe.run_concurrent(lanes, bufs)
    assert [lane.got for lane in lanes] == [[0, 3, 6], [1, 4], [2, 5]]


@pytest.mark.parametrize("tool", [h2d_probe, h2d_probe2])
def test_h2d_lanes_are_made_once_and_warmed(tool, monkeypatch):
    """Every lane (a stream and a device buffer) is made before the timed
    rounds and warmed by one transfer; the rounds make none, so no timed
    copy pays a fresh device allocation.  A transfer copies into the
    lane's own buffer and returns the buffer's sum."""
    monkeypatch.setattr(h2d_probe, "B", 2)
    monkeypatch.setattr(h2d_probe, "S", 8)
    monkeypatch.setattr(tool, "ROUNDS", 3)
    made, calls = [], []
    real_init, real_transfer = h2d_probe.Lane.__init__, h2d_probe.Lane.transfer

    def init(self, like, device):
        real_init(self, like, device)
        made.append(self)

    def transfer(self, buf):
        calls.append((self, self.dst.data_ptr()))
        got = real_transfer(self, buf)
        assert torch.equal(self.dst, buf) and got == int(buf.sum())
        return got
    monkeypatch.setattr(h2d_probe.Lane, "__init__", init)
    monkeypatch.setattr(h2d_probe.Lane, "transfer", transfer)
    tool.main(["--device", "cpu"])
    ways = max(h2d_probe.WAYS) if tool is h2d_probe else h2d_probe2.WAYS
    assert len(made) == ways
    assert [lane for lane, _ in calls[:ways]] == made     # the warm-up
    assert {lane for lane, _ in calls} == set(made)
    assert all(ptr == lane.dst.data_ptr() for lane, ptr in calls)


def test_h2d_probe2_alternates_the_order():
    """S,C in even rounds and C,S in odd ones; the ratio is serial over
    concurrent, and the verdict reads the median."""
    calls = []

    def serial():
        calls.append("S")
        return 2.0

    def conc():
        calls.append("C")
        return 1.0
    rounds = h2d_probe2.run_rounds(serial, conc, 4)
    assert calls == ["S", "C", "C", "S", "S", "C", "C", "S"]
    assert [r["order"] for r in rounds] == ["S,C", "C,S"] * 2
    assert all(r["ratio"] == 2.0 for r in rounds)
    assert h2d_probe2.verdict([2.0, 2.0]) == "CONCURRENCY WINS"
    assert h2d_probe2.verdict([1.1, 1.2, 0.9]).startswith("no robust win")


@pytest.mark.parametrize("tool", [h2d_probe, h2d_probe2])
def test_h2d_probes_on_the_cpu(tool, monkeypatch):
    monkeypatch.setattr(h2d_probe, "B", 2)
    monkeypatch.setattr(h2d_probe, "S", 8)
    monkeypatch.setattr(tool, "ROUNDS", 2)
    row = tool.main(["--device", "cpu"])
    assert len(row["rounds"]) == 2
    if tool is h2d_probe:
        assert set(row["rounds"][0]) == {"serial", "concurrent2",
                                         "concurrent4"}
    else:
        assert row["verdict"] and row["ratio_median"] > 0


@pytest.mark.parametrize("variant", int8_probe.VARIANTS)
def test_int8_chain_is_honest(variant, rng, monkeypatch):
    """The JAX tool's two properties: product i takes the weight rolled i
    columns (a loop-carried dependence; for ``int8_tn`` in its column-major
    layout), and the accumulator is the sum of every product's WHOLE output
    (here n times the full x @ w sum, which a narrowed product would not
    give)."""
    x8 = rng.integers(-127, 127, (16 + 8, 32), dtype=np.int8)
    w8 = rng.integers(-127, 127, (32, 24), dtype=np.int8)
    xs = x8.astype(np.int64)
    if variant == "int8+dq":
        xs[0, 0] = 127            # max |x| = 127: the quantization is exact
    seen = []
    if variant == "bf16":
        x = torch.from_numpy(xs.astype(np.float32)).bfloat16()
        w = torch.from_numpy(w8.astype(np.float32)).bfloat16()
        real = int8_probe.matmul_f32

        def product(a, b):
            seen.append(b.float().numpy().astype(np.int64))
            return real(a, b)
        monkeypatch.setattr(int8_probe, "matmul_f32", product)
    else:
        x = (torch.from_numpy(xs.astype(np.float32)).bfloat16()
             if variant == "int8+dq" else torch.from_numpy(xs.astype(np.int8)))
        w = torch.from_numpy(w8)
        real = torch._int_mm

        def product(a, b):
            seen.append(b.numpy().astype(np.int64))
            return real(a, b)
        monkeypatch.setattr(torch, "_int_mm", product)
    got = float(int8_probe.chain(variant, x, w, n=3))
    assert len(seen) == 3
    for i, wi in enumerate(seen):
        np.testing.assert_array_equal(wi, np.roll(w8.astype(np.int64), i,
                                                  axis=1))
    full = int((xs @ w8.astype(np.int64)).sum())
    assert got == pytest.approx(3 * full, rel=1e-6)
    assert full != int((xs[:1] @ w8[:, :1].astype(np.int64)).sum())


def test_int8_probe_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(int8_probe, "M", 32)
    monkeypatch.setattr(int8_probe, "K", 16)
    monkeypatch.setattr(int8_probe, "N", 24)
    monkeypatch.setattr(int8_probe, "OUTER", 1)
    row = int8_probe.main(["--device", "cpu"])
    assert set(row["ms"]) == set(int8_probe.VARIANTS)
    assert set(row["consumer_ms"]) == {"f32_sum", "int32_cast_sum"}
    assert row["int8_over_bf16_time"] > 0
    for key in ("int8", "int8_tn", "int8_dq"):
        ms = row["ms"]["int8+dq" if key == "int8_dq" else key]
        assert row[f"{key}_over_bf16_time_net"] == pytest.approx(
            (ms - row["consumer_ms"]["int32_cast_sum"])
            / (row["ms"]["bf16"] - row["consumer_ms"]["f32_sum"]))
    assert "int8+dq" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_int8_consumer_chain_sums_the_whole_product(dtype, rng):
    """The consumer rows sum the WHOLE product each iteration, an int32
    one cast to fp32 first, as the variants consume theirs."""
    p = torch.from_numpy(rng.integers(-1000, 1000, (24, 40))).to(dtype)
    got = float(int8_probe.sum_chain(p, n=3))
    assert got == pytest.approx(3 * float(p.double().sum()), rel=1e-6)


def test_check_pallas_mh_cases_on_the_cpu(capsys):
    """JAX's three cases through the kernel's plain version, no launch."""
    before = attention.mh_attention.launches
    row = check_pallas_mh.main(["--device", "cpu"])
    assert attention.mh_attention.launches == before
    assert row["ok"] and [(c["H"], c["S"], c["block_h"])
                          for c in row["cases"]] == [(12, 197, 6),
                                                     (16, 197, 6),
                                                     (12, 50, 12)]
    assert all(c["max_abs_err"] < 3e-2 for c in row["cases"])
    assert "mh_attention == math path: OK" in capsys.readouterr().out


def test_check_pallas_mh_reference_is_jaxs(rng):
    """The port's reference (the math path in fast precision) against
    JAX's ``_xla_attention`` on the same bf16 heads: one bf16 ulp."""
    from mcm_tpu.config import Precision as JPrecision
    from mcm_tpu.ops.attention import _xla_attention

    from mcm_tpu_torch.config import Precision
    q, k, v = _arrays(rng, (2, 4, 50, 64))
    want = np.asarray(_xla_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), None,
        JPrecision.fast()).astype(jnp.float32))
    got = attention._math_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), None,
        Precision.fast()).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_bf16_ulp(float(np.abs(want).max())))


def test_bsd_block_probe_on_the_cpu(monkeypatch):
    """Both rows at each shape, none FAILED, no launch on the CPU."""
    monkeypatch.setattr(bsd_block_probe, "SHAPES",
                        {"B/32": (2, 17, 128, 2), "L/14": (2, 9, 256, 4)})
    monkeypatch.setattr(_timing, "CHAIN", 2)
    monkeypatch.setattr(_timing, "OUTER", 1)
    before = attention.bsd_attention.launches
    rows = bsd_block_probe.main("cpu")
    assert attention.bsd_attention.launches == before
    assert list(rows) == ["B/32 xla", "B/32 bsd", "L/14 xla", "L/14 bsd"]
    assert not _timing.failed(rows)
    assert list(bsd_block_probe.SHAPES) == ["B/32", "L/14"]
