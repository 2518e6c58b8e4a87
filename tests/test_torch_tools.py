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
