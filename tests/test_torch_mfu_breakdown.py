"""The port's ``mfu_breakdown`` (``mcm_tpu_torch.tools.mfu_breakdown``) on the
CPU: each ablated block against JAX's ``tools/mfu_breakdown.py::make_block``
on the same converted parameters, the "full" block bit-equal to the
production block, the production block restored after a variant raises,
and the tool's variants at a tiny size."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcm_tpu.config import Precision as JPrecision
from mcm_tpu.models.convert import convert_hf_clip as jconvert
from tools import mfu_breakdown as jmfu

from mcm_tpu_torch.config import Precision
from mcm_tpu_torch.models import clip as tclip
from mcm_tpu_torch.models import hf_synth
from mcm_tpu_torch.models.convert import convert_hf_clip, from_jax_params
from mcm_tpu_torch.ops import attention, mcm_score
from mcm_tpu_torch.tools import mfu_breakdown

MODES = ("full", "attn_xla", "attn_core", "no_attn", "no_mlp", "no_ln")


@pytest.fixture(scope="module")
def two_layers():
    """The golden config's vision width at 2 layers, its synthesized HF
    state dict converted by each package, and one input of 197 tokens."""
    cfg = hf_synth.golden_config()
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision,
                                                              layers=2),
                              text=dataclasses.replace(cfg.text, layers=2))
    from mcm_tpu.models.hf_synth import golden_config as jgolden
    jcfg = jgolden()
    jcfg = dataclasses.replace(jcfg, vision=dataclasses.replace(jcfg.vision,
                                                                layers=2),
                               text=dataclasses.replace(jcfg.text, layers=2))
    sd = hf_synth.synth_hf_clip_state_dict(cfg, seed=3)
    x = np.random.default_rng(0).standard_normal(
        (2, cfg.vision.seq_len, cfg.vision.width)).astype(np.float32)
    return cfg, convert_hf_clip(sd, cfg), jconvert(sd, jcfg), x


def _run_torch(block, params, cfg, x, precision):
    model = from_jax_params(params, "cpu", precision.activation_dtype)
    y = torch.from_numpy(x).to(precision.activation_dtype)
    with torch.inference_mode():
        for layer in tclip._unstack(model["vision"]["layers"]):
            y = block(y, layer, heads=cfg.vision.heads,
                      eps=cfg.vision.layer_norm_eps, mask=None,
                      precision=precision)
    return y.float().numpy()


def _run_jax(block, params, cfg, x, precision):
    layers = params["vision"]["layers"]
    y = jnp.asarray(x)
    for i in range(cfg.vision.layers):
        layer = jax.tree_util.tree_map(lambda a, i=i: jnp.asarray(a)[i],
                                       layers)
        y = block(y, layer, heads=cfg.vision.heads,
                  eps=cfg.vision.layer_norm_eps, mask=None,
                  precision=precision)
    return np.asarray(y, np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_make_block_matches_jax(two_layers, mode):
    """Two layers of each variant in parity precision, rtol 2e-4 / atol
    2e-5; ``attn_xla`` is the full block with attn_impl="xla"."""
    cfg, tparams, jparams, x = two_layers
    block_mode = "full" if mode == "attn_xla" else mode
    tprec, jprec = Precision.parity(), JPrecision.parity()
    if mode == "attn_xla":
        tprec = dataclasses.replace(tprec, attn_impl="xla")
        jprec = dataclasses.replace(jprec, attn_impl="xla")
    got = _run_torch(mfu_breakdown.make_block(block_mode), tparams, cfg, x,
                     tprec)
    want = _run_jax(jmfu.make_block(block_mode), jparams, cfg, x, jprec)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("precision", [Precision.parity(), Precision.fast()],
                         ids=["parity", "fast"])
def test_full_block_is_the_production_block(two_layers, precision):
    cfg, tparams, _, x = two_layers
    got = _run_torch(mfu_breakdown.make_block("full"), tparams, cfg, x,
                     precision)
    want = _run_torch(tclip.transformer_block, tparams, cfg, x, precision)
    assert np.array_equal(got, want)


def _tiny(monkeypatch):
    monkeypatch.setenv("MCM_TPU_TEST_TINY_B16", "1")
    monkeypatch.setattr(mfu_breakdown, "BATCH", 2)
    monkeypatch.setattr(mfu_breakdown, "WARMUP", 1)
    monkeypatch.setattr(mfu_breakdown, "WINDOWS", 1)
    monkeypatch.setattr(mfu_breakdown, "ITERS", 2)


@pytest.mark.filterwarnings("ignore:MCM_TPU_TEST_TINY_B16")
def test_block_restored_after_a_variant_raises(monkeypatch, capsys):
    """A variant whose block raises prints FAILED, the others keep their
    rows, and ``transformer_block`` is the production block again."""
    _tiny(monkeypatch)
    orig = tclip.transformer_block
    real = mfu_breakdown.make_block

    def make_block(mode):
        if mode != "no_mlp":
            return real(mode)

        def boom(*a, **k):
            raise RuntimeError("ablation failed")
        return boom
    monkeypatch.setattr(mfu_breakdown, "make_block", make_block)
    monkeypatch.setattr(mfu_breakdown, "VARIANTS", (("full", None),
                                                    ("no_mlp", None),
                                                    ("no_ln", None)))
    with pytest.raises(RuntimeError, match="ablation failed"):
        mfu_breakdown.time_variant("no_mlp", device="cpu")
    assert tclip.transformer_block is orig
    row = mfu_breakdown.main(["--device", "cpu"])
    assert tclip.transformer_block is orig
    assert list(row["variants"]) == ["full", "no_ln"]
    assert list(row["failed"]) == ["no_mlp"]
    assert "no_mlp    : FAILED RuntimeError: ablation failed" in \
        capsys.readouterr().out
    assert "no_mlp" not in row["deltas_ms"]


@pytest.mark.filterwarnings("ignore:MCM_TPU_TEST_TINY_B16")
def test_every_variant_times_on_the_cpu(monkeypatch, capsys):
    """All six rows at a tiny size, in JAX's order, with the JSON's
    ``full_ms_per_batch`` and ``deltas_ms``; the CPU launches no kernel."""
    _tiny(monkeypatch)
    before = (attention.bsd_attention.launches, mcm_score.mcm_score.launches)
    row = mfu_breakdown.main(["--device", "cpu"])
    assert (attention.bsd_attention.launches,
            mcm_score.mcm_score.launches) == before
    assert list(row["variants"]) == list(MODES) and not row["failed"]
    for v in row["variants"].values():
        assert v["img_per_s"] > 0 and v["batches"] == 3
        assert v["launches"] == {"bsd_attention": 0, "mcm_score": 0,
                                 "dense_epilogue": 0}
    assert row["full_ms_per_batch"] == row["variants"]["full"]["ms_per_batch"]
    assert list(row["deltas_ms"]) == list(MODES[1:])
    assert '"deltas_ms"' in capsys.readouterr().out
