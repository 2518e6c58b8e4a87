"""The port's scores against the JAX package's on the CPU: the mcm kernel's
plain version against the Pallas kernel in interpret mode, and the
torch score path against ``compute_scores``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mcm_tpu.ops.mcm_score import _pallas_mcm
from mcm_tpu.scores.clip_scores import compute_scores as jcompute_scores
from mcm_tpu.scores.clip_scores import l2_normalize as jl2_normalize

from mcm_tpu_torch.ops import mcm_score
from mcm_tpu_torch.scores import clip_scores

SCORES = ("MCM", "energy", "max-logit", "entropy", "var")


def _feats(rng, b, c, d):
    img = rng.standard_normal((b, d)).astype(np.float32)
    txt = rng.standard_normal((c, d)).astype(np.float32)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    return img, txt


@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("n_classes", [7, 130])
@pytest.mark.parametrize("T", [1.0, 2.0])
def test_mcm_plain_matches_pallas_kernel(rng, score, n_classes, T):
    """rtol 1e-4 / atol 1e-5: the tolerance the JAX package holds the
    kernel to (``tests/test_ops.py``)."""
    img, txt = _feats(rng, 32, n_classes, 64)
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_mcm(jnp.asarray(img), jnp.asarray(txt), score, T,
                           block_b=16)
    got = mcm_score.mcm_score_reference(torch.from_numpy(img),
                                        torch.from_numpy(txt), score, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("score", SCORES)
def test_nan_row_propagates(rng, score):
    """A zero-norm feature row scores NaN on every path (entropy included:
    the where() alone would give -0.0, the strongest ID verdict)."""
    img, txt = _feats(rng, 4, 10, 16)
    img[2] = 0.0
    t_img, t_txt = torch.from_numpy(img), torch.from_numpy(txt)
    for got in (mcm_score.mcm_score_reference(t_img, t_txt, score, 1.0),
                mcm_score.mcm_score(t_img, t_txt, score, 1.0),
                clip_scores.compute_scores(t_img, t_txt, score, 1.0)):
        assert np.isnan(got[2].item())
        assert np.isfinite(got[[0, 1, 3]].numpy()).all()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_mcm(jnp.asarray(img), jnp.asarray(txt),
                                      score, 1.0, block_b=8))
    assert np.isnan(want[2])


@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("T", [1.0, 100.0])
def test_compute_scores_parity(rng, score, T):
    img, txt = _feats(rng, 16, 37, 32)
    want = jcompute_scores(jnp.asarray(img), jnp.asarray(txt), score=score,
                           T=T)
    got = clip_scores.compute_scores(torch.from_numpy(img),
                                     torch.from_numpy(txt), score, T)
    # var of a near-uniform softmax (T = 100) cancels p - mean down to
    # ~1e-9: rtol 1e-4 there, 1e-5 elsewhere (fp32 summation order)
    rtol = 1e-4 if score == "var" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=rtol, atol=1e-6 * np.abs(want).max())
    host = clip_scores.compute_scores_host(img, txt, score, T)
    np.testing.assert_allclose(host, np.asarray(want), rtol=rtol,
                               atol=1e-6 * np.abs(want).max())


def test_l2_normalize_parity(rng):
    x = rng.standard_normal((5, 24)).astype(np.float32)
    np.testing.assert_allclose(
        clip_scores.l2_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jl2_normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_fused_mcm_scores_dispatch(rng):
    """CPU tensors: auto takes the torch path; "cuda" takes the kernel's
    plain version; JAX's "pallas" / "xla" name the same two paths; unknown
    names raise."""
    img, txt = (torch.from_numpy(a) for a in _feats(rng, 8, 20, 16))
    before = mcm_score.mcm_score.launches
    auto = mcm_score.fused_mcm_scores(img, txt, "MCM", 1.0)
    torch.testing.assert_close(
        auto, clip_scores.compute_scores(img, txt, "MCM", 1.0),
        rtol=0, atol=0)
    cuda = mcm_score.fused_mcm_scores(img, txt, "MCM", 1.0, impl="cuda")
    torch.testing.assert_close(
        cuda, mcm_score.mcm_score_reference(img, txt, "MCM", 1.0),
        rtol=0, atol=0)
    pallas = mcm_score.fused_mcm_scores(img, txt, "MCM", 1.0, impl="pallas")
    torch.testing.assert_close(pallas, cuda, rtol=0, atol=0)
    assert mcm_score.mcm_score.launches == before
    with pytest.raises(ValueError):
        mcm_score.fused_mcm_scores(img, txt, "maha", 1.0)


@pytest.mark.parametrize("name,same_as", [("pallas", "cuda"), ("xla", "torch"),
                                          ("cuda", "cuda"), ("torch", "torch")])
@pytest.mark.parametrize("score", SCORES)
def test_jax_path_names_route_as_the_port_names(rng, name, same_as, score):
    """JAX's path names are the port's: "pallas" the kernel (its plain
    version on a CPU tensor), "xla" the torch score path, bit for bit."""
    img, txt = (torch.from_numpy(a) for a in _feats(rng, 8, 30, 16))
    want = (mcm_score.mcm_score_reference(img, txt, score, 2.0)
            if same_as == "cuda"
            else clip_scores.compute_scores(img, txt, score, 2.0))
    got = mcm_score.fused_mcm_scores(img, txt, score, 2.0, impl=name)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", ["Pallas", "triton", "auto", ""])
def test_unknown_path_name_raises(rng, name):
    """JAX sends any other name to XLA; the port raises (ROADMAP.md
    Queue 3, I1)."""
    img, txt = (torch.from_numpy(a) for a in _feats(rng, 4, 10, 8))
    with pytest.raises(ValueError, match="unknown impl"):
        mcm_score.fused_mcm_scores(img, txt, "MCM", 1.0, impl=name)


@pytest.mark.parametrize("score", SCORES)
def test_plain_matches_jax_past_the_old_gate(rng, score):
    """C = 16000, where the port's kernel used to refuse and the JAX
    package's auto gate still does: the plain version against the Pallas
    kernel in interpret mode and against JAX's score path."""
    img, txt = _feats(rng, 8, 16000, 32)
    got = mcm_score.mcm_score_reference(torch.from_numpy(img),
                                        torch.from_numpy(txt), score, 1.0)
    with pltpu.force_tpu_interpret_mode():
        kernel = _pallas_mcm(jnp.asarray(img), jnp.asarray(txt), score, 1.0,
                             block_b=8)
    xla = jcompute_scores(jnp.asarray(img), jnp.asarray(txt), score=score,
                          T=1.0)
    for want in (np.asarray(kernel), np.asarray(xla)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())


@pytest.fixture
def tf32_flags():
    """Snapshot torch's TF32 switches and put them back after the test."""
    cuda_mm = torch.backends.cuda.matmul
    newer = [b for b in (cuda_mm, getattr(torch.backends.mkldnn, "matmul",
                                          None))
             if hasattr(b, "fp32_precision")]
    saved = (torch.get_float32_matmul_precision(),
             [b.fp32_precision for b in newer])
    yield
    torch.set_float32_matmul_precision(saved[0])
    for b, p in zip(newer, saved[1]):
        b.fp32_precision = p


def _cuda_matmul_state():
    """What a cuBLAS fp32 product reads: both of torch's switches."""
    cuda_mm = torch.backends.cuda.matmul
    return (cuda_mm.allow_tf32, getattr(cuda_mm, "fp32_precision", None))


def _tf32_state():
    return _cuda_matmul_state() + (torch.get_float32_matmul_precision(),)


@pytest.mark.parametrize("setup", ["default", "allow_tf32", "medium"])
def test_similarity_logits_pins_ieee_fp32(rng, monkeypatch, tf32_flags, setup):
    """With TF32 on globally, the score path's product still runs in IEEE
    fp32 (JAX's precision="highest"), and the global setting is exactly as
    it was afterwards, also when the product raises."""
    if setup == "allow_tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
    elif setup == "medium":
        torch.set_float32_matmul_precision("medium")
    found = _tf32_state()
    img, txt = (torch.from_numpy(a) for a in _feats(rng, 4, 12, 8))
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(_cuda_matmul_state())
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    got = clip_scores.similarity_logits(img, txt)
    newer = "ieee" if hasattr(torch.backends.cuda.matmul,
                              "fp32_precision") else None
    assert seen == [(False, newer)]
    assert _tf32_state() == found
    imgn = img / torch.sqrt(torch.sum(img * img, dim=-1, keepdim=True))
    torch.testing.assert_close(got, real(imgn, txt.T), rtol=1e-6, atol=1e-6)

    def boom(a, b):
        seen.append(_cuda_matmul_state())
        raise RuntimeError("boom")

    monkeypatch.setattr(torch, "matmul", boom)
    with pytest.raises(RuntimeError, match="boom"):
        clip_scores.similarity_logits(img, txt)
    assert seen[-1] == (False, newer)
    assert _tf32_state() == found
