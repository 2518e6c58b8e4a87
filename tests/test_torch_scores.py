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
    plain version; unknown names raise."""
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
    assert mcm_score.mcm_score.launches == before
    with pytest.raises(ValueError):
        mcm_score.fused_mcm_scores(img, txt, "MCM", 1.0, impl="pallas")
    with pytest.raises(ValueError):
        mcm_score.fused_mcm_scores(img, txt, "maha", 1.0)


def test_kernel_gate_sized_by_its_own_allocation():
    """The gate counts what the kernel allocates (4 rows of C logits and D
    features, plus 4 x 8 floats of scratch), not the JAX gate's VMEM
    estimate; every C the CLI's datasets produce fits."""
    assert mcm_score.kernel_smem_bytes(1000, 512) == 4 * 1512 * 4 + 128
    for c in (10, 20, 37, 100, 102, 196, 200, 1000):
        assert mcm_score.kernel_fits(c, 768)
    assert mcm_score.kernel_fits(13000, 512)
    assert not mcm_score.kernel_fits(16000, 512)
