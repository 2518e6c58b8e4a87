"""The port's Mahalanobis score against the JAX package's on the CPU.

``estimate_mean_precision`` is the same numpy code, so its results are
bit-equal.  ``mahalanobis_score`` is held to rtol 1e-4 / atol 1e-4, the
bound ``tests/test_scores.py`` holds JAX's to against a naive fp64 loop,
and to 1e-5 of the largest score in the offset case (JAX's own bound
there).  ``EvalStep.maha`` is held against JAX's ``EvalStep.maha`` on the
tiny config at the same tolerance."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcm_tpu.config import CLIPConfig, Precision, TextConfig, VisionConfig
from mcm_tpu.parallel import EvalStep as JEvalStep
from mcm_tpu.parallel import make_mesh
from mcm_tpu.scores import mahalanobis as jmaha

from mcm_tpu_torch import config as tconfig
from mcm_tpu_torch.parallel import EvalStep
from mcm_tpu_torch.scores import mahalanobis as tmaha
from util_cfg import port_config

CFG = CLIPConfig(
    name="tiny",
    vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=2,
                        heads=4, projection_dim=32),
    text=TextConfig(vocab_size=128, context_length=16, width=64, layers=2,
                    heads=4, projection_dim=32),
)
TCFG = port_config(CFG)


def _naive_maha(features, mu, P):
    scores = []
    for i in range(mu.shape[0]):
        z = features - mu[i]
        scores.append(-0.5 * np.einsum("bd,de,be->b", z, P, z))
    return -np.max(np.stack(scores, axis=1), axis=1)


def _spd(rng, d):
    A = rng.standard_normal((d, d)).astype(np.float32)
    return (A @ A.T / d + np.eye(d)).astype(np.float32)


@pytest.mark.parametrize("normalize", [False, True])
def test_estimate_mean_precision_bit_equal_to_jax(rng, normalize):
    feats = rng.standard_normal((200, 16)).astype(np.float32) + 0.5
    labels = rng.integers(0, 5, size=200)
    want = jmaha.estimate_mean_precision(feats, labels, 5,
                                         normalize=normalize)
    got = tmaha.estimate_mean_precision(feats, labels, 5,
                                        normalize=normalize)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    # exact class means, not the reference's batch-index rows
    if not normalize:
        for k in range(5):
            np.testing.assert_allclose(got[0][k], feats[labels == k].mean(0),
                                       rtol=1e-5)


def test_estimate_refuses_an_empty_class(rng):
    feats = rng.standard_normal((40, 8)).astype(np.float32)
    labels = np.zeros(40, np.int64)
    labels[20:] = 2                       # class 1 has no sample
    with pytest.raises(ValueError, match=r"class indices \[1\]"):
        tmaha.estimate_mean_precision(feats, labels, 3)


@pytest.mark.parametrize("n,warns", [(8, True), (16, True), (17, False)])
def test_estimate_warns_when_rank_deficient(rng, n, warns):
    """N <= D leaves the covariance rank-deficient: a warning, as in JAX."""
    feats = rng.standard_normal((n, 16)).astype(np.float32)
    labels = np.arange(n) % 2
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tmaha.estimate_mean_precision(feats, labels, 2)
    assert any("rank-deficient" in str(r.message) for r in rec) == warns


@pytest.mark.parametrize("normalize", [False, True])
def test_mahalanobis_score_matches_jax_and_naive(rng, normalize):
    feats = rng.standard_normal((20, 16)).astype(np.float32)
    mu = rng.standard_normal((5, 16)).astype(np.float32)
    P = _spd(rng, 16)
    want = np.asarray(jmaha.mahalanobis_score(
        jnp.asarray(feats), jnp.asarray(mu), jnp.asarray(P),
        normalize=normalize))
    got = tmaha.mahalanobis_score(torch.from_numpy(feats),
                                  torch.from_numpy(mu), torch.from_numpy(P),
                                  normalize=normalize).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    f = feats.astype(np.float64)
    if normalize:
        f = f / np.linalg.norm(f, axis=-1, keepdims=True)
    np.testing.assert_allclose(got, _naive_maha(f, mu.astype(np.float64),
                                                P.astype(np.float64)),
                               rtol=1e-4, atol=1e-4)


def test_mahalanobis_offset_invariance(rng):
    """A large common offset (raw CLIP features are not centered): the
    centered expansion stays within 1e-5 of the largest score of the
    direct fp64 form, and agrees with JAX's."""
    d = 512
    offset = rng.standard_normal(d).astype(np.float32) * 8 / np.sqrt(d)
    feats = (offset + 0.3 * rng.standard_normal((64, d))).astype(np.float32)
    mu = (offset + 0.3 * rng.standard_normal((5, d))).astype(np.float32)
    P = _spd(rng, d)
    ref = _naive_maha(feats.astype(np.float64), mu.astype(np.float64),
                      P.astype(np.float64))
    got = tmaha.mahalanobis_score(torch.from_numpy(feats),
                                  torch.from_numpy(mu),
                                  torch.from_numpy(P)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
    want = np.asarray(jmaha.mahalanobis_score(
        jnp.asarray(feats), jnp.asarray(mu), jnp.asarray(P)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("normalize", [False, True])
def test_reference_template_paths_equal_jax(normalize):
    args = ("img_templates", "CLIP", "ImageNet10", 250, normalize)
    assert tmaha.reference_template_paths(*args) == \
        jmaha.reference_template_paths(*args)


def test_pt_templates_round_trip(rng, tmp_path):
    """A reference-format ``.pt`` pair loads to fp32 arrays equal to what
    was saved, as JAX's loader reads it."""
    mu = rng.standard_normal((10, 32))              # float64 on purpose
    prec = _spd(rng, 32)
    mu_pt, prec_pt = tmaha.reference_template_paths(str(tmp_path), "CLIP",
                                                    "ImageNet10", 250, False)
    torch.save(torch.from_numpy(mu), mu_pt)
    torch.save(torch.from_numpy(prec), prec_pt)
    got = tmaha.load_pt_templates(mu_pt, prec_pt)
    want = jmaha.load_pt_templates(mu_pt, prec_pt)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], mu.astype(np.float32))
    np.testing.assert_array_equal(got[1], prec)


@pytest.mark.parametrize("normalize", [False, True])
def test_eval_step_maha_matches_jax(rng, normalize):
    feats = rng.standard_normal((6, 32)).astype(np.float32) * 3 + 1
    mu = rng.standard_normal((5, 32)).astype(np.float32) + 1
    P = _spd(rng, 32)
    jstep = JEvalStep(CFG, precision=Precision.parity(), mesh=make_mesh(1))
    want = np.asarray(jstep.maha(jnp.asarray(feats),
                                 jstep.put_replicated(mu),
                                 jstep.put_replicated(P),
                                 normalize=normalize))
    step = EvalStep(TCFG, precision=tconfig.Precision.parity(), device="cpu")
    got = step.maha(torch.from_numpy(feats), step.put_replicated(mu),
                    step.put_replicated(P), normalize=normalize).numpy()
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
