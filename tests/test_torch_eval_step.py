"""The port's EvalStep against the JAX package's on one uint8 batch, for
every logit score (parity precision, CPU).  Scores agree to 2e-5 of the
largest score, the bound the JAX package holds its CLI scores to against
the reference (``tests/test_crossimpl_e2e.py``)."""

import numpy as np
import pytest

import jax.numpy as jnp

from mcm_tpu.config import CLIPConfig, Precision, TextConfig, VisionConfig
from mcm_tpu.models.init import init_clip
from mcm_tpu.parallel import EvalStep as JEvalStep
from mcm_tpu.parallel import make_mesh

from mcm_tpu_torch import config as tconfig
from mcm_tpu_torch.parallel import EvalStep
from util_cfg import port_config

CFG = CLIPConfig(
    name="tiny",
    vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=2,
                        heads=4, projection_dim=32),
    text=TextConfig(vocab_size=128, context_length=16, width=64, layers=2,
                    heads=4, projection_dim=32),
)
TCFG = port_config(CFG)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
    text = rng.standard_normal((11, 32)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return init_clip(5, CFG), images, text


@pytest.mark.parametrize("score", ["MCM", "energy", "max-logit", "entropy",
                                   "var"])
@pytest.mark.parametrize("T", [1.0, 2.0])
def test_score_matches_jax_eval_step(inputs, score, T):
    params, images, text = inputs
    jstep = JEvalStep(CFG, score=score, T=T, precision=Precision.parity(),
                      mesh=make_mesh(1))
    want = np.asarray(jstep.score(jstep.put_params(params),
                                  jstep.put_batch(images),
                                  jstep.put_replicated(jnp.asarray(text))))
    step = EvalStep(TCFG, score=score, T=T,
                    precision=tconfig.Precision.parity(), device="cpu")
    got = step.score(step.put_params(params), step.put_batch(images),
                     step.put_replicated(text)).numpy()
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def test_encode_text_matches_jax(inputs):
    """Prompt encoding with the tail batch padded to the lead shape."""
    params, _, _ = inputs
    rng = np.random.default_rng(9)
    ids = rng.integers(1, 120, size=(7, 8)).astype(np.int32)
    ids[:, -1] = 127
    mask = np.ones_like(ids)
    jstep = JEvalStep(CFG, precision=Precision.parity(), mesh=make_mesh(1))
    want = np.asarray(jstep.encode_text(jstep.put_params(params), ids, mask,
                                        batch_size=4))
    step = EvalStep(TCFG, precision=tconfig.Precision.parity(), device="cpu")
    got = step.encode_text(step.put_params(params), ids, mask,
                           batch_size=4).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
