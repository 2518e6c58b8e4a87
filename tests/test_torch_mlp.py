"""The port's fused MLP against the JAX package's on the CPU: the kernel's
plain version against the Pallas kernel ``fused_mlp`` in interpret mode
(as ``tests/test_ops.py`` runs it), and the wrapper's CPU behaviour."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mcm_tpu.ops.mlp import fused_mlp as jax_fused_mlp

from mcm_tpu_torch.ops import mlp


def _inputs(rng, m=70, d=64, f=256):
    """The shapes and scales of ``test_fused_mlp_matches_reference``: a
    non-multiple M exercises the tail block."""
    return (rng.standard_normal((m, d)).astype(np.float32),
            (rng.standard_normal((d, f)) * 0.1).astype(np.float32),
            rng.standard_normal((f,)).astype(np.float32),
            (rng.standard_normal((f, d)) * 0.1).astype(np.float32),
            rng.standard_normal((d,)).astype(np.float32))


def _jax(arrays, act, dtype=jnp.float32):
    x, w1, b1, w2, b2 = arrays
    with pltpu.force_tpu_interpret_mode():
        return jax_fused_mlp(jnp.asarray(x, dtype), jnp.asarray(w1, dtype),
                             jnp.asarray(b1), jnp.asarray(w2, dtype),
                             jnp.asarray(b2), act=act, block_m=32)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_plain_matches_pallas_kernel(rng, act):
    """fp32 at the tolerance of ``test_fused_mlp_matches_reference``."""
    arrays = _inputs(rng)
    want = _jax(arrays, act)
    got = mlp.fused_mlp_reference(*(torch.from_numpy(a) for a in arrays),
                                  act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_plain_matches_pallas_kernel_bf16(rng, act):
    """bf16 x/w1/w2 with fp32 biases: both round h to bf16 before fc2 and
    the output to bf16; within one bf16 ulp at |y| ≤ 4 (1.6e-2)."""
    arrays = _inputs(rng)
    want = _jax(arrays, act, jnp.bfloat16)
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in arrays)
    got = mlp.fused_mlp_reference(x.bfloat16(), w1.bfloat16(), b1,
                                  w2.bfloat16(), b2, act=act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1.6e-2, atol=1.6e-2)


def test_plain_rounds_h_like_the_fused_kernel(rng):
    """The plain version rounds h once, after the fp32 activation — not
    after fc1 as the unfused chain does — so it differs from the unfused
    rounding and agrees with the JAX kernel's."""
    arrays = _inputs(rng)
    x, w1, b1, w2, b2 = (torch.from_numpy(a).bfloat16() if a.ndim == 2
                         else torch.from_numpy(a) for a in arrays)
    fused = mlp.fused_mlp_reference(x, w1, b1, w2, b2).float()
    h = (x.float() @ w1.float() + b1).bfloat16()                  # unfused
    h = h * torch.sigmoid(h * 1.702)
    unfused = (h.float() @ w2.float() + b2).bfloat16().float()
    want = np.asarray(_jax(arrays, "quick_gelu", jnp.bfloat16), np.float32)
    assert np.abs(fused.numpy() - want).max() < np.abs(unfused.numpy()
                                                       - want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_is_the_plain_version(rng, dtype):
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(rng))
    x, w1, w2 = x.to(dtype), w1.to(dtype), w2.to(dtype)
    before = mlp.fused_mlp.launches
    got = mlp.fused_mlp(x, w1, b1, w2, b2, act="gelu", block_m=32)
    assert mlp.fused_mlp.launches == before   # no kernel launch
    torch.testing.assert_close(
        got, mlp.fused_mlp_reference(x, w1, b1, w2, b2, act="gelu"),
        rtol=0, atol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take(rng):
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _inputs(rng))
    with pytest.raises(ValueError, match="activation"):
        mlp.fused_mlp(x, w1, b1, w2, b2, act="relu")
    with pytest.raises(ValueError, match="shapes disagree"):
        mlp.fused_mlp(x, w1, b1, w2.T.contiguous()[:, :32], b2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mlp.fused_mlp(x.half(), w1.half(), b1, w2.half(), b2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mlp.fused_mlp(x.bfloat16(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="float32 biases"):
        mlp.fused_mlp(x, w1, b1.double(), w2, b2)
    with pytest.raises(ValueError, match="block_m"):
        mlp.fused_mlp(x, w1, b1, w2, b2, block_m=0)
    with pytest.raises(ValueError, match=r"\[M, D\]"):
        mlp.fused_mlp(x[None], w1, b1, w2, b2)
