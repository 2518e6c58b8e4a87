"""The port's attention against the JAX package's on the CPU: the bsd
kernel's plain version against the Pallas kernel in interpret mode, the
math path against ``_xla_attention``, and the routing."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mcm_tpu.config import Precision as JPrecision
from mcm_tpu.ops.attention import _pallas_bsd_attention, _xla_attention

from mcm_tpu_torch.config import Precision
from mcm_tpu_torch.ops import attention


def _arrays(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,heads,block_b", [((3, 17, 128), 2, 2),
                                                 ((2, 197, 256), 4, 2),
                                                 ((5, 33, 128), 16, 2),
                                                 ((1, 33, 128), 2, 16),
                                                 ((14, 33, 128), 2, 12)])
def test_bsd_plain_matches_pallas_kernel(rng, shape, heads, block_b):
    """fp32 at 2e-5, as the JAX package holds the kernel to its XLA twin."""
    q, k, v = _arrays(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_bsd_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), heads=heads,
                                     block_b=block_b)
    got = attention.bsd_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_bsd_plain_matches_pallas_kernel_bf16(rng):
    """bf16 inputs: both round q·scale and p to bf16; outputs within one
    bf16 ulp at |x| ≤ 4 (1.6e-2)."""
    q, k, v = _arrays(rng, (2, 197, 256))
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_bsd_attention(*(jnp.asarray(a, jnp.bfloat16)
                                       for a in (q, k, v)), heads=4,
                                     block_b=2)
    got = attention.bsd_attention_reference(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1.6e-2, atol=1.6e-2)


def test_bsd_wrapper_on_cpu_is_the_plain_version(rng):
    q, k, v = (torch.from_numpy(a) for a in _arrays(rng, (2, 17, 128)))
    before = attention.bsd_attention.launches
    got = attention.bsd_attention(q, k, v, 4)
    assert attention.bsd_attention.launches == before   # no kernel launch
    torch.testing.assert_close(got, attention.bsd_attention_reference(
        q, k, v, 4), rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_math_attention_parity(rng, masked):
    shape = (2, 4, 33, 16)
    q, k, v = _arrays(rng, shape)
    mask = None
    if masked:
        mask = np.triu(np.full((33, 33), -1e9, np.float32), 1)
        mask = np.broadcast_to(mask, (2, 1, 33, 33)).copy()
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if mask is None else jnp.asarray(mask),
                          JPrecision.parity())
    got = attention._math_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), Precision.parity())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_math_attention_fast_mode(rng):
    """bf16 activations with bf16 logits/probabilities: the same roundings
    as ``_xla_attention``; within one bf16 ulp at |x| ≤ 4."""
    q, k, v = _arrays(rng, (2, 4, 50, 32))
    want = _xla_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                          None, JPrecision.fast())
    got = attention._math_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), None,
        Precision.fast())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1.6e-2, atol=1.6e-2)


def test_encoder_attention_cpu_auto_is_math_path(rng):
    """On a CPU tensor "auto" takes the math path, as JAX does off-TPU."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _arrays(rng, (2, 17, 128)))
    got = attention.encoder_attention(q, k, v, heads=2, mask=None,
                                      precision=Precision.fast())
    split = [t.reshape(2, 17, 2, 64).transpose(1, 2) for t in (q, k, v)]
    want = attention._math_attention(*split, None, Precision.fast())
    torch.testing.assert_close(got, want.transpose(1, 2).reshape(2, 17, 128),
                               rtol=0, atol=0)


def test_forced_bsd_masked_falls_back_to_math(rng):
    b, s, d, heads = 2, 16, 128, 2
    q, k, v = (torch.from_numpy(a) for a in _arrays(rng, (b, s, d)))
    mask = torch.zeros((b, 1, s, s))
    forced = dataclasses.replace(Precision.parity(), attn_impl="pallas_bsd")
    got = attention.encoder_attention(q, k, v, heads=heads, mask=mask,
                                      precision=forced)
    want = attention.encoder_attention(q, k, v, heads=heads, mask=mask,
                                       precision=Precision.parity())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,heads", [(128, 48), (96, 2), (192, 3)])
def test_forced_bsd_bad_shapes_raise(d, heads):
    """The same ValueError as the JAX routing: heads | D, Dh | 128, 128 | D."""
    q = torch.zeros((2, 16, d))
    forced = dataclasses.replace(Precision.parity(), attn_impl="pallas_bsd")
    with pytest.raises(ValueError, match="heads"):
        attention.encoder_attention(q, q, q, heads=heads, mask=None,
                                    precision=forced)
    with pytest.raises(ValueError, match="heads"):
        attention.bsd_attention(q, q, q, heads)


@pytest.mark.parametrize("impl", ["pallas", "pallas_mh", "pallas_batched",
                                  "flash", "pallas_bsd_vjp"])
def test_unported_attn_impls_raise(impl):
    q = torch.zeros((1, 8, 128))
    prec = dataclasses.replace(Precision.parity(), attn_impl=impl)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        attention.encoder_attention(q, q, q, heads=2, mask=None,
                                    precision=prec)
    # masked (text-tower) calls take the math path, as in the JAX package
    out = attention.encoder_attention(q, q, q, heads=2,
                                      mask=torch.zeros((1, 1, 8, 8)),
                                      precision=prec)
    assert out.shape == q.shape
