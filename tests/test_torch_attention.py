"""The port's attention against the JAX package's on the CPU: the bsd and
split-heads kernels' plain versions against the Pallas kernels in
interpret mode, the math path against ``_xla_attention``, and the
routing."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mcm_tpu.config import Precision as JPrecision
from mcm_tpu.ops import attention as jattention
from mcm_tpu.ops.attention import (_pallas_attention,
                                   _pallas_batched_attention,
                                   _pallas_bsd_attention, _xla_attention)

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


@pytest.mark.parametrize("s", [16, 17, 65, 197])
def test_bsd_plain_matches_pallas_kernel_bf16(rng, s):
    """bf16 inputs: both round q·scale and p to bf16; outputs within one
    bf16 ulp at |x| ≤ 4 (1.6e-2).  S at the card kernel's tile and chunk
    edges (16-row tiles, 16-key steps, 64-key chunks) and ViT-B/16's 197."""
    q, k, v = _arrays(rng, (2, s, 256))
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


@pytest.mark.parametrize("impl", ["flash", "pallas_bsd_vjp"])
def test_unported_attn_impls_raise(rng, impl):
    """Both are ported.  ``flash``: an unmasked call goes through
    ``flash_attention`` on the split heads (its plain version on a CPU
    tensor, no launch).  ``pallas_bsd_vjp`` (trainable bsd attention): an
    unmasked call on a CPU tensor is the math path, bit for bit, with no
    bsd launch.  Masked (text-tower) calls take the math path for both, as
    in the JAX package."""
    q, k, v = (torch.from_numpy(a) for a in _arrays(rng, (1, 8, 128)))
    prec = dataclasses.replace(Precision.parity(), attn_impl=impl)
    if impl == "flash":
        before = attention.flash_attention.launches
        got = attention.encoder_attention(q, k, v, heads=2, mask=None,
                                          precision=prec)
        assert attention.flash_attention.launches == before
        split = [t.reshape(1, 8, 2, 64).transpose(1, 2) for t in (q, k, v)]
        want = attention.flash_attention_reference(*split)
        torch.testing.assert_close(got, want.transpose(1, 2).reshape(1, 8, 128),
                                   rtol=0, atol=0)
    else:
        before = attention.bsd_attention.launches
        got = attention.encoder_attention(q, k, v, heads=2, mask=None,
                                          precision=prec)
        assert attention.bsd_attention.launches == before
        want = attention.encoder_attention(q, k, v, heads=2, mask=None,
                                           precision=Precision.parity())
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    mask = torch.zeros((1, 1, 8, 8))
    out = attention.encoder_attention(q, k, v, heads=2, mask=mask,
                                      precision=prec)
    torch.testing.assert_close(out, attention.encoder_attention(
        q, k, v, heads=2, mask=mask, precision=Precision.parity()),
        rtol=0, atol=0)


# -- split-heads kernels ------------------------------------------------------

def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("shape", [(2, 4, 197, 64), (1, 2, 50, 32),
                                   (2, 3, 257, 64)])
def test_split_plain_matches_pallas_kernel(rng, shape):
    """fp32 at 2e-5, as ``test_pallas_attention_matches_xla`` holds the
    kernel (S = 257 runs two query tiles of 256)."""
    q, k, v = _arrays(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    got = attention.split_attention_reference(*_torch((q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,block_bh", [((2, 4, 197, 64), 4),
                                            ((2, 3, 50, 32), 4),
                                            ((1, 2, 120, 64), 2)])
def test_split_plain_matches_pallas_batched_kernel(rng, shape, block_bh):
    """fp32 at 2e-5, including the (b·h % block_bh != 0) tail group (2·3 =
    6 pairs in blocks of 4)."""
    q, k, v = _arrays(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_batched_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), block_bh=block_bh)
    got = attention.split_attention_reference(*_torch((q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s", [16, 17, 65, 197])
@pytest.mark.parametrize("jax_kernel", ["pallas", "pallas_batched"])
def test_split_plain_matches_pallas_kernels_bf16(rng, jax_kernel, s):
    """bf16 inputs: both round q·scale and p to bf16; outputs within one
    bf16 ulp at |x| ≤ 4 (1.6e-2).  S as in the bsd test above."""
    q, k, v = _arrays(rng, (2, 2, s, 64))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = (_pallas_attention(jq, jk, jv) if jax_kernel == "pallas"
                else _pallas_batched_attention(jq, jk, jv, block_bh=4))
    got = attention.split_attention_reference(*_torch((q, k, v),
                                                      torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1.6e-2, atol=1.6e-2)


@pytest.mark.parametrize("shape", [(2, 12, 197, 64), (1, 16, 257, 64)])
def test_split_plain_matches_xla_for_pallas_mh(rng, shape):
    """``_pallas_mh_attention`` cannot be run here: its in-kernel
    ``fori_loop`` hangs Pallas interpret mode (``tests/test_ops.py`` skips
    it off-TPU for that reason).  Its TPU kernel has the numerics of
    ``_pallas_attention``, so the plain version that the ``pallas_mh``
    launch shape is held to is held to ``_xla_attention`` in parity mode,
    at the 2e-5 that ``tests/test_ops.py`` holds the split-heads kernels
    to.  H = 16 is L/14's head count, whose tail group the kernel clamps."""
    q, k, v = _arrays(rng, shape)
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None, JPrecision.parity())
    got = attention.split_attention_reference(*_torch((q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


_SPLIT_WRAPPERS = {"pallas": "pallas_attention", "pallas_mh": "mh_attention",
                   "pallas_batched": "batched_attention"}


@pytest.mark.parametrize("impl", ["pallas", "pallas_mh", "pallas_batched"])
def test_split_impls_route_to_plain_version_on_cpu(rng, impl):
    """On CPU tensors each name takes its wrapper, which runs the plain
    version with no launch; the result is the split heads' reference."""
    b, s, d, heads = 2, 17, 128, 4
    q, k, v = _torch(_arrays(rng, (b, s, d)))
    wrapper = getattr(attention, _SPLIT_WRAPPERS[impl])
    before = {n: getattr(attention, n).launches
              for n in _SPLIT_WRAPPERS.values()}
    prec = dataclasses.replace(Precision.parity(), attn_impl=impl)
    got = attention.encoder_attention(q, k, v, heads=heads, mask=None,
                                      precision=prec)
    assert {n: getattr(attention, n).launches
            for n in _SPLIT_WRAPPERS.values()} == before
    split = [t.reshape(b, s, heads, d // heads).transpose(1, 2)
             for t in (q, k, v)]
    want = attention.split_attention_reference(*split)
    torch.testing.assert_close(got, want.transpose(1, 2).reshape(b, s, d),
                               rtol=0, atol=0)
    torch.testing.assert_close(wrapper(*split), want, rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["pallas", "pallas_mh", "pallas_batched"])
def test_split_impls_masked_take_math_path(rng, impl):
    """A masked (text-tower) call takes the math path, as in JAX: the same
    result as ``attn_impl="xla"`` and as the JAX package's routing."""
    b, s, d, heads = 2, 16, 128, 2
    q, k, v = _arrays(rng, (b, s, d))
    mask = np.broadcast_to(np.triu(np.full((s, s), -1e9, np.float32), 1),
                           (b, 1, s, s)).copy()
    prec = dataclasses.replace(Precision.parity(), attn_impl=impl)
    got = attention.encoder_attention(*_torch((q, k, v)), heads=heads,
                                      mask=torch.from_numpy(mask),
                                      precision=prec)
    want = attention.encoder_attention(
        *_torch((q, k, v)), heads=heads, mask=torch.from_numpy(mask),
        precision=Precision.parity())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jwant = jattention.encoder_attention(
        *(jnp.asarray(a) for a in (q, k, v)), heads=heads,
        mask=jnp.asarray(mask),
        precision=dataclasses.replace(JPrecision.parity(), attn_impl=impl))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["pallas_attention", "mh_attention",
                                  "batched_attention"])
def test_split_wrappers_refuse_what_the_kernel_does_not_take(name):
    fn = getattr(attention, name)
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match=r"\[B, H, S, Dh\]"):
        fn(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fn(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="power of two"):
        fn(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(ValueError, match="positive"):
        fn(q, q, q, 0)


@pytest.mark.parametrize("masked", [False, True])
def test_unknown_attn_impl_takes_math_path_as_jax(rng, masked):
    """An unknown name computes the math path in both packages (JAX:
    ``fused_attention`` falls through to ``_xla_attention``)."""
    b, s, d, heads = 2, 16, 128, 4
    q, k, v = _arrays(rng, (b, s, d))
    mask = None
    if masked:
        mask = np.broadcast_to(np.triu(np.full((s, s), -1e9, np.float32), 1),
                               (b, 1, s, s)).copy()
    want = jattention.encoder_attention(
        *(jnp.asarray(a) for a in (q, k, v)), heads=heads,
        mask=None if mask is None else jnp.asarray(mask),
        precision=dataclasses.replace(JPrecision.parity(),
                                      attn_impl="no_such_impl"))
    got = attention.encoder_attention(
        *_torch((q, k, v)), heads=heads,
        mask=None if mask is None else torch.from_numpy(mask),
        precision=dataclasses.replace(Precision.parity(),
                                      attn_impl="no_such_impl"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
