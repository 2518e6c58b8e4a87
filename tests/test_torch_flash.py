"""The port's flash attention against the JAX package's on the CPU: the
flash kernel's plain version against ``_flash_attention`` (jax's TPU flash
kernel) in interpret mode, the ``attn_impl="flash"`` routing of
``encoder_attention`` and of the tiny CLIP's image tower against JAX's, and
the wrapper's checks."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mcm_tpu.config import CLIPConfig, TextConfig, VisionConfig
from mcm_tpu.config import Precision as JPrecision
from mcm_tpu.models import clip as jclip
from mcm_tpu.models.init import init_clip
from mcm_tpu.ops import attention as jattention
from mcm_tpu.ops.attention import _flash_attention

from mcm_tpu_torch.config import Precision
from mcm_tpu_torch.models import clip as tclip
from mcm_tpu_torch.models.convert import from_jax_params
from mcm_tpu_torch.ops import attention
from util_cfg import port_tower


def _arrays(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax_flash(arrays, dtype=jnp.float32):
    with pltpu.force_tpu_interpret_mode():
        out = _flash_attention(*(jnp.asarray(a, dtype) for a in arrays))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape", [(2, 4, 197, 64), (1, 2, 120, 64)])
def test_flash_plain_matches_jax_fp32(rng, shape):
    """fp32 at 2e-5, as ``tests/test_ops.py`` holds the JAX wrapper to the
    XLA path (S = 197 and 120 pad to one 256 / 128-key block)."""
    q, k, v = _arrays(rng, shape)
    got = attention.flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), _jax_flash((q, k, v)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 4, 197, 64), (1, 2, 120, 64),
                                   (1, 2, 129, 64), (1, 2, 512, 64)])
def test_flash_plain_matches_jax_bf16(rng, shape):
    """bf16 inputs: both round p / l to bf16 before PV; outputs within one
    bf16 ulp at |x| ≤ 4 (1.6e-2).  S = 129 and 512 pad to 256 and 512 keys,
    one whole-sequence block each: JAX's single step, the numerics the
    tensor-core flash kernel computes (the block loop starts past 512)."""
    q, k, v = _arrays(rng, shape)
    got = attention.flash_attention_reference(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               _jax_flash((q, k, v), jnp.bfloat16),
                               rtol=1.6e-2, atol=1.6e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
def test_flash_plain_matches_jax_multi_block(rng, dtype, tol):
    """S = 600 pads to 640 > 512: JAX loops over five 128-key blocks with a
    running max and sum (the last block holds 88 keys and 40 masked ones);
    the plain version runs the same loop."""
    q, k, v = _arrays(rng, (1, 2, 600, 64))
    got = attention.flash_attention_reference(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _jax_flash((q, k, v), jdt),
                               rtol=tol, atol=tol)


def test_flash_kv_len_is_jax_padding(rng):
    """Padding to 256 and attending to the first 197 keys (``kv_len``) is
    what JAX's wrapper does with segment ids: the same values."""
    q, k, v = _arrays(rng, (2, 2, 197, 64))
    pad = [torch.nn.functional.pad(torch.from_numpy(a), (0, 0, 0, 59))
           for a in (q, k, v)]
    got = attention.flash_attention_reference(*pad, kv_len=197)[:, :, :197]
    np.testing.assert_allclose(got.numpy(), _jax_flash((q, k, v)),
                               rtol=2e-5, atol=2e-5)


def test_flash_kv_len_is_jax_padding_bf16(rng):
    """bf16 at S = 256 with the keys past 197 masked (the shootout's
    ``flash_pad256_mask``): JAX pads 197 to one 256-key block, rounds
    p / l to bf16 and masks the tail keys; the plain version with
    ``kv_len = 197`` agrees within one bf16 ulp at |x| ≤ 4 (1.6e-2)."""
    q, k, v = _arrays(rng, (2, 2, 197, 64))
    pad = [torch.nn.functional.pad(torch.from_numpy(a), (0, 0, 0, 59))
           .bfloat16() for a in (q, k, v)]
    got = attention.flash_attention_reference(*pad, kv_len=197)[:, :, :197]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               _jax_flash((q, k, v), jnp.bfloat16),
                               rtol=1.6e-2, atol=1.6e-2)


def test_flash_wrapper_on_cpu_is_the_plain_version(rng):
    q, k, v = (torch.from_numpy(a) for a in _arrays(rng, (2, 3, 40, 32)))
    before = attention.flash_attention.launches
    got = attention.flash_attention(q, k, v)
    got_kv = attention.flash_attention(q, k, v, kv_len=17)
    assert attention.flash_attention.launches == before   # no kernel launch
    torch.testing.assert_close(got, attention.flash_attention_reference(
        q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(got_kv, attention.flash_attention_reference(
        q, k, v, 17), rtol=0, atol=0)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match=r"\[B, H, S, Dh\]"):
        attention.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attention.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="power of two"):
        attention.flash_attention(q[..., :48], q[..., :48], q[..., :48])
    for kv_len in (0, 9):
        with pytest.raises(ValueError, match="kv_len"):
            attention.flash_attention(q, q, q, kv_len=kv_len)


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_attention_flash_matches_jax(rng, masked):
    """``attn_impl="flash"`` through ``encoder_attention`` in both packages
    (JAX's flash kernel in interpret mode; masked calls take the math path
    in both), parity mode at 2e-5."""
    b, s, d, heads = 2, 50, 256, 4
    q, k, v = _arrays(rng, (b, s, d))
    mask = None
    if masked:
        mask = np.broadcast_to(np.triu(np.full((s, s), -1e9, np.float32), 1),
                               (b, 1, s, s)).copy()
    with pltpu.force_tpu_interpret_mode():
        want = jattention.encoder_attention(
            *(jnp.asarray(a) for a in (q, k, v)), heads=heads,
            mask=None if mask is None else jnp.asarray(mask),
            precision=dataclasses.replace(JPrecision.parity(),
                                          attn_impl="flash"))
    got = attention.encoder_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), heads=heads,
        mask=None if mask is None else torch.from_numpy(mask),
        precision=dataclasses.replace(Precision.parity(), attn_impl="flash"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


TINY = CLIPConfig(
    name="tiny",
    vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=2,
                        heads=4, projection_dim=32),
    text=TextConfig(vocab_size=128, context_length=16, width=48, layers=2,
                    heads=4, projection_dim=32),
)


def test_encode_image_flash_matches_jax(monkeypatch):
    """The tiny CLIP's image tower with ``attn_impl="flash"`` in parity mode
    against JAX's (whose flash kernel runs in interpret mode) at the
    tower tolerance ``rtol=2e-4, atol=2e-5``; every layer's attention goes
    through ``flash_attention`` (its plain version here: no launch)."""
    jp = init_clip(7, TINY)
    tp = from_jax_params(jp, "cpu", torch.float32)
    tcfg = port_tower(TINY.vision)
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jclip.encode_image(jp, TINY.vision, jnp.asarray(x),
                                  dataclasses.replace(JPrecision.parity(),
                                                      attn_impl="flash"))
    calls = []
    ref = attention.flash_attention_reference

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return ref(*args, **kwargs)

    before = attention.flash_attention.launches
    monkeypatch.setattr(attention, "flash_attention_reference", counted)
    got = tclip.encode_image(tp, tcfg, torch.from_numpy(x),
                             dataclasses.replace(Precision.parity(),
                                                 attn_impl="flash"))
    assert attention.flash_attention.launches == before
    assert calls == [(3, 4, 17, 16)] * TINY.vision.layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)
