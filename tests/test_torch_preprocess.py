"""The port's ``ops/preprocess.py`` against the JAX package's on the CPU:
the resize matrices, the device resize + normalize and the host crop, at
fp32 ``rtol=2e-4, atol=2e-5``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcm_tpu.ops import preprocess as jpre
from mcm_tpu_torch.ops import preprocess as tpre

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("in_size,out_size", [(300, 224), (224, 224),
                                              (100, 224), (513, 37), (5, 3)])
def test_resize_matrix_matches_jax(in_size, out_size):
    got = tpre.resize_matrix(in_size, out_size)
    want = jpre.resize_matrix(in_size, out_size)
    assert got.shape == want.shape == (out_size, in_size)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)
    assert not got.flags.writeable


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side,out_size", [(256, 224), (160, 224), (96, 40)])
def test_resize_normalize_matches_jax(rng, side, out_size, dtype):
    u8 = rng.integers(0, 256, size=(2, side, side, 3), dtype=np.uint8)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jpre.resize_normalize(jnp.asarray(u8),
                                            out_size=out_size, dtype=jdt),
                      np.float32)
    got = tpre.resize_normalize(torch.from_numpy(u8), out_size=out_size,
                                dtype=dtype)
    assert got.dtype == dtype and got.shape == (2, out_size, out_size, 3)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:   # one bf16 rounding of fp32 values that agree to TOL
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1.6e-2,
                                   atol=1.6e-2)


@pytest.mark.parametrize("h,w", [(300, 400), (401, 300), (224, 224),
                                 (7, 12)])
def test_center_square_crop_matches_jax(rng, h, w):
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    got = tpre.center_square_crop_u8(img)
    np.testing.assert_array_equal(got, jpre.center_square_crop_u8(img))
    assert got.shape == (min(h, w), min(h, w), 3)


def test_crop_then_resize_close_to_the_pil_pipeline(rng):
    """The device-resize route (crop the square, resize on the device)
    lands within the JAX module's ≤ 1/255-scale budget of the host
    pipeline on a smooth image."""
    from PIL import Image

    from mcm_tpu_torch.data.transforms import normalize_on_device, preprocess_uint8
    base = rng.integers(0, 256, size=(12, 16, 3), dtype=np.uint8)
    img = Image.fromarray(base).resize((400, 300), Image.BICUBIC)
    host = normalize_on_device(torch.from_numpy(
        np.array(preprocess_uint8(img, 224)[None])))
    sq = tpre.center_square_crop_u8(np.asarray(img))
    dev = tpre.resize_normalize(torch.from_numpy(np.ascontiguousarray(sq)[None]))
    # a pixel unit is 1/(255·std) ≈ 0.0146 after the normalize
    assert float((dev - host).abs().mean()) < 0.0146
