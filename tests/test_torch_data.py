"""The port's host pipeline and on-device normalize against the JAX
package's on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcm_tpu.data.folder import ImageFolder as JImageFolder
from mcm_tpu.data.pipeline import DataPipeline as JDataPipeline
from mcm_tpu.data.transforms import normalize_on_device as jnormalize

from mcm_tpu_torch.data import DataPipeline, ImageFolder, normalize_on_device
from util_synth import make_imagefolder_tree


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalize_on_device_matches_jax(rng, dtype):
    """One fp32 multiply-add then a cast: fp32 equal to 1 ulp, bf16 equal
    to one bf16 rounding of the same fp32 value."""
    u8 = rng.integers(0, 256, size=(2, 8, 8, 3), dtype=np.uint8)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jnormalize(jnp.asarray(u8), dtype=jdt), np.float32)
    got = normalize_on_device(torch.from_numpy(u8), dtype=dtype)
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1.6e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("batch_size,drop", [(4, False), (5, False),
                                             (4, True)])
def test_pipeline_batches_match_jax_pil_pipeline(tmp_path, batch_size, drop):
    """Same uint8 pixels (both through PIL), labels, padding rows and
    ``valid`` counts as the JAX pipeline with its native decoder off."""
    root = make_imagefolder_tree(str(tmp_path / "tree"), ["a", "b", "c"],
                                 per_class=3, seed=2)
    kw = dict(image_size=32, num_workers=2, drop_remainder=drop)
    want = list(JDataPipeline(JImageFolder(root), batch_size,
                              use_native=False, **kw))
    got = list(DataPipeline(ImageFolder(root), batch_size, **kw))
    assert len(got) == len(want) == (9 // batch_size if drop
                                     else -(-9 // batch_size))
    for g, w in zip(got, want):
        assert g.valid == w.valid
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
