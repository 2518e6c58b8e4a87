"""The port's host pipeline and on-device normalize against the JAX
package's on the CPU: the batches equal JAX's bit for bit with PIL on both
sides and with the native decoder on both sides (a PNG and a truncated
JPEG row falling back to PIL, exact and fast mode)."""

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
    ``valid`` counts as the JAX pipeline, both with the native decoder
    off."""
    root = make_imagefolder_tree(str(tmp_path / "tree"), ["a", "b", "c"],
                                 per_class=3, seed=2)
    kw = dict(image_size=32, num_workers=2, drop_remainder=drop,
              use_native=False)
    want = list(JDataPipeline(JImageFolder(root), batch_size, **kw))
    pipe = DataPipeline(ImageFolder(root), batch_size, **kw)
    assert not pipe.use_native
    got = list(pipe)
    assert pipe.pil_rows == (9 // batch_size * batch_size if drop else 9)
    assert len(got) == len(want) == (9 // batch_size if drop
                                     else -(-9 // batch_size))
    for g, w in zip(got, want):
        assert g.valid == w.valid
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)


@pytest.fixture(scope="module")
def mixed_tree(tmp_path_factory):
    """Three classes of JPEGs of several sizes (12), plus a PNG and a truncated
    JPEG, which the native decoder refuses and PIL decodes."""
    from PIL import Image
    root = tmp_path_factory.mktemp("mixed") / "tree"
    make_imagefolder_tree(str(root), ["a", "b", "c"], per_class=3, seed=3)
    rng = np.random.default_rng(4)
    for name, (h, w) in [("big", (375, 500)), ("tall", (300, 200))]:
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(str(root / "a" / f"{name}.jpg"), quality=87)
    Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
                    ).save(str(root / "b" / "img.png"))
    buf = root / "c" / "whole.jpg"
    Image.fromarray(rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
                    ).save(str(buf), quality=90)
    data = buf.read_bytes()
    # the scan cut at half and closed by an EOI marker: libjpeg's
    # premature-end warning fails the native decode, PIL fills grey
    (root / "c" / "trunc.jpg").write_bytes(data[:len(data) // 2]
                                           + b"\xff\xd9")
    return str(root)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("batch_size", [4, 5])
def test_pipeline_batches_match_jax_native_pipeline(mixed_tree, batch_size,
                                                    fast):
    """Native decode on both sides: every batch bit-equal to JAX's, the
    PNG and the truncated row through PIL on both."""
    from mcm_tpu.runtime.native import native_available as j_native
    if not j_native():
        pytest.skip("the JAX package's native decoder does not build here")
    kw = dict(image_size=64, num_workers=3, fast_decode=fast)
    jpipe = JDataPipeline(JImageFolder(mixed_tree), batch_size, **kw)
    pipe = DataPipeline(ImageFolder(mixed_tree), batch_size, **kw)
    assert jpipe.use_native and pipe.use_native and pipe.fast_decode == fast
    want, got = list(jpipe), list(pipe)
    assert len(got) == len(want) == -(-14 // batch_size)
    for g, w in zip(got, want):
        assert g.valid == w.valid
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
    assert pipe.pil_rows == 2


def test_pipeline_fast_decode_needs_the_native_route(mixed_tree,
                                                     monkeypatch):
    with pytest.raises(RuntimeError, match="use_native=False"):
        DataPipeline(ImageFolder(mixed_tree), 4, use_native=False,
                     fast_decode=True)
    monkeypatch.setenv("MCM_TPU_DISABLE_NATIVE", "1")
    with pytest.raises(RuntimeError, match="MCM_TPU_DISABLE_NATIVE"):
        DataPipeline(ImageFolder(mixed_tree), 4, fast_decode=True)
    pipe = DataPipeline(ImageFolder(mixed_tree), 4)
    assert not pipe.use_native
    assert sum(b.valid for b in pipe) == 14 and pipe.pil_rows == 14
