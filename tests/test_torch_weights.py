"""Weights in the port: the numpy init, the .npz tree and from_jax_params,
held against the JAX package's loader on the golden config."""

import numpy as np
import pytest
import torch

from mcm_tpu.models import convert as jconvert
from mcm_tpu.models import init as jinit
from mcm_tpu.models.hf_synth import golden_config, synth_hf_clip_state_dict

from mcm_tpu_torch import config as tconfig
from mcm_tpu_torch.models import convert as tconvert
from mcm_tpu_torch.models import init as tinit
from util_cfg import port_config


@pytest.fixture(scope="module")
def golden_params():
    cfg = golden_config()
    return jconvert.convert_hf_clip(synth_hf_clip_state_dict(cfg, seed=0), cfg)


def _tconfig(jcfg):
    """The port's config with the JAX config's fields."""
    return port_config(jcfg)


def test_npz_round_trip_matches_jax_loader(golden_params, tmp_path):
    """JAX save → port load, and port save → JAX load: same keys, shapes
    and values as the JAX loader reads."""
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jconvert.save_params(golden_params, jpath)
    tconvert.save_params(golden_params, tpath)
    want = jconvert._flatten(jconvert.load_params(jpath))
    for got in (tconvert._flatten(tconvert.load_params(jpath)),
                jconvert._flatten(jconvert.load_params(tpath))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_from_jax_params_keys_and_shapes(golden_params, dtype):
    """Every leaf of the JAX tree becomes one parameter of the same shape
    under the same path; matrices and embeddings take ``dtype``, LayerNorm
    parameters, biases and logit_scale stay fp32."""
    model = tconvert.from_jax_params(golden_params, "cpu", dtype)
    flat = jconvert._flatten(golden_params)
    got = {k.replace(".", "/"): v for k, v in model.state_dict().items()}
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        assert tuple(got[k].shape) == v.shape, k
        leaf = k.rsplit("/", 1)[-1]
        fp32_leaf = leaf in ("scale", "bias", "logit_scale") or leaf[0] == "b"
        assert got[k].dtype == (torch.float32 if fp32_leaf else dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      torch.from_numpy(v).to(got[k].dtype)
                                      .float().numpy())
    assert model["vision"]["layers"]["attn"]["wq"].shape == \
        flat["vision/layers/attn/wq"].shape


def test_init_clip_matches_jax_init():
    """One int seed gives bit-identical weights in both packages."""
    jcfg = golden_config()
    want = jconvert._flatten(jinit.init_clip(3, jcfg))
    got = tconvert._flatten(tinit.init_clip(3, _tconfig(jcfg)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    seq = np.random.SeedSequence(11)
    np.testing.assert_array_equal(
        tinit.init_clip(seq, _tconfig(jcfg))["text"]["proj"],
        jinit.init_clip(np.random.SeedSequence(11), jcfg)["text"]["proj"])
    with pytest.raises(TypeError, match="SeedSequence"):
        tinit.init_clip("0", _tconfig(jcfg))


def test_resolve_clip_params_npz_only(golden_params, tmp_path):
    assert tconvert.resolve_clip_params("ViT-B/16", str(tmp_path)) is None
    tconvert.save_params(golden_params, str(tmp_path / "ViT-B-16.npz"))
    got = tconvert.resolve_clip_params("ViT-B/16", str(tmp_path))
    np.testing.assert_array_equal(got["vision"]["proj"],
                                  golden_params["vision"]["proj"])
    # an OpenAI .pt beside it is converted now: an unreadable one raises
    # instead of being skipped for random weights
    (tmp_path / "ViT-B-32.pt").write_bytes(b"")
    with pytest.raises(RuntimeError, match="neither"):
        tconvert.resolve_clip_params("ViT-B/32", str(tmp_path))


def test_cuda_device_without_card_raises():
    """Entry points never fall back to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA device is valid here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tconfig.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconvert.from_jax_params({"logit_scale": np.float32(1.0)})
    assert tconfig.resolve_device("cpu") == torch.device("cpu")
