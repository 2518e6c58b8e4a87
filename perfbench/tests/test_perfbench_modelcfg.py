"""A configuration file read three ways: the plain sizes (with each tower's
``hidden_act``), the plain reference its ``reference`` key names, and the
program's config, which is the program's own reading of the published
keys where the program has one."""

import copy
import os

import numpy as np
import pytest

from perfbench import modelcfg, weights

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HARNESS)

#: OpenCLIP ViT-bigG/14's ratios at a CPU size: a vision head of 104, an
#: MLP 4.92 times the width, the exact erf GELU in both towers
BIGG_SHAPED = {
    "name": "tiny-bigg", "program_name": "ViT-bigG/14", "precision": "fast",
    "torch_dtype": "bfloat16", "projection_dim": 64,
    "vision_config": {"hidden_size": 208, "intermediate_size": 1024,
                      "num_hidden_layers": 2, "num_attention_heads": 2,
                      "patch_size": 14, "image_size": 224, "num_channels": 3,
                      "layer_norm_eps": 1e-05, "hidden_act": "gelu"},
    "text_config": {"hidden_size": 128, "intermediate_size": 512,
                    "num_hidden_layers": 2, "num_attention_heads": 2,
                    "max_position_embeddings": 77, "vocab_size": 49408,
                    "layer_norm_eps": 1e-05, "hidden_act": "gelu"},
    "reference": "perfbench/reference/clip.py",
}


def _config(name):
    return modelcfg.load(os.path.join(HARNESS, "configs", name + ".json"))


@pytest.fixture
def without_the_programs_reader(monkeypatch):
    from mcm_tpu_torch import config
    monkeypatch.delattr(config, "clip_config_from_hf", raising=False)


@pytest.mark.parametrize("name", ["clip-vit-b16", "clip-vit-l14"])
def test_each_configuration_is_the_programs_architecture(name):
    from mcm_tpu_torch.config import CLIP_CONFIGS
    cfg = _config(name)
    assert modelcfg.program_config(cfg) == CLIP_CONFIGS[cfg["program_name"]]()


def test_the_programs_reader_decides(monkeypatch):
    from mcm_tpu_torch import config
    seen = []

    def read(cfg, name):
        seen.append((cfg, name))
        return "the program's reading"
    monkeypatch.setattr(config, "clip_config_from_hf", read, raising=False)
    cfg = _config("clip-vit-b16")
    assert modelcfg.program_config(cfg) == "the program's reading"
    assert seen == [(cfg, "ViT-B/16")]


@pytest.mark.parametrize("tower,key,value,named", [
    ("vision_config", "hidden_act", "gelu", "vision_config.hidden_act 'gelu'"),
    ("text_config", "hidden_act", "gelu", "text_config.hidden_act 'gelu'"),
    ("vision_config", "intermediate_size", 8192,
     "vision_config.intermediate_size 8192"),
    ("vision_config", "num_channels", 4, "num_channels 4"),
])
def test_without_the_programs_reader_what_it_cannot_run_is_refused(
        without_the_programs_reader, tower, key, value, named):
    cfg = copy.deepcopy(_config("clip-vit-b16"))
    cfg[tower][key] = value
    if key == "intermediate_size":
        cfg[tower]["hidden_size"] = 1664
    with pytest.raises(ValueError, match=named):
        modelcfg.program_config(cfg)


@pytest.mark.parametrize("tower", ["vision_config", "text_config"])
def test_a_missing_hidden_act_is_an_error(tower):
    cfg = copy.deepcopy(_config("clip-vit-b16"))
    del cfg[tower]["hidden_act"]
    with pytest.raises(KeyError, match="hidden_act"):
        modelcfg.dims(cfg)


def test_a_bigg_shaped_configuration_runs_in_the_reference_alone(
        without_the_programs_reader):
    from perfbench import tokenizer
    d = modelcfg.dims(BIGG_SHAPED)
    assert d["vision"]["hidden_act"] == d["text"]["hidden_act"] == "gelu"
    assert d["vision"]["width"] // d["vision"]["heads"] == 104
    ref = modelcfg.reference(REPO, BIGG_SHAPED)
    tree = weights.make_weights(d, 2**31 + 21, "cpu")
    px = np.random.default_rng(5).integers(0, 256, (3, 224, 224, 3),
                                           dtype=np.uint8)
    ids, mask = tokenizer.tokenize(
        tokenizer.prompts(tokenizer.class_names()[:20]), 49408, 77)
    scores = ref.pool_scores(tree, d, px, ids, mask, 1.0, "cpu")
    assert scores.shape == (3,) and np.isfinite(scores).all()
    with pytest.raises(ValueError, match="hidden_act 'gelu'"):
        modelcfg.program_config(BIGG_SHAPED)


def test_the_reference_is_the_file_the_configuration_names(tmp_path):
    ref = modelcfg.reference(os.path.relpath(REPO), _config("clip-vit-b16"))
    assert os.path.samefile(ref.__file__, os.path.join(HARNESS, "reference",
                                                       "clip.py"))
    assert callable(ref.score_of_paths)
    other = tmp_path / "perfbench" / "reference" / "other.py"
    other.parent.mkdir(parents=True)
    other.write_text("NAME = 'other'\n")
    cfg = dict(BIGG_SHAPED, reference="perfbench/reference/other.py")
    assert modelcfg.reference(str(tmp_path), cfg).NAME == "other"
    for outside in ("../clip.py", "/perfbench/reference/clip.py"):
        with pytest.raises(ValueError, match="inside the checkout"):
            modelcfg.reference(REPO, dict(cfg, reference=outside))
