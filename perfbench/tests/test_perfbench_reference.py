"""The plain reference against two witnesses at a small size on the CPU:
HF ``transformers``' ``CLIPModel`` on the same weights (where
``transformers`` is installed), and the program's own float32 path; its
pixels against PIL's evaluator route; and its float8 control, which has to
fail each cell's limit."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench import compare, modelcfg, pool, spec, tokenizer, weights
from perfbench.reference import clip as ref
from perfbench.reference import pixels

HARNESS = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HARNESS)

SMALL = {
    "vision": {"width": 64, "layers": 2, "heads": 4, "mlp": 256,
               "patch_size": 16, "image_size": 224, "eps": 1e-5,
               "hidden_act": "quick_gelu"},
    "text": {"width": 64, "layers": 2, "heads": 4, "mlp": 256,
             "vocab_size": 49408, "context_length": 77, "eps": 1e-5,
             "hidden_act": "quick_gelu"},
    "embed_dim": 32, "dtype": "bfloat16", "precision": "fast",
}


def _small(act):
    return dict(SMALL, vision=dict(SMALL["vision"], hidden_act=act),
                text=dict(SMALL["text"], hidden_act=act))


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    with open(os.path.join(HARNESS, "traffic", "offline-jpeg.json")) as f:
        mix = json.load(f)["pool"]
    mix = dict(mix, count=12)
    return pool.make_pool(mix, 2**31 + 3, str(tmp_path_factory.mktemp("pool")))


def _hf_state(tree):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    sd = {}
    for tower, pre in (("vision", "vision_model"), ("text", "text_model")):
        lay = tree[tower]["layers"]
        for i in range(lay["ln1"]["scale"].shape[0]):
            p = f"{pre}.encoder.layers.{i}."
            for x, name in zip("qkvo", ("q_proj", "k_proj", "v_proj",
                                        "out_proj")):
                sd[p + f"self_attn.{name}.weight"] = t(lay["attn"][f"w{x}"][i].T)
                sd[p + f"self_attn.{name}.bias"] = t(lay["attn"][f"b{x}"][i])
            for j in (1, 2):
                sd[p + f"layer_norm{j}.weight"] = t(lay[f"ln{j}"]["scale"][i])
                sd[p + f"layer_norm{j}.bias"] = t(lay[f"ln{j}"]["bias"][i])
                sd[p + f"mlp.fc{j}.weight"] = t(lay["mlp"][f"w{j}"][i].T)
                sd[p + f"mlp.fc{j}.bias"] = t(lay["mlp"][f"b{j}"][i])
    v, x = tree["vision"], tree["text"]
    p, w = SMALL["vision"]["patch_size"], SMALL["vision"]["width"]
    sd["vision_model.embeddings.patch_embedding.weight"] = t(
        v["patch_embed"].reshape(p, p, 3, w).transpose(3, 2, 0, 1))
    sd["vision_model.embeddings.class_embedding"] = t(v["class_emb"])
    sd["vision_model.embeddings.position_embedding.weight"] = t(v["pos_emb"])
    for hf, ours in (("pre_layrnorm", "pre_ln"), ("post_layernorm", "post_ln")):
        sd[f"vision_model.{hf}.weight"] = t(v[ours]["scale"])
        sd[f"vision_model.{hf}.bias"] = t(v[ours]["bias"])
    sd["visual_projection.weight"] = t(v["proj"].T)
    sd["text_model.embeddings.token_embedding.weight"] = t(x["token_emb"])
    sd["text_model.embeddings.position_embedding.weight"] = t(x["pos_emb"])
    sd["text_model.final_layer_norm.weight"] = t(x["final_ln"]["scale"])
    sd["text_model.final_layer_norm.bias"] = t(x["final_ln"]["bias"])
    sd["text_projection.weight"] = t(x["proj"].T)
    sd["logit_scale"] = torch.tensor(float(tree["logit_scale"]))
    return sd


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_reference_against_hf_transformers(jpegs, act):
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    small = _small(act)
    v, t = small["vision"], small["text"]
    cfg = transformers.CLIPConfig(
        projection_dim=small["embed_dim"],
        vision_config=dict(hidden_size=v["width"], intermediate_size=v["mlp"],
                           num_hidden_layers=v["layers"],
                           num_attention_heads=v["heads"], image_size=224,
                           patch_size=16, hidden_act=act),
        text_config=dict(vocab_size=t["vocab_size"], hidden_size=t["width"],
                         intermediate_size=t["mlp"],
                         num_hidden_layers=t["layers"],
                         num_attention_heads=t["heads"],
                         max_position_embeddings=77, hidden_act=act,
                         eos_token_id=t["vocab_size"] - 1))
    hf = transformers.CLIPModel(cfg).eval()
    tree = weights.make_weights(SMALL, 11, "cpu")
    missing, unexpected = hf.load_state_dict(_hf_state(tree), strict=False)
    assert not unexpected and all("position_ids" in m for m in missing)
    px = torch.from_numpy(pixels.load_many(jpegs, 224))
    ids, mask = tokenizer.tokenize(
        tokenizer.prompts(tokenizer.class_names()[:40]), t["vocab_size"], 77)
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    tree_t = ref.to_device(tree, "cpu")
    norm = ((px.float() / 255 - torch.tensor(ref.CLIP_MEAN))
            / torch.tensor(ref.CLIP_STD)).permute(0, 3, 1, 2)
    with torch.no_grad():
        want_img = hf.get_image_features(pixel_values=norm)
        want_txt = hf.get_text_features(input_ids=ids_t, attention_mask=mask_t)
        got_img = ref.encode_image(tree_t, small, px)
        got_txt = ref.encode_text(tree_t, small, ids_t, mask_t)
    for got, want in ((got_img, want_img), (got_txt, want_txt)):
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), \
            float((got - want).abs().max())


def test_the_activations_apart_and_an_unknown_one_raises():
    h = torch.linspace(-4, 4, 101)
    assert torch.equal(ref.activation(h, "quick_gelu"),
                       h * torch.sigmoid(1.702 * h))
    assert torch.equal(ref.activation(h, "gelu"),
                       torch.nn.functional.gelu(h))
    assert (ref.activation(h, "gelu") - ref.activation(h, "quick_gelu")
            ).abs().max() > 1e-2
    tree = ref.to_device(weights.make_weights(SMALL, 14, "cpu"), "cpu")
    px = torch.zeros(1, 224, 224, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="'gelu_new'"):
        ref.encode_image(tree, _small("gelu_new"), px)


def test_reference_against_the_programs_float32_path(jpegs):
    from mcm_tpu_torch.config import Precision
    from mcm_tpu_torch.parallel.eval_step import EvalStep
    from mcm_tpu_torch.runner import RunConfig, score_dataset
    cfg_json = dict(json.load(open(os.path.join(HARNESS, "configs",
                                                "clip-vit-b16.json"))))
    cfg_json["vision_config"] = dict(cfg_json["vision_config"],
                                     hidden_size=64, intermediate_size=256,
                                     num_hidden_layers=2, num_attention_heads=4)
    cfg_json["text_config"] = dict(cfg_json["text_config"], hidden_size=64,
                                   intermediate_size=256, num_hidden_layers=2,
                                   num_attention_heads=4)
    cfg_json["projection_dim"] = 32
    dims = modelcfg.dims(cfg_json)
    tree = weights.make_weights(dims, 12, "cpu")
    ids, mask = tokenizer.tokenize(
        tokenizer.prompts(tokenizer.class_names()), 49408, 77)
    step = EvalStep(modelcfg.program_config(cfg_json),
                    precision=Precision.parity(), device="cpu")
    params = step.put_params(tree)
    text = step.encode_text(params, ids, mask)
    os.environ["MCM_TPU_DISABLE_NATIVE"] = "1"   # PIL pixels on both sides
    try:
        got = score_dataset(step, params, [(p, 0) for p in jpegs], text,
                            RunConfig(batch_size=4, device="cpu",
                                      precision="parity"))
    finally:
        del os.environ["MCM_TPU_DISABLE_NATIVE"]
    want = ref.score_of_paths(tree, dims, jpegs, ids, mask, 1.0, "cpu")
    assert compare.worst_relative_gap(got, want) < 1e-5


def test_pixels_are_the_evaluators(jpegs):
    from mcm_tpu_torch.data.transforms import load_image_uint8
    for p in jpegs:
        assert np.array_equal(pixels.load(p, 224), load_image_uint8(p, 224))


def test_control_fails_every_cells_limit(jpegs):
    """The float8 control at a small size: already above each cell's
    limit, which the full-size control passes by more (PERF.md)."""
    tree = weights.make_weights(SMALL, 13, "cpu")
    ids, mask = tokenizer.tokenize(
        tokenizer.prompts(tokenizer.class_names()), 49408, 77)
    want = ref.score_of_paths(tree, SMALL, jpegs, ids, mask, 1.0, "cpu")
    got = ref.score_of_paths(tree, SMALL, jpegs, ids, mask, 1.0, "cpu",
                             gemm="fp8")
    gap = compare.worst_relative_gap(got, want)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for name in cells:
        limit = spec.load(os.path.join(REPO, "BENCHMARK.json"),
                          name).params["limits"]["score_gap"]
        assert gap > limit, (name, gap, limit)
