"""The towers' LayerNorm (``ops/layer_norm.py`` and
``models/clip.py::layer_norm``) on the CPU: the plain version bit-equal to
the chain it replaced, the route's predicate, the wrapper's refusals, and
the counters of each route, through ``layer_norm``, the towers and a
streaming pass.  The kernel runs only on the card
(``tests/test_torch_kernels_gpu.py``); where a test forces the kernel's
route here, a fake launch that writes the plain version stands in for it."""

import numpy as np
import pytest
import torch

from mcm_tpu_torch import config as tconfig
from mcm_tpu_torch.config import Precision
from mcm_tpu_torch.data import ImageFolder
from mcm_tpu_torch.models import clip as tclip
from mcm_tpu_torch.models.convert import from_jax_params
from mcm_tpu_torch.models.init import init_clip
from mcm_tpu_torch.ops import layer_norm as ln
from mcm_tpu_torch.parallel import EvalStep
from mcm_tpu_torch.runner import RunConfig, score_dataset
from mcm_tpu_torch.utils.telemetry import Telemetry
from util_synth import make_imagefolder_tree

#: towers at the kernel's narrowest width, so that the forced route takes
#: every LayerNorm of both
CFG = tconfig.CLIPConfig(
    name="tiny-256",
    vision=tconfig.VisionConfig(image_size=32, patch_size=8, width=256,
                                layers=2, heads=4, projection_dim=32),
    text=tconfig.TextConfig(vocab_size=128, context_length=16, width=256,
                            layers=2, heads=4, projection_dim=32))
#: LayerNorms of a vision batch (pre-LN, two a layer, post-LN on the CLS
#: rows) and of a text batch (two a layer, final LN)
VISION_LNS = 2 * CFG.vision.layers + 2
TEXT_LNS = 2 * CFG.text.layers + 1


def _layer_norm_before(x, scale, bias, eps):
    """``models/clip.py::layer_norm`` before the kernel, as it was."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def _operands(shape, dtype=torch.bfloat16, seed=0, offset=0.0):
    """x of ``shape`` in ``dtype`` (values of a few units around
    ``offset``), fp32 scale and bias of its width."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy((offset + 2.0 * rng.standard_normal(shape))
                         .astype(np.float32)).to(dtype)
    scale = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(c))
                             .astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    return x, scale, bias


def _fake_launch(x, scale, bias, out, rows, stride, eps):
    out.copy_(ln.layer_norm_reference(x, scale, bias, eps))


@pytest.fixture
def forced(monkeypatch):
    """Every tensor counts as on the card and the launch writes the plain
    version: the kernel's route, minus the kernel."""
    monkeypatch.setattr(ln, "_on_card", lambda t: True)
    monkeypatch.setattr(ln, "_launch", _fake_launch)


def _bits_equal(got, want):
    return got.dtype == want.dtype and torch.equal(
        got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
        want.view(torch.int16) if want.dtype == torch.bfloat16 else want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("shape,offset", [((2, 5, 64), 0.0), ((3, 48), 0.0),
                                          ((2, 7, 256), 0.0),
                                          ((4, 512), 300.0)])
def test_plain_version_is_the_chain_it_replaced(dtype, eps, shape, offset):
    x, scale, bias = _operands(shape, dtype, offset=offset)
    got = ln.layer_norm_reference(x, scale, bias, eps)
    assert got.dtype == dtype
    assert _bits_equal(got, _layer_norm_before(x, scale, bias, eps))
    routed = tclip.layer_norm(x, scale, bias, eps)
    assert _bits_equal(routed, got)


def test_plain_version_on_strided_cls_rows():
    x, scale, bias = _operands((3, 5, 256))
    cls = x[:, 0, :]
    assert not cls.is_contiguous()
    assert _bits_equal(ln.layer_norm_reference(cls, scale, bias, 1e-5),
                       _layer_norm_before(cls, scale, bias, 1e-5))


def _route_cases():
    """(name, x, scale, bias, route): "kernel" where every condition is
    met, "plain" where the named one is not, "raises" where the route is
    the kernel's and the wrapper refuses the inputs."""
    x, scale, bias = _operands((2, 3, 256))
    flat = torch.zeros(2 * 3 * 256 + 1, dtype=torch.bfloat16)
    return [
        ("all", x, scale, bias, "kernel"),
        ("one row", x[0, 0], scale, bias, "kernel"),
        ("strided CLS rows", x[:, 0, :], scale, bias, "kernel"),
        ("widest", torch.zeros(2, 2048, dtype=torch.bfloat16),
         torch.ones(2048), torch.zeros(2048), "kernel"),
        ("fp32 rows", x.float(), scale, bias, "plain"),
        ("fp16 rows", x.half(), scale, bias, "plain"),
        ("width below 256", torch.zeros(2, 128, dtype=torch.bfloat16),
         torch.ones(128), torch.zeros(128), "plain"),
        ("width off 128", torch.zeros(2, 320, dtype=torch.bfloat16),
         torch.ones(320), torch.zeros(320), "plain"),
        ("width above 2048", torch.zeros(2, 2176, dtype=torch.bfloat16),
         torch.ones(2176), torch.zeros(2176), "plain"),
        ("strided last dimension",
         torch.zeros(2, 512, dtype=torch.bfloat16)[:, ::2], scale, bias,
         "plain"),
        ("rows at two strides", x.transpose(0, 1), scale, bias, "plain"),
        ("rows off 8-byte alignment", flat[1:].view(2, 3, 256), scale, bias,
         "plain"),
        ("bf16 scale", x, scale.bfloat16(), bias, "raises"),
        ("scale of another width", x, torch.ones(512), bias, "raises"),
        ("non-contiguous bias", x, scale, torch.zeros(512)[::2], "raises"),
    ]


@pytest.mark.parametrize("case", range(len(_route_cases())))
def test_route_needs_every_condition(forced, case):
    name, x, scale, bias, route = _route_cases()[case]
    assert ln.takes_kernel(x, scale, bias) == (route != "plain"), name
    if route == "raises":
        with pytest.raises(ValueError):
            ln.layer_norm(x, scale, bias, 1e-5)
    elif route == "kernel":
        before = ln.layer_norm.launches
        got = ln.layer_norm(x, scale, bias, 1e-5)
        assert ln.layer_norm.launches == before + 1
        assert got.is_contiguous()
        assert _bits_equal(got, _layer_norm_before(x, scale, bias, 1e-5))


def test_route_on_the_cpu_is_plain():
    assert not ln.takes_kernel(*_operands((2, 3, 256)))


def test_route_is_plain_while_autograd_records(forced):
    x, scale, bias = _operands((2, 3, 256))
    scale.requires_grad_(True)
    assert not ln.takes_kernel(x, scale, bias)
    with torch.no_grad():
        assert ln.takes_kernel(x, scale, bias)
    scale.requires_grad_(False)
    assert ln.takes_kernel(x, scale, bias)
    recorded = x.float().requires_grad_(True).bfloat16()
    assert not ln.takes_kernel(recorded, scale, bias)


def _bad_calls():
    x, scale, bias = _operands((3, 256))
    return [
        ("fp32 rows", (x.float(), scale, bias)),
        ("fp16 scale", (x, scale.half(), bias)),
        ("bf16 bias", (x, scale, bias.bfloat16())),
        ("width below 256", (torch.zeros(3, 128, dtype=torch.bfloat16),
                             torch.ones(128), torch.zeros(128))),
        ("width off 128", (torch.zeros(3, 384 + 64, dtype=torch.bfloat16),
                           torch.ones(448), torch.zeros(448))),
        ("scalar rows", (torch.zeros((), dtype=torch.bfloat16), scale, bias)),
        ("2-D scale", (x, scale[None], bias)),
        ("bias of another width", (x, scale, torch.zeros(512))),
        ("rows at two strides",
         (torch.zeros(4, 3, 256, dtype=torch.bfloat16).transpose(0, 1), scale,
          bias)),
        ("strided last dimension",
         (torch.zeros(3, 512, dtype=torch.bfloat16)[:, ::2], scale, bias)),
    ]


@pytest.mark.parametrize("call", range(len(_bad_calls())))
def test_wrapper_refuses(call):
    name, args = _bad_calls()[call]
    with pytest.raises(ValueError):
        ln.layer_norm(*args, 1e-5)


def test_wrapper_on_the_cpu_is_the_plain_version_and_launches_nothing():
    x, scale, bias = _operands((2, 3, 512))
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, scale, bias, 1e-12)
    assert _bits_equal(got, ln.layer_norm_reference(x, scale, bias, 1e-12))
    assert ln.layer_norm.launches == before


def test_empty_rows_launch_nothing(forced):
    x = torch.zeros(0, 256, dtype=torch.bfloat16)
    before = ln.layer_norm.launches
    got = ln.layer_norm(x, torch.ones(256), torch.zeros(256), 1e-5)
    assert got.shape == (0, 256) and ln.layer_norm.launches == before


@pytest.mark.parametrize("rows,c,exact", [
    (131584, 1024, True),     # ViT-L/14 at B = 512
    (131584, 1664, True),     # ViT-bigG/14 at B = 512: R·C = 3341 · 2^16
    (77000, 1280, True),      # 1,000 prompts of 77 tokens in bigG's text
    # R·C = 13 · 1290559 · 2^7, an odd part above 2^24: float(R·C) rounds,
    # and ATen's factor is not float(1 / C)
    (1290559, 1664, False),
])
def test_mean_factor_is_atens(rows, c, exact):
    """``float(outputs) / float(numel)`` in fp32: float(1 / C) wherever
    R·C is exact in fp32, and otherwise what the rounded numel gives."""
    got = np.float32(ln.mean_factor(rows, c))
    assert got == np.float32(rows) / np.float32(rows * c)
    assert (got == np.float32(1.0) / np.float32(c)) == exact


def _totals():
    """(kernel launches, ``models.clip.layer_norm`` calls on the plain
    chain) so far."""
    return ln.layer_norm.launches, tclip.layer_norm.plain


def test_layer_norm_counts_each_route(forced):
    x, scale, bias = _operands((2, 3, 256))
    launched, plain = _totals()
    tclip.layer_norm(x, scale, bias, 1e-5)
    assert _totals() == (launched + 1, plain)
    tclip.layer_norm(x.float(), scale, bias, 1e-5)
    assert _totals() == (launched + 1, plain + 1)


@pytest.fixture(scope="module")
def tiny_model():
    return init_clip(7, CFG)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_towers_count_their_layer_norms(request, tiny_model, route):
    """Both towers in bf16: each LayerNorm is one launch on the kernel's
    route (the post-LN on the strided CLS rows too) and one plain chain
    otherwise, with the same features."""
    if route == "kernel":
        request.getfixturevalue("forced")
    params = from_jax_params(tiny_model, "cpu", torch.bfloat16)
    pixels = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 32, 32, 3)).astype(np.float32))
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        1, 127, (4, 16)))
    fast = Precision.fast()
    launched, plain = _totals()
    img = tclip.encode_image(params, CFG.vision, pixels, fast)
    txt = tclip.encode_text(params, CFG.text, ids, precision=fast)
    n = VISION_LNS + TEXT_LNS
    assert _totals() == ((launched + n, plain) if route == "kernel"
                         else (launched, plain + n))
    assert img.shape == (3, 32) and txt.shape == (4, 32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = make_imagefolder_tree(str(tmp_path_factory.mktemp("ln") / "t"),
                                 ["a", "b"], per_class=4, seed=3)
    return list(ImageFolder(root))


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_score_dataset_reports_the_routes(request, tiny_model, tree, route):
    if route == "kernel":
        request.getfixturevalue("forced")
    step = EvalStep(CFG, score="MCM", T=1.0, precision=Precision.fast(),
                    device="cpu")
    params = step.put_params(tiny_model)
    rng = np.random.default_rng(4)
    text = rng.standard_normal((5, 32)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    cfg = RunConfig(batch_size=4, num_workers=2, prefetch=2, image_size=32,
                    device="cpu", precision="fast")
    tel = Telemetry()
    scores = score_dataset(step, params, tree, step.put_replicated(text), cfg,
                           tel)
    lns = len(tree) // 4 * VISION_LNS
    assert scores.shape == (len(tree),) and np.isfinite(scores).all()
    want = ({"towers.layer_norm": 0, "towers.layer_norm_plain": lns}
            if route == "plain" else
            {"towers.layer_norm": lns, "towers.layer_norm_plain": 0})
    assert {k: tel.counters[k] for k in want} == want
    report = tel.report()
    for name, n in want.items():
        assert f"{name} {n}" in report
