"""The epilogue of the towers' dense products (``ops/dense_epilogue.py`` and
``models/clip.py::_dense``) on the CPU: the plain path of ``_dense(...,
act=, residual=)`` bit-equal to the composition it replaced, the route's
predicate, the wrapper's refusals, and the counters of each route, through
``_dense`` and through a streaming pass.  The kernel runs only on the card
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
from mcm_tpu_torch.ops import dense_epilogue as epi
from mcm_tpu_torch.ops.numerics import matmul_f32, weak_scalar
from mcm_tpu_torch.parallel import EvalStep
from mcm_tpu_torch.runner import RunConfig, score_dataset
from mcm_tpu_torch.utils.telemetry import Telemetry
from util_synth import make_imagefolder_tree

CFG = tconfig.CLIPConfig(
    name="tiny",
    vision=tconfig.VisionConfig(image_size=32, patch_size=8, width=64,
                                layers=2, heads=4, projection_dim=32),
    text=tconfig.TextConfig(vocab_size=128, context_length=16, width=48,
                            layers=2, heads=4, projection_dim=32))
#: ``_dense`` calls of a vision batch that have a bias (6 a layer) and that
#: have none (``patch_embed``, ``proj``)
BIASED, UNBIASED = 6 * CFG.vision.layers, 2
PRECISIONS = {"fast": Precision.fast(), "parity": Precision.parity()}


def _dense_before(x, w, b, precision):
    """``_dense`` before the epilogue: product, fp32 bias add, one cast."""
    cdt = precision.activation_dtype
    y = matmul_f32(x.to(cdt), w.to(cdt))
    if b is not None:
        y = y + b.float()
    return y.to(cdt)


def _quick_gelu_before(x):
    return x * torch.sigmoid(x * weak_scalar(1.702, x.dtype))


def _operands(dtype, n=9, seed=0):
    """x [2, 5, 7], w [7, n] in ``dtype``, fp32 b [n], residual [2, 5, n]:
    odd widths, values of a few units so QuickGELU sees both tails."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))
    return (t(2, 5, 7, scale=2.0).to(dtype), t(7, n).to(dtype),
            t(n, scale=0.5), t(2, 5, n).to(dtype))


def _fake_launch(acc, b, residual, out, mode):
    act = "quick_gelu" if mode == "bias_quick_gelu" else None
    out.copy_(epi.epilogue_reference(acc, b, torch.bfloat16, act, residual))


@pytest.fixture
def forced(monkeypatch):
    """Every tensor counts as on the card and the launch writes the plain
    version: the kernel's route, minus the kernel."""
    monkeypatch.setattr(epi, "_on_card", lambda t: True)
    monkeypatch.setattr(epi, "_launch", _fake_launch)


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
@pytest.mark.parametrize("mode", ["bias", "quick_gelu", "residual"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_path_is_the_composition_it_replaced(precision, mode,
                                                   with_bias):
    p = PRECISIONS[precision]
    x, w, b, r = _operands(p.activation_dtype)
    b = b if with_bias else None
    if mode == "bias":
        got, want = tclip._dense(x, w, b, p), _dense_before(x, w, b, p)
    elif mode == "quick_gelu":
        got = tclip._dense(x, w, b, p, act="quick_gelu")
        want = _quick_gelu_before(_dense_before(x, w, b, p))
    else:
        got = tclip._dense(x, w, b, p, residual=r)
        want = r + _dense_before(x, w, b, p)
    assert got.dtype == p.activation_dtype
    assert torch.equal(got, want)


def test_forced_route_gives_the_plain_numbers(forced):
    p = Precision.fast()
    x, w, b, r = _operands(torch.bfloat16, n=16)
    for kw in ({}, {"act": "quick_gelu"}, {"residual": r}):
        got = tclip._dense(x, w, b, p, **kw)
        want = epi.epilogue_reference(matmul_f32(x, w), b, torch.bfloat16,
                                      **kw)
        assert torch.equal(got, want)


def test_route_on_the_cpu_is_plain():
    x, w, b, r = _operands(torch.bfloat16)
    assert not epi.takes_kernel(matmul_f32(x, w), b, torch.bfloat16, r)


def _cases():
    """(name, y, b, dtype, residual, route): "kernel" where every condition
    is met, "plain" where the named one is not, "raises" where the route
    is the kernel's and the wrapper refuses the inputs."""
    x, w, b, r = _operands(torch.bfloat16, n=16)
    y = matmul_f32(x, w)
    wide = torch.zeros(2, 5, 32, dtype=torch.bfloat16)
    return [
        ("all", y, b, torch.bfloat16, r, "kernel"),
        ("all, no residual", y, b, torch.bfloat16, None, "kernel"),
        ("fp32 activations", y, b, torch.float32, r.float(), "plain"),
        ("no bias", y, None, torch.bfloat16, None, "plain"),
        ("non-contiguous residual", y, b, torch.bfloat16, wide[..., ::2],
         "raises"),
        ("non-contiguous bias", y, torch.zeros(32)[::2], torch.bfloat16,
         None, "raises"),
        ("residual of another dtype", y, b, torch.bfloat16, r.float(),
         "raises"),
        ("broadcast residual", y, b, torch.bfloat16, r[:1], "raises"),
        ("bf16 product", y.to(torch.bfloat16), b, torch.bfloat16, None,
         "raises"),
    ]


@pytest.mark.parametrize("case", range(len(_cases())))
def test_route_needs_every_condition(forced, case):
    name, y, b, dtype, r, route = _cases()[case]
    assert epi.takes_kernel(y, b, dtype, r) == (route != "plain"), name
    if route == "raises":
        with pytest.raises(ValueError):
            epi.dense_epilogue(y, b, residual=r)


def test_route_is_plain_while_autograd_records(forced):
    x, w, b, _ = _operands(torch.bfloat16, n=16)
    w.requires_grad_(True)
    y = matmul_f32(x, w)
    assert y.requires_grad
    assert not epi.takes_kernel(y, b, torch.bfloat16)
    with torch.no_grad():
        assert epi.takes_kernel(matmul_f32(x, w), b, torch.bfloat16)
    b.requires_grad_(True)
    assert not epi.takes_kernel(y.detach(), b, torch.bfloat16)


def _bad_calls():
    acc = torch.zeros(3, 8)
    b = torch.zeros(8)
    r = torch.zeros(3, 8, dtype=torch.bfloat16)
    return [
        ("bf16 product", (acc.bfloat16(), b), {}),
        ("bf16 bias", (acc, b.bfloat16()), {}),
        ("bias of another width", (acc, torch.zeros(7)), {}),
        ("2-D bias", (acc, torch.zeros(1, 8)), {}),
        ("scalar product", (torch.zeros(()), b), {}),
        ("fp32 residual", (acc, b), {"residual": r.float()}),
        ("residual of another shape", (acc, b), {"residual": r[:1]}),
        ("non-contiguous product", (torch.zeros(8, 3).t(), torch.zeros(8)),
         {}),
        ("non-contiguous residual", (acc, b),
         {"residual": torch.zeros(8, 3, dtype=torch.bfloat16).t()}),
        ("unknown activation", (acc, b), {"act": "gelu"}),
        ("activation and residual", (acc, b),
         {"act": "quick_gelu", "residual": r}),
    ]


@pytest.mark.parametrize("call", range(len(_bad_calls())))
def test_wrapper_refuses(call):
    name, args, kw = _bad_calls()[call]
    with pytest.raises(ValueError):
        epi.dense_epilogue(*args, **kw)


def test_wrapper_on_the_cpu_is_the_plain_version_and_launches_nothing():
    x, w, b, r = _operands(torch.bfloat16)
    acc = matmul_f32(x, w)
    before = epi.dense_epilogue.launches
    for kw in ({}, {"act": "quick_gelu"}, {"residual": r}):
        got = epi.dense_epilogue(acc, b, **kw)
        assert torch.equal(got, epi.epilogue_reference(
            acc, b, torch.bfloat16, **kw))
    assert epi.dense_epilogue.launches == before


def _totals():
    """(kernel launches, ``_dense`` calls on the plain chain) so far."""
    return epi.dense_epilogue.launches, tclip._dense.plain


def test_dense_counts_each_route(forced, monkeypatch):
    x, w, b, r = _operands(torch.bfloat16, n=16)
    p = Precision.fast()
    for kw in ({}, {"act": "quick_gelu"}, {"residual": r}):
        launched, plain = _totals()
        tclip._dense(x, w, b, p, **kw)
        assert _totals() == (launched + 1, plain)
    launched, plain = _totals()
    tclip._dense(x, w, None, p)
    assert _totals() == (launched, plain + 1)


@pytest.fixture(scope="module")
def tiny_model():
    return init_clip(5, CFG)


def test_vision_tower_counts_six_launches_a_layer(forced, tiny_model):
    params = from_jax_params(tiny_model, "cpu", torch.bfloat16)
    pixels = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 32, 32, 3)).astype(np.float32))
    launched, plain = _totals()
    feats = tclip.encode_image(params, CFG.vision, pixels, Precision.fast())
    assert _totals() == (launched + BIASED, plain + UNBIASED)
    assert feats.shape == (3, 32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = make_imagefolder_tree(str(tmp_path_factory.mktemp("epi") / "t"),
                                 ["a", "b"], per_class=4, seed=2)
    return list(ImageFolder(root))


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_score_dataset_reports_the_routes(request, tiny_model, tree, route):
    if route == "kernel":
        request.getfixturevalue("forced")
    step = EvalStep(CFG, score="MCM", T=1.0, precision=Precision.fast(),
                    device="cpu")
    params = step.put_params(tiny_model)
    rng = np.random.default_rng(3)
    text = rng.standard_normal((5, 32)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    cfg = RunConfig(batch_size=4, num_workers=2, prefetch=2, image_size=32,
                    device="cpu", precision="fast")
    tel = Telemetry()
    scores = score_dataset(step, params, tree, step.put_replicated(text), cfg,
                           tel)
    batches = len(tree) // 4
    assert scores.shape == (len(tree),) and np.isfinite(scores).all()
    want = ({"towers.dense_epilogue": 0,
             "towers.dense_plain": batches * (BIASED + UNBIASED)}
            if route == "plain" else
            {"towers.dense_epilogue": batches * BIASED,
             "towers.dense_plain": batches * UNBIASED})
    assert {k: tel.counters[k] for k in want} == want
    report = tel.report()
    for name, n in want.items():
        assert f"{name} {n}" in report
