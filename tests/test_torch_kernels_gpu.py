"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one, so on a CPU-only host every test is collected and skipped.
This file imports neither JAX nor the JAX package, and the card's machine
has no JAX, so it runs there without the suite's ``conftest.py``:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: bf16 outputs are compared at 2e-2 absolute (one bf16 ulp at
|x| ≈ 1 is 7.8e-3; the kernel and the plain version sum in different
orders and may round a probability or an output to neighbouring bf16
values); fp32 at 2e-5; scores at rtol 1e-5 plus 1e-6 of the largest
score, the fp32 summation-order noise of a 512-long dot and a 1000-long
softmax sum — except ``var``, whose near-uniform softmax at T = 100 puts
it at ~1e-13 after cancelling ``p - mean``: rtol 1e-4 there.  The fused
MLP: bf16 at 3.2e-2 absolute (one bf16 ulp at |y| < 8, outputs here stay
below 8; h may round to a neighbouring bf16 value, which moves y by far
less), fp32 at 2e-4 (fp32 summation order over D + F ≤ 5120 terms, the
tolerance of the JAX package's ``test_fused_mlp_matches_reference``).
"""

import numpy as np
import pytest
import torch

from mcm_tpu_torch.config import Precision
from mcm_tpu_torch.ops import attention, mcm_score, mlp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device=device, dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize("b,s,d,heads,dtype", [
    (256, 197, 768, 12, torch.bfloat16),   # ViT-B/16
    (64, 50, 768, 12, torch.bfloat16),     # ViT-B/32
    (64, 257, 1024, 16, torch.bfloat16),   # ViT-L/14
    (8, 197, 768, 12, torch.float32),
    (3, 17, 128, 2, torch.float32),
    (5, 33, 128, 16, torch.float32),       # Dh = 8
    (2, 197, 256, 4, torch.bfloat16),
    (2, 40, 256, 2, torch.bfloat16),       # Dh = 128
])
def test_bsd_kernel_matches_plain(cuda, b, s, d, heads, dtype):
    q, k, v = _qkv((b, s, d), dtype, cuda)
    before = attention.bsd_attention.launches
    got = attention.bsd_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert attention.bsd_attention.launches == before + 1
    want = attention.bsd_attention_reference(q, k, v, heads)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_bsd_kernel_refuses_bad_shapes(cuda):
    q = torch.zeros((2, 16, 128), device=cuda)
    with pytest.raises(ValueError, match="heads"):
        attention.bsd_attention(q, q, q, 48)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attention.bsd_attention(q.half(), q.half(), q.half(), 2)


def test_bsd_kernel_reports_a_refused_launch(cuda):
    """fp32 K/V of one head at S = 2048 need ~1 MB of shared memory: the
    launch is refused and the wrapper raises instead of returning garbage."""
    q = torch.zeros((1, 2048, 128), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        attention.bsd_attention(q, q, q, 2)


def test_encoder_attention_auto_routes_to_kernel(cuda):
    q, k, v = _qkv((4, 197, 768), torch.bfloat16, cuda)
    before = attention.bsd_attention.launches
    got = attention.encoder_attention(q, k, v, heads=12, mask=None,
                                      precision=Precision.fast())
    assert attention.bsd_attention.launches == before + 1
    xla = Precision(activation_dtype=torch.bfloat16,
                    softmax_dtype=torch.bfloat16, attn_impl="xla")
    want = attention.encoder_attention(q, k, v, heads=12, mask=None,
                                       precision=xla)
    assert attention.bsd_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2, atol=5e-2)


def _feats(b, c, d, device, seed=0):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    txt = rng.standard_normal((c, d)).astype(np.float32)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    return img.to(device), torch.from_numpy(txt).to(device)


@pytest.mark.parametrize("score", ["MCM", "energy", "max-logit", "entropy",
                                   "var"])
@pytest.mark.parametrize("b,c,d,T", [(512, 1000, 512, 1.0),
                                     (512, 1000, 512, 100.0),
                                     (37, 7, 64, 2.0), (9, 130, 768, 1.0)])
def test_mcm_kernel_matches_plain(cuda, score, b, c, d, T):
    img, txt = _feats(b, c, d, cuda)
    before = mcm_score.mcm_score.launches
    got = mcm_score.mcm_score(img, txt, score, T)
    torch.cuda.synchronize()
    assert mcm_score.mcm_score.launches == before + 1
    want = mcm_score.mcm_score_reference(img, txt, score, T)
    torch.testing.assert_close(got, want, rtol=1e-4 if score == "var" else 1e-5,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("score", ["MCM", "energy", "max-logit", "entropy",
                                   "var"])
def test_mcm_kernel_propagates_nan_rows(cuda, score):
    img, txt = _feats(8, 100, 64, cuda)
    img[3] = 0.0      # zero-norm row → NaN, like the plain version
    got = mcm_score.mcm_score(img, txt, score, 1.0).cpu()
    assert torch.isnan(got[3])
    assert torch.isfinite(torch.cat([got[:3], got[4:]])).all()


def test_mcm_gate_matches_kernel_allocation(cuda):
    from mcm_tpu_torch.ops import _build
    lib = _build.load("mcm_score")
    for c, d in [(1000, 512), (7, 64), (13000, 768)]:
        assert lib.mcm_score_smem_bytes(c, d) == mcm_score.kernel_smem_bytes(c, d)
    img, txt = _feats(4, 16000, 512, cuda)
    assert not mcm_score.kernel_fits(16000, 512)
    before = mcm_score.mcm_score.launches
    out = mcm_score.fused_mcm_scores(img, txt, "MCM", 1.0)    # auto → torch
    assert mcm_score.mcm_score.launches == before
    assert out.shape == (4,)
    with pytest.raises(ValueError, match="shared memory"):
        mcm_score.mcm_score(img, txt, "MCM", 1.0)


# -- fused MLP -------------------------------------------------------------------

def _mlp_inputs(m, d, f, dtype, device, seed=0):
    """x ~ N(0, 1); weights scaled so that h and y stay O(1)."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, dt=dtype):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(device=device, dtype=dt)
    return (t((m, d)), t((d, f), d ** -0.5), t((f,), 0.1, torch.float32),
            t((f, d), f ** -0.5), t((d,), 0.1, torch.float32))


@pytest.mark.parametrize("m,d,f,dtype,tensor_cores", [
    (1000, 768, 3072, torch.bfloat16, True),    # ViT-B/16 vision
    (333, 512, 2048, torch.bfloat16, True),     # text width, tail rows
    (45, 1024, 4096, torch.bfloat16, True),     # ViT-L/14: 16-row tiles
    (37, 384, 1536, torch.bfloat16, True),      # golden config
    (70, 64, 256, torch.bfloat16, False),       # D % 128 != 0
    (50, 128, 96, torch.bfloat16, False),       # F not a chunk multiple
    (100, 768, 3072, torch.float32, False),     # parity mode
    (70, 64, 256, torch.float32, False),
])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_fused_mlp_kernel_matches_plain(cuda, m, d, f, dtype, tensor_cores,
                                        act):
    from mcm_tpu_torch.ops import _build
    lib = _build.load("fused_mlp")
    assert lib.mcm_fused_mlp_tensor_cores(
        d, f, 1 if dtype == torch.bfloat16 else 0) == int(tensor_cores)
    x, w1, b1, w2, b2 = _mlp_inputs(m, d, f, dtype, cuda)
    before = mlp.fused_mlp.launches
    got = mlp.fused_mlp(x, w1, b1, w2, b2, act=act)
    torch.cuda.synchronize()
    assert mlp.fused_mlp.launches == before + 1
    want = mlp.fused_mlp_reference(x, w1, b1, w2, b2, act=act)
    assert got.dtype == dtype and got.shape == (m, d)
    assert float(want.float().abs().max()) < 8
    tol = 3.2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_fused_mlp_refuses_bad_inputs(cuda):
    x, w1, b1, w2, b2 = _mlp_inputs(8, 128, 512, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="shapes disagree"):
        mlp.fused_mlp(x, w1, b1, w1, b2)
    with pytest.raises(ValueError, match="contiguous"):
        mlp.fused_mlp(x, w1.T.contiguous().T, b1, w2, b2)
    with pytest.raises(ValueError, match="32-byte aligned"):
        mlp.fused_mlp(x.view(-1)[8:].view(-1)[:7 * 128].view(7, 128), w1, b1,
                      w2, b2)
    with pytest.raises(ValueError, match="one CUDA device or the CPU"):
        mlp.fused_mlp(x, w1, b1.cpu(), w2, b2)


def test_fused_mlp_reports_a_refused_launch(cuda):
    """fp32 at D = 2048 needs 264 KB of shared memory for the x tile and
    the accumulator: the launch is refused and the wrapper raises."""
    from mcm_tpu_torch.ops import _build
    assert _build.load("fused_mlp").mcm_fused_mlp_smem_bytes(2048, 64, 0) \
        > 232448
    x, w1, b1, w2, b2 = _mlp_inputs(4, 2048, 64, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        mlp.fused_mlp(x, w1, b1, w2, b2)


def test_fused_mlp_layer_routing_on_the_card(cuda):
    """``mlp_impl="pallas"`` routes a tower's layers through the kernel:
    one launch per layer, features within the bf16 cosine bound of the
    unfused path."""
    import dataclasses

    from mcm_tpu_torch.config import CLIPConfig, TextConfig, VisionConfig
    from mcm_tpu_torch.models import clip as tclip
    from mcm_tpu_torch.models.convert import from_jax_params
    from mcm_tpu_torch.models.init import init_clip
    cfg = CLIPConfig(name="t", vision=VisionConfig(width=256, layers=3,
                                                   heads=4, projection_dim=64),
                     text=TextConfig(width=128, layers=2, heads=2,
                                     projection_dim=64))
    params = from_jax_params(init_clip(0, cfg), cuda, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 224, 224, 3)).astype(np.float32)).to(cuda, torch.bfloat16)
    fast = Precision.fast()
    before = mlp.fused_mlp.launches
    got = tclip.encode_image(params, cfg.vision, x,
                             dataclasses.replace(fast, mlp_impl="pallas"))
    assert mlp.fused_mlp.launches == before + 3
    want = tclip.encode_image(params, cfg.vision, x, fast)
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float())
    assert float(cos.min()) > 0.995


# -- split-heads attention -------------------------------------------------------

_SPLIT = {"pallas": ("pallas_attention", "block_q"),
          "pallas_mh": ("mh_attention", "block_h"),
          "pallas_batched": ("batched_attention", "block_bh")}


@pytest.mark.parametrize("impl", ["pallas", "pallas_mh", "pallas_batched"])
@pytest.mark.parametrize("shape,dtype,block", [
    ((16, 12, 197, 64), torch.bfloat16, None),   # ViT-B/16
    ((4, 16, 257, 64), torch.bfloat16, None),    # ViT-L/14: mh tail group of 4
    ((8, 12, 50, 64), torch.bfloat16, None),     # ViT-B/32
    ((2, 3, 50, 32), torch.float32, 4),          # 6 pairs: batched tail group
    ((1, 2, 120, 64), torch.float32, 2),
    ((3, 5, 33, 16), torch.float32, 3),          # H = 5 in groups of 3
    ((2, 2, 40, 128), torch.bfloat16, 1),
    ((2, 4, 197, 64), torch.float32, 64),        # 4 query tiles (pallas)
])
def test_split_kernel_matches_plain(cuda, impl, shape, dtype, block):
    name, arg = _SPLIT[impl]
    fn = getattr(attention, name)
    q, k, v = _qkv(shape, dtype, cuda)
    kwargs = {} if block is None else {arg: block}
    before = fn.launches
    got = fn(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = attention.split_attention_reference(q, k, v)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("mode,block", [(0, 8), (1, 3), (2, 3)])
def test_split_kernel_writes_nothing_past_the_tail(cuda, mode, block):
    """The output lies at the start of a larger buffer filled with a
    sentinel: the tail query tile (mode 0), the tail head group (mode 1:
    H = 5 in groups of 3) and the tail pair group (mode 2: 5 pairs in
    groups of 3) write only the elements that exist."""
    from mcm_tpu_torch.ops import _build
    lib = _build.load("split_attention")
    b, h, s, dh = 1, 5, 33, 16
    q, k, v = _qkv((b, h, s, dh), torch.float32, cuda)
    n = b * h * s * dh
    buf = torch.full((n + 4096,), 7.0, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    rc = lib.mcm_split_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 buf.data_ptr(), b, h, s, dh, mode, block, 0,
                                 stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert bool((buf[n:] == 7.0).all())
    torch.testing.assert_close(buf[:n].view(b, h, s, dh),
                               attention.split_attention_reference(q, k, v),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("impl", ["pallas", "pallas_mh", "pallas_batched"])
def test_encoder_attention_routes_split_impls(cuda, impl):
    """Each name launches its own kernel (and not bsd) on strided split
    views, within the bf16 bound of the math path."""
    import dataclasses
    name, _ = _SPLIT[impl]
    fn = getattr(attention, name)
    q, k, v = _qkv((4, 197, 768), torch.bfloat16, cuda)
    before = (fn.launches, attention.bsd_attention.launches)
    got = attention.encoder_attention(
        q, k, v, heads=12, mask=None,
        precision=dataclasses.replace(Precision.fast(), attn_impl=impl))
    assert (fn.launches, attention.bsd_attention.launches) == (
        before[0] + 1, before[1])
    xla = dataclasses.replace(Precision.fast(), attn_impl="xla")
    want = attention.encoder_attention(q, k, v, heads=12, mask=None,
                                       precision=xla)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2, atol=5e-2)


def test_split_kernel_reports_a_refused_launch(cuda):
    """fp32 K/V of one pair at S = 4096 need ~2.3 MB of shared memory: the
    launch is refused and the wrapper raises."""
    from mcm_tpu_torch.ops import _build
    assert _build.load("split_attention").mcm_split_attention_smem_bytes(
        4096, 64, 0) > 232448
    q = torch.zeros((1, 1, 4096, 64), device=cuda)
    for name, _ in _SPLIT.values():
        with pytest.raises(RuntimeError, match="launch failed"):
            getattr(attention, name)(q, q, q)


def test_split_kernel_refuses_bad_shapes(cuda):
    q = torch.zeros((1, 2, 16, 48), device=cuda)
    with pytest.raises(ValueError, match="power of two"):
        attention.pallas_attention(q, q, q)
    with pytest.raises(ValueError, match=r"\[B, H, S, Dh\]"):
        attention.mh_attention(q[0], q[0], q[0])
