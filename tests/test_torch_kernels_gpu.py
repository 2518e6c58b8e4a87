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
The flash kernel and the tools' kernels (bsd probe modes, packed bsd) use
the attention tolerances; the probe's ``nosoftmax``, whose outputs are
large, is held to one bf16 ulp (bf16) or 2e-5 (fp32) of its largest |x|,
and the packed bsd must be bit-identical to the split one.  Training: the
trainable attention's gradients must be bit-identical to the math path's
(the same ops on the same inputs) and its output within one bf16 ulp of
the bsd plain version; ``matmul_f32``'s forward with a gradient is
bit-identical to the product without, and its input gradients are within
bf16's rounding (2^-8 relative, plus 1e-4 of the largest value for fp32
summation order) of an IEEE fp32 reference.  Data parallelism: one batch
through a gloo group of one process is bit-equal to the one-process step;
ODIN's gradient pass in sub-batches is held to 2e-5 of the largest score
against one pass; the serving detector on two replicas of one card
launches the kernels on each and scores as one replica does; a parity
train step on two replicas of card 0 (one process, the gradient summed on
the card) gives the one-device loss and gradient, and ``VitLinearStep``
on two replicas launches bsd on each and scores as one device.  Not a
kernel, but checked on
the card's host: the native JPEG decoder builds, loads and passes its
self-test there.  Tensor parallelism: two shards of card 0 score as one
device does (parity at rtol 1e-4 / atol 1e-5, fast at 5e-3 / 5e-4),
launch no kernel, and refuse a forced one.  The dense epilogue has no
tolerance: bit-equality.  Each mode's bf16 output has the bits of the plain
chain's on the same fp32 product, and ViT-L/14's features with the kernel
those without it.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from mcm_tpu_torch.config import Precision
from mcm_tpu_torch.ops import attention, mcm_score, mlp, numerics

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


#: S at the tensor-core kernel's edges: 16-row tiles, 16-key chunks, ViT-B/16
#: and L/14, and 600 (K/V of 152 KB in shared memory)
_EDGE_S = [1, 15, 16, 17, 63, 64, 65, 197, 257, 600]
#: bf16 head dims of each design: CUDA cores below 16, tensor cores from 16
_BF16_DH = [4, 8, 16, 32, 128]


@pytest.mark.parametrize("b,s,d,heads,dtype", [
    (256, 197, 768, 12, torch.bfloat16),   # ViT-B/16
    (64, 50, 768, 12, torch.bfloat16),     # ViT-B/32
    (64, 257, 1024, 16, torch.bfloat16),   # ViT-L/14
    (8, 197, 768, 12, torch.float32),
    (3, 17, 128, 2, torch.float32),
    (5, 33, 128, 16, torch.float32),       # Dh = 8
    (2, 197, 256, 4, torch.bfloat16),
    (2, 40, 256, 2, torch.bfloat16),       # Dh = 128
] + [(3, s, 128, 2, torch.bfloat16) for s in _EDGE_S]          # Dh = 64
  + [(3, s, 128, 128 // dh, torch.bfloat16) for dh in _BF16_DH for s in (17, 197)])
def test_bsd_kernel_matches_plain(cuda, b, s, d, heads, dtype):
    q, k, v = _qkv((b, s, d), dtype, cuda)
    before = attention.bsd_attention.launches
    got = attention.bsd_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert attention.bsd_attention.launches == before + 1
    want = attention.bsd_attention_reference(q, k, v, heads)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_bsd_smem_bytes_follow_the_design(cuda):
    """The dispatch is by dtype and head dim: bf16 from Dh = 16 takes the
    tensor-core kernel (K and V as unpadded [S rounded to 16, Dh] tiles),
    fp32 and bf16 below 16 the CUDA-core kernel (padded K rows and a
    per-warp fp32 logits row)."""
    from mcm_tpu_torch.ops import _build
    lib = _build.load("bsd_attention")
    for s in (1, 17, 197, 600):
        s16 = -(-s // 16) * 16
        for dh in (16, 32, 64, 128):
            assert lib.mcm_bsd_attention_smem_bytes(s, dh, 1) == 2 * s16 * dh * 2
            vec = 2
            cuda_core = (-(-s * (2 * dh + vec) * 4 // 16) * 16) + 8 * s * 4
            assert lib.mcm_bsd_attention_smem_bytes(s, dh, 0) == cuda_core
        cuda_core_bf16 = (-(-s * (2 * 8 + 4) * 2 // 16) * 16) + 8 * s * 4
        assert lib.mcm_bsd_attention_smem_bytes(s, 8, 1) == cuda_core_bf16


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


@pytest.mark.parametrize("score", ["MCM", "energy", "max-logit", "entropy",
                                   "var"])
@pytest.mark.parametrize("b,c,d,T", [
    (128, 16000, 512, 1.0),    # past the old shared-memory gate
    (1, 1000, 512, 1.0), (7, 1000, 512, 1.0),    # partial row tiles
    (64, 1000, 768, 1.0),      # L/14's feature width
    (9, 130, 509, 1.0), (33, 33, 33, 100.0), (5, 20000, 3, 1.0),  # D % 4 != 0
    (3, 1, 1, 1.0)])
def test_mcm_kernel_takes_any_shape(cuda, score, b, c, d, T):
    img, txt = _feats(b, c, d, cuda)
    got = mcm_score.mcm_score(img, txt, score, T)
    torch.cuda.synchronize()
    want = mcm_score.mcm_score_reference(img, txt, score, T)
    torch.testing.assert_close(got, want, rtol=1e-4 if score == "var" else 1e-5,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("score", ["MCM", "entropy", "var"])
def test_mcm_kernel_takes_rows_off_16_byte_alignment(cuda, score):
    """Views one float into their storage: the 4-byte staging path."""
    img, txt = _feats(20, 300, 512, cuda)
    img_off = torch.empty(img.numel() + 1, device=cuda)[1:].view_as(img)
    txt_off = torch.empty(txt.numel() + 1, device=cuda)[1:].view_as(txt)
    img_off.copy_(img)
    txt_off.copy_(txt)
    got = mcm_score.mcm_score(img_off, txt_off, score, 1.0)
    want = mcm_score.mcm_score_reference(img, txt, score, 1.0)
    torch.testing.assert_close(got, want, rtol=1e-4 if score == "var" else 1e-5,
                               atol=1e-6 * float(want.abs().max()))


def test_mcm_auto_takes_the_kernel_at_any_c(cuda):
    img, txt = _feats(4, 16000, 512, cuda)
    before = mcm_score.mcm_score.launches
    out = mcm_score.fused_mcm_scores(img, txt, "MCM", 1.0)      # auto
    assert mcm_score.mcm_score.launches == before + 1
    torch.testing.assert_close(
        out, mcm_score.mcm_score_reference(img, txt, "MCM", 1.0),
        rtol=1e-5, atol=1e-6 * float(out.abs().max()))


def test_similarity_logits_ieee_with_tf32_on(cuda):
    """TF32 turned on globally: the score path's product is still IEEE fp32
    (within 1e-6 of a float64 product, relative), and TF32 is still on."""
    from mcm_tpu_torch.scores import clip_scores
    img, txt = _feats(64, 1000, 512, cuda)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = clip_scores.similarity_logits(img, txt)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    img64 = img.double()
    want = (img64 / img64.norm(dim=-1, keepdim=True)) @ txt.double().T
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert err < 1e-6, err


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
    (45, 1024, 4096, torch.bfloat16, True),     # ViT-L/14: split columns
    (37, 384, 1536, torch.bfloat16, True),      # golden config
    (70, 64, 256, torch.bfloat16, False),       # D % 128 != 0
    (50, 128, 96, torch.bfloat16, False),       # F not a chunk multiple
    (100, 768, 3072, torch.float32, False),     # parity mode
    (70, 64, 256, torch.float32, False),
# M around the wgmma kernel's 64-row tile (a tile of one row, a tail tile)
] + [(m, 768, 3072, torch.bfloat16, True) for m in (1, 63, 64, 65, 127, 129)]
# each D of the tensor-core gate: wgmma at 384 / 512 / 768 / 1024, wmma
# otherwise
  + [(70, d, 4 * d, torch.bfloat16, True) for d in range(128, 1025, 128)]
# 5 chunks of 8 weight stages: 40 stages wrap the 6-stage ring unevenly
  + [(130, 512, 320, torch.bfloat16, True), (65, 384, 320, torch.bfloat16, True),
     (129, 1024, 320, torch.bfloat16, True)])
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


def test_fused_mlp_smem_bytes_follow_the_design(cuda):
    """The dispatch: bf16 at D = 384, 512, 768, 1024 with F a multiple of
    64 takes the wgmma kernel (1 KB of alignment slack and 256 bytes of
    barriers, the [64, D] x tile, two [64, 64] h tiles and a ring of up to
    six weight stages of 32·D bytes, 32·D/2 at D = 1024 where two blocks
    split the output columns, within 227 KB); other bf16 shapes with D a
    multiple of 128 up to 1024 the wmma kernel; the rest the CUDA-core one
    (x tile and accumulator in fp32 and an h chunk)."""
    from mcm_tpu_torch.ops import _build
    lib = _build.load("fused_mlp")

    def wgmma(d):
        fixed = 1024 + 64 * d * 2 + 2 * 64 * 64 * 2 + 256
        stage = 32 * d // (2 if d > 768 else 1)
        return fixed + min(6, (232448 - fixed) // stage) * stage

    def wmma(d):
        bmf = 2 if d <= 768 else 1
        rows, hld = 16 * bmf, 128 // bmf + 8
        return rows * (d + 8) * 2 + rows * hld * 2 + 8 * 256 * 4

    def simt(d):
        return 16 * d * 2 * 4 + 16 * 32 * 4

    assert [wgmma(d) // 1024 for d in (384, 512, 768, 1024)] == [137, 177, 209,
                                                                  225]
    for d in range(128, 1025, 128):
        for f in (128, 640, 4 * d):
            want = wgmma(d) if d in (384, 512, 768, 1024) else wmma(d)
            assert lib.mcm_fused_mlp_smem_bytes(d, f, 1) == want
            assert lib.mcm_fused_mlp_tensor_cores(d, f, 1) == 1
            assert lib.mcm_fused_mlp_smem_bytes(d, f, 0) == simt(d)
            assert lib.mcm_fused_mlp_tensor_cores(d, f, 0) == 0
    for d, f in ((768, 96), (64, 256), (1152, 4608)):
        assert lib.mcm_fused_mlp_tensor_cores(d, f, 1) == 0
        assert lib.mcm_fused_mlp_smem_bytes(d, f, 1) == simt(d)


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
# bf16 edges with the default blocks: 2 × 7 pairs leave mode 1 a tail group
# of one head and mode 2 a group of 14 (no multiple of its 3-stage ring)
] + [((2, 7, s, 64), torch.bfloat16, None) for s in _EDGE_S]
  + [((2, 7, s, dh), torch.bfloat16, None) for dh in _BF16_DH for s in (17, 197)])
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


@pytest.mark.parametrize("mode,block,dtype,s", [
    (0, 8, torch.float32, 33), (1, 3, torch.float32, 33),
    (2, 3, torch.float32, 33),
    (0, 8, torch.bfloat16, 33), (1, 3, torch.bfloat16, 33),
    (2, 3, torch.bfloat16, 33),      # groups of 3 and 2 in a 3-stage ring
    (2, 4, torch.bfloat16, 33),      # 4 pairs wrap the 3-stage ring; then 1
    (2, 2, torch.bfloat16, 33),      # 2-stage ring; tail group of 1
    (2, 4, torch.bfloat16, 197),     # 13 tiles a pair: rounds span 2 pairs
    (1, 3, torch.bfloat16, 197),
])
def test_split_kernel_writes_nothing_past_the_tail(cuda, mode, block, dtype,
                                                   s):
    """The output lies at the start of a larger buffer filled with a
    sentinel: the tail query tile (mode 0), the tail head group (mode 1:
    H = 5 in groups of 3) and the tail pair group (mode 2: 5 pairs in
    groups of 2, 3 or 4) write only the elements that exist."""
    from mcm_tpu_torch.ops import _build
    lib = _build.load("split_attention")
    b, h, dh = 1, 5, 16
    q, k, v = _qkv((b, h, s, dh), dtype, cuda)
    n = b * h * s * dh
    buf = torch.full((n + 4096,), 7.0, device=cuda, dtype=dtype)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    rc = lib.mcm_split_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 buf.data_ptr(), b, h, s, dh, mode, block,
                                 int(dtype == torch.bfloat16), stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert bool((buf[n:] == 7.0).all())
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(buf[:n].view(b, h, s, dh).float(),
                               attention.split_attention_reference(
                                   q, k, v).float(), rtol=tol, atol=tol)


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


@pytest.mark.parametrize("name", ["bsd_attention", "pallas_attention",
                                  "mh_attention", "batched_attention"])
def test_kernels_take_rows_aligned_to_8_bytes_only(cuda, name):
    """q/k/v views that start 8 bytes past a 16-byte boundary: the
    tensor-core kernels stage them in 8-byte cp.async pieces."""
    b, s, d = 2, 65, 256
    n = b * s * d
    bufs = _qkv((n + 4,), torch.bfloat16, cuda)
    q, k, v = (t[4:].view(b, s, d) for t in bufs)
    assert all(t.data_ptr() % 16 == 8 for t in (q, k, v))
    fn = getattr(attention, name)
    if name == "bsd_attention":
        got, want = fn(q, k, v, 4), attention.bsd_attention_reference(q, k, v, 4)
    else:
        qh, kh, vh = (t.view(b, 4, s, 64) for t in (q, k, v))
        got, want = fn(qh, kh, vh), attention.split_attention_reference(qh, kh, vh)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_split_kernel_refuses_bad_shapes(cuda):
    q = torch.zeros((1, 2, 16, 48), device=cuda)
    with pytest.raises(ValueError, match="power of two"):
        attention.pallas_attention(q, q, q)
    with pytest.raises(ValueError, match=r"\[B, H, S, Dh\]"):
        attention.mh_attention(q[0], q[0], q[0])


# -- flash attention -------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((128, 12, 197, 64), torch.bfloat16),  # ViT-B/16, the smoke's path shape
    ((64, 16, 257, 64), torch.bfloat16),   # ViT-L/14: three key tiles
    ((64, 12, 50, 64), torch.bfloat16),    # ViT-B/32: one key tile
    ((16, 12, 197, 64), torch.float32),
    ((2, 4, 600, 64), torch.float32),      # S_pad > 512: JAX's block loop
    ((2, 4, 600, 64), torch.bfloat16),
    ((1, 2, 128, 64), torch.float32),      # exactly one key tile
    ((1, 2, 129, 64), torch.float32),      # a tile of one key
    ((2, 3, 33, 16), torch.float32),       # Dh < 32
    ((2, 2, 300, 128), torch.bfloat16),    # Dh = 128
# bf16 on both sides of the tensor-core tile's edges (16-row tiles, 16-key
# chunks, 128-key blocks), of JAX's branch (S_pad 512 / 640) and of the
# shared memory (Dh = 128 at S ≥ 449 takes the CUDA-core body)
] + [((2, 3, s, dh), torch.bfloat16)
     for dh in (16, 32, 64, 128)
     for s in (1, 16, 17, 128, 129, 197, 257, 512, 513, 600)])
def test_flash_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype, cuda)
    before = attention.flash_attention.launches
    got = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    want = attention.flash_attention_reference(q, k, v)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("s,kv_len,dtype", [
    (256, 197, torch.float32), (256, 1, torch.float32), (640, 600, torch.float32),
    (256, 197, torch.bfloat16), (640, 600, torch.bfloat16)])
def test_flash_kernel_kv_len(cuda, s, kv_len, dtype):
    """Keys at or past kv_len are skipped: the padded rows of the
    shootout's ``flash_pad256_mask`` (JAX's single step) and JAX's
    multi-block masking."""
    q, k, v = _qkv((2, 3, s, 64), dtype, cuda)
    got = attention.flash_attention(q, k, v, kv_len=kv_len)
    want = attention.flash_attention_reference(q, k, v, kv_len)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("s,dtype", [
    (33, torch.float32), (197, torch.float32),
    (33, torch.bfloat16), (197, torch.bfloat16), (600, torch.bfloat16)])
def test_flash_kernel_writes_nothing_past_the_output(cuda, s, dtype):
    """The output lies at the start of a larger buffer filled with a
    sentinel: the tail query tile writes only the rows that exist."""
    from mcm_tpu_torch.ops import _build
    lib = _build.load("flash_attention")
    b, h, dh = 2, 3, 64
    q, k, v = _qkv((b, h, s, dh), dtype, cuda)
    n = b * h * s * dh
    buf = torch.full((n + 4096,), 7.0, device=cuda, dtype=dtype)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    rc = lib.mcm_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 buf.data_ptr(), b, h, s, dh, s,
                                 int(dtype == torch.bfloat16), stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert bool((buf[n:] == 7.0).all())
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(buf[:n].view(b, h, s, dh).float(),
                               attention.flash_attention_reference(
                                   q, k, v).float(), rtol=tol, atol=tol)


def test_flash_kernel_refuses_a_bad_kv_len(cuda):
    from mcm_tpu_torch.ops import _build
    lib = _build.load("flash_attention")
    q = torch.zeros((1, 1, 8, 64), device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for kv_len in (0, 9):
        assert lib.mcm_flash_attention(q.data_ptr(), q.data_ptr(), q.data_ptr(),
                                       q.data_ptr(), 1, 1, 8, 64, kv_len, 0,
                                       stream) != 0


def test_encoder_attention_routes_flash(cuda):
    """``attn_impl="flash"`` launches the flash kernel (and not bsd) on
    strided split views, within the bf16 bound of the math path."""
    import dataclasses
    q, k, v = _qkv((4, 197, 768), torch.bfloat16, cuda)
    before = (attention.flash_attention.launches,
              attention.bsd_attention.launches)
    got = attention.encoder_attention(
        q, k, v, heads=12, mask=None,
        precision=dataclasses.replace(Precision.fast(), attn_impl="flash"))
    assert (attention.flash_attention.launches,
            attention.bsd_attention.launches) == (before[0] + 1, before[1])
    want = attention.encoder_attention(
        q, k, v, heads=12, mask=None,
        precision=dataclasses.replace(Precision.fast(), attn_impl="xla"))
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2, atol=5e-2)


# -- the tools' kernels: bsd probe modes, packed bsd -----------------------------

@pytest.mark.parametrize("s", [197, 50, 17])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["full", "nosoftmax", "noexp", "bf16sm",
                                  "deferdiv"])
def test_bsd_probe_kernel_matches_plain(cuda, mode, dtype, s):
    """Each mode against its plain version at the tool's head width (64),
    at ViT-B/16's S and at two that are no multiple of 16 (masked keys):
    bf16 at 2e-2 and fp32 at 2e-5 absolute (bf16sm rounds to bf16 whatever
    the input: 2e-2); nosoftmax, whose outputs reach |x| ≈ 50 here, at one
    bf16 ulp (bf16) or 2e-5 (fp32) of the output's largest |x|."""
    import math

    from mcm_tpu_torch.tools import bsd_probe
    q, k, v = _qkv((8, s, 768), dtype, cuda)
    before = bsd_probe.probe.launches
    got = bsd_probe.probe(q, k, v, mode)
    torch.cuda.synchronize()
    assert bsd_probe.probe.launches == before + 1
    want = bsd_probe.probe_reference(q, k, v, mode)
    bf16 = dtype == torch.bfloat16
    if mode == "nosoftmax":
        scale = float(want.float().abs().max())
        tol = 2.0 ** (math.floor(math.log2(scale)) - 7) if bf16 else 2e-5 * scale
    else:
        tol = 2e-2 if bf16 or mode == "bf16sm" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_bsd_probe_full_is_the_bsd_kernel(cuda):
    """Mode full is the main path's kernel body: bit-identical output."""
    from mcm_tpu_torch.tools import bsd_probe
    q, k, v = _qkv((4, 197, 768), torch.bfloat16, cuda)
    assert torch.equal(bsd_probe.probe(q, k, v, "full"),
                       attention.bsd_attention(q, k, v, 12))


@pytest.mark.parametrize("s", [197, 17])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_bsd_is_bit_identical_to_split(cuda, dtype, s):
    from mcm_tpu_torch.tools import qkv_probe
    qkv = _qkv((4, s, 3 * 768), dtype, cuda)[0]
    before = qkv_probe.bsd_fused.launches
    got = qkv_probe.bsd_fused(qkv, 768, 12)
    torch.cuda.synchronize()
    assert qkv_probe.bsd_fused.launches == before + 1
    split = attention.bsd_attention(
        *(t.contiguous() for t in qkv.split(768, dim=-1)), 12)
    assert torch.equal(got, split)


# -- Mahalanobis and ODIN on the card ------------------------------------------
# maha: the card's IEEE fp32 products against the CPU's, at the tolerance the
# JAX package holds its score to (rtol 1e-4 / atol 1e-4, tests/test_scores.py);
# with TF32 switched on globally the score still matches the CPU to 2e-5 of
# its largest value, which a TF32 product (10-bit mantissa) would miss.

def _maha_inputs(seed=0, b=128, c=10, d=512):
    rng = np.random.default_rng(seed)
    offset = rng.standard_normal(d) * 8 / np.sqrt(d)
    feats = (offset + 0.3 * rng.standard_normal((b, d))).astype(np.float32)
    mu = (offset + 0.3 * rng.standard_normal((c, d))).astype(np.float32)
    a = rng.standard_normal((d, d)).astype(np.float32)
    prec = (a @ a.T / d + np.eye(d)).astype(np.float32)
    return feats, mu, prec


def _tiny_clip(width=128, heads=2):
    from mcm_tpu_torch.config import CLIPConfig, TextConfig, VisionConfig
    from mcm_tpu_torch.models.init import init_clip
    cfg = CLIPConfig(
        name="tiny",
        vision=VisionConfig(image_size=32, patch_size=8, width=width,
                            layers=2, heads=heads, projection_dim=64),
        text=TextConfig(vocab_size=128, context_length=16, width=64,
                        layers=2, heads=4, projection_dim=64))
    return cfg, init_clip(3, cfg)


@pytest.mark.parametrize("normalize", [False, True])
def test_eval_step_maha_on_the_card_matches_cpu(cuda, normalize):
    from mcm_tpu_torch.parallel import EvalStep
    cfg, _ = _tiny_clip()
    feats, mu, prec = _maha_inputs()
    out = {}
    for dev in ("cpu", "cuda"):
        step = EvalStep(cfg, device=dev)
        out[dev] = step.maha(step.put_replicated(feats),
                             step.put_replicated(mu),
                             step.put_replicated(prec),
                             normalize=normalize).cpu().numpy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)


def test_mahalanobis_on_the_card_is_ieee_under_global_tf32(cuda):
    from mcm_tpu_torch.scores.mahalanobis import mahalanobis_score
    feats, mu, prec = _maha_inputs(seed=1)
    want = mahalanobis_score(*map(torch.from_numpy, (feats, mu, prec))).numpy()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = mahalanobis_score(*(torch.from_numpy(a).to(cuda)
                                  for a in (feats, mu, prec))).cpu().numpy()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


def _odin_inputs(cuda, seed=5):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.integers(0, 256, size=(8, 32, 32, 3),
                                           dtype=np.uint8)).to(cuda)
    text = rng.standard_normal((20, 64)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    return images, torch.from_numpy(text).to(cuda)


def test_odin_zero_noise_equals_mcm_on_the_card(cuda):
    """ε = 0 on the card: the same MCM kernel on the same fp32 math-path
    features (rtol 1e-5, atol 1e-6, as on the CPU)."""
    from mcm_tpu_torch.parallel import EvalStep
    from mcm_tpu_torch.parallel.eval_step import _odin_safe
    cfg, params = _tiny_clip()
    images, text = _odin_inputs(cuda)
    odin = EvalStep(cfg, score="odin", device=cuda, noise_magnitude=0.0)
    model = odin.put_params(params)
    mcm = EvalStep(cfg, score="MCM", precision=_odin_safe(Precision.fast()),
                   device=cuda)
    before = mcm_score.mcm_score.launches
    got = odin.score(model, images, text)
    want = mcm.score(model, images, text)
    torch.cuda.synchronize()
    assert mcm_score.mcm_score.launches == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    moved = EvalStep(cfg, score="odin", device=cuda, noise_magnitude=0.01)
    s = moved.score(model, images, text)
    assert bool(torch.isfinite(s).all()) and not torch.allclose(s, want)


def test_odin_gradient_pass_launches_no_kernel(cuda):
    """Asked for the bsd attention and the fused MLP, the ODIN step still
    runs its gradient pass and its final encode on the math paths: the only
    launch is the MCM score's, and with ``impl="torch"`` none at all."""
    import dataclasses

    from mcm_tpu_torch.parallel import EvalStep
    cfg, params = _tiny_clip(width=128, heads=2)
    images, text = _odin_inputs(cuda, seed=6)
    asked = dataclasses.replace(Precision.fast(), attn_impl="pallas_bsd",
                                mlp_impl="pallas")
    step = EvalStep(cfg, score="odin", precision=asked, device=cuda,
                    noise_magnitude=0.002)
    model = step.put_params(params)
    counters = [attention.bsd_attention, attention.flash_attention,
                attention.pallas_attention, attention.mh_attention,
                attention.batched_attention, mlp.fused_mlp,
                mcm_score.mcm_score]
    before = [fn.launches for fn in counters]
    plain = step.score(model, images, text, impl="torch")
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == before
    fused = step.score(model, images, text)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == before[:-1] + [before[-1] + 1]
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-6)


def test_odin_sub_batches_match_the_unsplit_pass_on_the_card(cuda,
                                                             monkeypatch):
    """ODIN on a batch of 128 on the card with its gradient pass in four
    sub-batches of 32 against one pass of 128 rows: within the ODIN tests'
    tolerance, 2e-5 of the largest score (``tests/test_torch_odin.py``)."""
    from mcm_tpu_torch.parallel import EvalStep, eval_step
    cfg, params = _tiny_clip()
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.integers(0, 256, size=(128, 32, 32, 3),
                                           dtype=np.uint8)).to(cuda)
    _, text = _odin_inputs(cuda)
    step = EvalStep(cfg, score="odin", device=cuda, noise_magnitude=0.002)
    model = step.put_params(params)
    assert eval_step.ODIN_GRAD_ROWS >= 128
    whole = step.score(model, images, text)
    monkeypatch.setattr(eval_step, "ODIN_GRAD_ROWS", 32)
    split = step.score(model, images, text)
    assert bool(torch.isfinite(split).all())
    torch.testing.assert_close(split, whole, rtol=0,
                               atol=2e-5 * float(whole.abs().max()))


def test_world_size_1_group_step_is_the_one_process_step(cuda):
    """A gloo group of one process (a launcher's world of one), the step on
    its mesh's card: one batch through the stripe and the gather, bit-equal
    to the one-process step on the same batch (the bsd and MCM kernels)."""
    import socket

    import torch.distributed as dist

    from mcm_tpu_torch.parallel import EvalStep, multihost
    from mcm_tpu_torch.parallel.mesh import make_mesh
    cfg, params = _tiny_clip()
    rng = np.random.default_rng(10)
    images = rng.integers(0, 256, size=(8, 32, 32, 3), dtype=np.uint8)
    _, text = _odin_inputs(cuda)
    step = EvalStep(cfg, device=cuda)
    want = step.score(step.put_params(params), step.put_batch(images),
                      text).cpu().numpy()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, device="cuda")
        assert (mesh.data, multihost.process_count()) == (1, 1)
        gstep = EvalStep(cfg, mesh=mesh)
        assert gstep.device == torch.device("cuda", 0)
        lo, hi = multihost.batch_stripe(8)
        out = gstep.score(gstep.put_params(params),
                          gstep.put_batch(images[lo:hi]), text)
        got = multihost.assemble_global_outputs([out.cpu().numpy()], [8], 8)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got, want)


# -- the vit-Linear tower and the serving detector ------------------------------
#
# The supervised ViT at width 128, 2 heads (Dh = 64) on the card: the bsd
# kernel in every layer, held against the same tower on the math path
# (attn_impl="xla") at the cosine bound the JAX package holds bf16 to
# (0.995) and 1e-2 of the largest |logit|.  The serving detector on the
# tiny ViT-B/16 double through the bsd and MCM kernels against the same
# detector on the CPU's plain path, at the serve tests' cross-bucket
# tolerance (rtol 5e-3, atol 5e-4) and equal classes.

def _tiny_vit():
    from mcm_tpu_torch.config import SupervisedViTConfig
    from mcm_tpu_torch.models.init import init_supervised_vit
    cfg = SupervisedViTConfig(image_size=64, patch_size=16, width=128,
                              layers=2, heads=2, num_classes=100)
    return cfg, init_supervised_vit(4, cfg)


def test_vit_tower_kernels_match_the_plain_path(cuda):
    import dataclasses

    from mcm_tpu_torch.parallel import VitLinearStep
    cfg, params = _tiny_vit()
    rng = np.random.default_rng(8)
    images = torch.from_numpy(rng.integers(0, 256, size=(16, 64, 64, 3),
                                           dtype=np.uint8)).to(cuda)
    step = VitLinearStep(cfg, device=cuda)
    plain = VitLinearStep(cfg, device=cuda, precision=dataclasses.replace(
        Precision.fast(), attn_impl="xla"))
    model = step.put_params(params)
    before = attention.bsd_attention.launches
    got = step.features(model, images)
    torch.cuda.synchronize()
    assert attention.bsd_attention.launches == before + cfg.layers
    want = plain.features(model, images)
    torch.cuda.synchronize()
    assert attention.bsd_attention.launches == before + cfg.layers
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert float(cos.min()) > 0.995
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())
    scores = step.score(model, images)
    assert bool(torch.isfinite(scores).all()) and scores.shape == (16,)


def test_vit_odin_on_the_card_launches_no_kernel(cuda):
    from mcm_tpu_torch.parallel import VitLinearStep
    cfg, params = _tiny_vit()
    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.integers(0, 256, size=(4, 64, 64, 3),
                                           dtype=np.uint8)).to(cuda)
    counters = [attention.bsd_attention, mlp.fused_mlp, mcm_score.mcm_score]
    before = [fn.launches for fn in counters]
    odin0 = VitLinearStep(cfg, score="odin", device=cuda, noise_magnitude=0.0)
    model = odin0.put_params(params)
    got = odin0.score(model, images)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == before
    cpu = VitLinearStep(cfg, score="odin", device="cpu", noise_magnitude=0.0)
    want = cpu.score(cpu.put_params(params), images.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


def test_detector_through_the_kernels_matches_the_cpu_plain_path(
        cuda, monkeypatch):
    import warnings

    from mcm_tpu_torch.serve import MicroBatcher, OODDetector
    monkeypatch.setenv("MCM_TPU_TEST_TINY_B16", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dets = {dev: OODDetector(class_names=["cat", "dog", "owl", "eel"],
                                 allow_random_weights=True,
                                 batch_sizes=(1, 4), device=dev)
                for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(10)
    images = rng.integers(0, 256, size=(6, 224, 224, 3), dtype=np.uint8)
    layers = 2                                       # the double's depth
    bsd, mcm = attention.bsd_attention.launches, mcm_score.mcm_score.launches
    got = dets["cuda"].score_images(images)          # 2 chunks of bucket 4
    assert attention.bsd_attention.launches == bsd + 2 * layers
    assert mcm_score.mcm_score.launches == mcm + 2
    want = dets["cpu"].score_images(images)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)
    idx, scores = dets["cuda"].classify_images(images)
    c_idx, c_scores = dets["cpu"].classify_images(images)
    np.testing.assert_array_equal(idx, c_idx)
    np.testing.assert_allclose(scores, c_scores, rtol=5e-3, atol=5e-4)
    with MicroBatcher(dets["cuda"], max_wait_ms=20) as mb:
        served = np.array([f.result(timeout=120)
                           for f in [mb.submit(im) for im in images]])
    np.testing.assert_allclose(served, want, rtol=5e-3, atol=5e-4)


def test_detector_on_two_replicas_of_one_card(cuda, monkeypatch):
    """``OODDetector(n_devices=2, device="cuda:0")``: each replica launches
    the bsd and MCM kernels on its stripe of every bucket, and the scores
    and classes are the one-replica detector's (within the bucket
    tolerance: a stripe is a batch of another size)."""
    import warnings

    from mcm_tpu_torch.serve import OODDetector
    monkeypatch.setenv("MCM_TPU_TEST_TINY_B16", "1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dets = {n: OODDetector(class_names=["cat", "dog", "owl", "eel"],
                               allow_random_weights=True, batch_sizes=(2, 4),
                               n_devices=n, device="cuda:0")
                for n in (1, 2)}
    assert dets[2].step.mesh.devices == (torch.device("cuda", 0),) * 2
    rng = np.random.default_rng(10)
    images = rng.integers(0, 256, size=(6, 224, 224, 3), dtype=np.uint8)
    layers = 2                                       # the double's depth
    bsd, mcm = attention.bsd_attention.launches, mcm_score.mcm_score.launches
    got = dets[2].score_images(images)               # buckets 4, then 2
    assert attention.bsd_attention.launches == bsd + 2 * 2 * layers
    assert mcm_score.mcm_score.launches == mcm + 2 * 2
    want = dets[1].score_images(images)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)
    np.testing.assert_array_equal(dets[2].classify_images(images)[0],
                                  dets[1].classify_images(images)[0])


# -- tensor parallelism: two shards of card 0 ----------------------------------

def _tp_steps(precision, score="MCM"):
    """The tiny ViT-B/16 double's one-device step and its step on two
    shards of card 0, with the model, a batch of 8 and prompt features."""
    import os
    import warnings

    from mcm_tpu_torch.config import CLIP_CONFIGS
    from mcm_tpu_torch.models.init import init_clip
    from mcm_tpu_torch.parallel import EvalStep
    from mcm_tpu_torch.parallel.mesh import make_local_mesh
    os.environ["MCM_TPU_TEST_TINY_B16"] = "1"
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cfg = CLIP_CONFIGS["ViT-B/16"]()
    finally:
        del os.environ["MCM_TPU_TEST_TINY_B16"]
    params = init_clip(0, cfg)
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, size=(8, 224, 224, 3), dtype=np.uint8)
    text = rng.standard_normal((5, cfg.embed_dim)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    out = []
    for tp in (1, 2):
        step = EvalStep(cfg, score=score, precision=precision,
                        mesh=make_local_mesh(tp, tp, device="cuda:0"))
        out.append((step, step.put_params(params), step.put_batch(images),
                    step.put_replicated(text)))
    return out


@pytest.mark.parametrize("precision,rtol,atol", [
    (Precision.parity(), 1e-4, 1e-5), (Precision.fast(), 5e-3, 5e-4)])
def test_two_shards_of_one_card_match_one_device(cuda, precision, rtol,
                                                 atol):
    """T = 2 on cuda:0 against one device: parity at the JAX package's TP
    serving bound, fast at the bound of the math path against the kernels
    (the one-device step launches bsd and MCM; the shards launch none, as
    JAX routes a tensor-parallel mesh)."""
    one, two = _tp_steps(precision)
    before = [fn.launches for fn in (attention.bsd_attention,
                                     mcm_score.mcm_score, mlp.fused_mlp)]
    got = two[0].score(*two[1:]).cpu().numpy()
    assert [fn.launches for fn in (attention.bsd_attention,
                                   mcm_score.mcm_score,
                                   mlp.fused_mlp)] == before
    assert two[0].precision.attn_impl == "xla"
    want = one[0].score(*one[1:]).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("over", [{"attn_impl": "pallas_bsd"},
                                  {"attn_impl": "flash"},
                                  {"mlp_impl": "pallas"}])
def test_forced_kernel_refused_on_two_shards_of_one_card(cuda, over):
    from mcm_tpu_torch.config import CLIP_CONFIGS
    from mcm_tpu_torch.parallel import EvalStep
    from mcm_tpu_torch.parallel.mesh import make_local_mesh
    with pytest.raises(ValueError, match="tensor-parallel mesh .*SPMD "
                                         "partitioner"):
        EvalStep(CLIP_CONFIGS["ViT-B/16"](), mesh=make_local_mesh(
            2, 2, device="cuda:0"), precision=dataclasses.replace(
                Precision.fast(), **over))


# -- training: the trainable attention and matmul_f32's gradient -------------

@pytest.mark.parametrize("b", [2, 8])
def test_trainable_attention_runs_bsd_and_has_the_math_gradient(cuda, b):
    """``pallas_bsd_vjp``: the forward is one bsd launch (bit-equal to the
    kernel's output); the q/k/v gradients are bit-equal to
    ``torch.autograd.grad`` of the math path on the same inputs and
    upstream gradient, and the backward launches no kernel."""
    q, k, v = (t.requires_grad_()
               for t in _qkv((b, 197, 768), torch.bfloat16, cuda))
    g = _qkv((b, 197, 768), torch.bfloat16, cuda, seed=1)[0]
    prec = dataclasses.replace(Precision.fast(), attn_impl="pallas_bsd_vjp")
    before = attention.bsd_attention.launches
    out = attention.encoder_attention(q, k, v, heads=12, mask=None,
                                      precision=prec)
    torch.cuda.synchronize()
    assert attention.bsd_attention.launches == before + 1
    got = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert attention.bsd_attention.launches == before + 1
    kernel = attention.bsd_attention(q.detach(), k.detach(), v.detach(), 12)
    torch.testing.assert_close(out, kernel, rtol=0, atol=0)
    math_p = dataclasses.replace(prec, attn_impl="xla")
    ref = attention.encoder_attention(q, k, v, heads=12, mask=None,
                                      precision=math_p)
    want = torch.autograd.grad(ref, (q, k, v), g)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    # the forward is the kernel's: within one bf16 ulp of the plain
    # version's largest |x| (one output rounding the two may take apart)
    plain = attention.bsd_attention_reference(q.detach(), k.detach(),
                                              v.detach(), 12).float()
    ulp = 2.0 ** (math.floor(math.log2(plain.abs().max().item())) - 7)
    assert (out.float() - plain).abs().max().item() <= ulp


def _mm_inputs(cuda, batched):
    rng = np.random.default_rng(4)
    shape_a, shape_b = (((4, 197, 64), (4, 64, 197)) if batched
                        else ((4, 197, 768), (768, 512)))

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda, torch.bfloat16)

    a, b = bf16(shape_a), bf16(shape_b)
    # the cotangent of an fp32 product the towers round to bf16 next:
    # bf16 values in fp32
    g = bf16((*shape_a[:-1], shape_b[-1])).float()
    return a, b, g


@pytest.mark.parametrize("batched", [False, True])
def test_matmul_f32_forward_with_gradient_is_todays_product(cuda, batched):
    a, b, _ = _mm_inputs(cuda, batched)
    want = numerics._mm_out_f32(a, b)
    got = numerics.matmul_f32(a.requires_grad_(), b.requires_grad_())
    assert got.grad_fn is not None and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("batched", [False, True])
def test_matmul_f32_gradients_match_fp32(cuda, batched):
    """Input gradients in the inputs' dtype, within bf16's rounding
    (2^-8 relative) of an IEEE fp32 reference on the same values."""
    from mcm_tpu_torch.scores.clip_scores import ieee_fp32_matmul

    a, b, g = _mm_inputs(cuda, batched)
    a.requires_grad_()
    b.requires_grad_()
    ga, gb = torch.autograd.grad(numerics.matmul_f32(a, b), (a, b), g)
    af, bf = (t.detach().float().requires_grad_() for t in (a, b))
    with ieee_fp32_matmul():
        want_a, want_b = torch.autograd.grad(af @ bf, (af, bf), g)
    for got, want in ((ga, want_a), (gb, want_b)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want, rtol=2 ** -8,
                                   atol=1e-4 * want.abs().max().item())


def _tiny_bsd_clip():
    from mcm_tpu_torch.config import CLIPConfig, TextConfig, VisionConfig
    # width 128, 2 heads (Dh = 64): shapes the bsd kernel takes
    return CLIPConfig(
        name="tiny", vision=VisionConfig(image_size=32, patch_size=8,
                                         width=128, layers=2, heads=2,
                                         projection_dim=32),
        text=TextConfig(vocab_size=128, context_length=16, width=128,
                        layers=2, heads=2, projection_dim=32))


@pytest.mark.parametrize("attn,remat,bsd_per_step", [
    ("xla", True, 0), ("pallas_bsd_vjp", True, 4),
    ("pallas_bsd_vjp", False, 2)])
def test_bf16_train_step_runs_on_the_card(cuda, attn, remat, bsd_per_step):
    """A fast-mode (bf16) step differentiates every product on the card;
    the trainable route launches bsd once a vision layer, twice under
    remat (the recompute), never in the masked text tower."""
    from mcm_tpu_torch.models.init import init_clip
    from mcm_tpu_torch.train import make_train_step

    cfg = _tiny_bsd_clip()
    prec = dataclasses.replace(Precision.fast(), attn_impl=attn)
    init_state, step = make_train_step(cfg, precision=prec, device=cuda,
                                       remat=remat)
    state = init_state(init_clip(0, cfg))
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, size=(8, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1, 100, size=(8, 16)).astype(np.int32)
    ids[:, -1] = 127
    mask = np.ones_like(ids)
    losses = []
    before = attention.bsd_attention.launches
    for _ in range(5):
        state, loss = step(state, images, ids, mask)
        losses.append(float(loss))
    assert attention.bsd_attention.launches == before + 5 * bsd_per_step
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state.step == 5
    for p in state.params.parameters():
        assert p.dtype == torch.float32 and p.grad is not None


def test_native_decoder_builds_and_loads_on_the_card_host(cuda, tmp_path):
    """The card host's decode route: the native decoder builds against the
    first ABI-62 libjpeg there (Pillow's bundled copy where the system has
    none), passes its load-time self-test, and decodes a JPEG to the
    pipeline's batch within PIL's ±2 LSB."""
    import io

    from PIL import Image

    from mcm_tpu_torch.data.transforms import preprocess_uint8
    from mcm_tpu_torch.runtime import native

    info = native.native_info()
    assert info["available"], info["reason"]
    dec = native.load_decoder(build_dir=str(tmp_path))
    assert dec.libjpeg == info["libjpeg"]
    rng = np.random.default_rng(0)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)
                    ).save(buf, "JPEG", quality=87)
    got = dec.decode_one_mem(buf.getvalue(), 224)
    with Image.open(io.BytesIO(buf.getvalue())) as img:
        ref = preprocess_uint8(img, 224)
    diff = np.abs(got.astype(np.int32) - ref)
    assert diff.max() <= 2 and diff.mean() < 0.5


# -- data parallelism in one process: two replicas of card 0 ------------------

def test_local_mesh_train_step_on_two_replicas_matches_one_device(cuda):
    """A parity train step on ``make_mesh(2, device="cuda:0")`` (two
    replicas of card 0, the batch of 8 split 4 + 4, the joins and the
    gradient sum device to device) against the one-device step: the loss
    at rel 1e-5 and every leaf's gradient within 1e-4 of its largest |g|
    (a leaf that is all rounding, the key biases, within 1e-6 of the
    largest of all)."""
    from mcm_tpu_torch.models.init import init_clip
    from mcm_tpu_torch.parallel.mesh import make_mesh
    from mcm_tpu_torch.train import make_train_step

    cfg = _tiny_bsd_clip()
    params = init_clip(0, cfg)
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, size=(8, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1, 100, size=(8, 16)).astype(np.int32)
    ids[:, -1] = 127
    ids[6] = ids[1]   # a duplicate caption across the two stripes
    mask = np.ones_like(ids)
    out = []
    for mesh in (None, make_mesh(2, device="cuda:0")):
        init_state, step = make_train_step(
            cfg, precision=Precision.parity(), device=cuda, mesh=mesh,
            remat=False, optimizer=lambda named: torch.optim.SGD(
                [p for _, p in named], lr=0.0))
        state, loss = step(init_state(params), images, ids, mask)
        out.append((float(loss), {
            n: p.grad.float().cpu().numpy()
            for n, p in state.params.named_parameters()}))
    (want_loss, want), (got_loss, got) = out
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    top = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        scale = float(np.abs(w).max())
        bound = 1e-4 * scale if scale > 1e-5 * top else 1e-6 * top
        assert np.abs(got[n] - w).max() <= bound, n


def test_vit_linear_step_on_two_replicas_matches_one_device(cuda):
    """``VitLinearStep`` on two replicas of card 0 against one device, in
    fast mode: each replica's stripe of 4 launches bsd once a layer, and
    the logits and scores agree within the bucket bound (a stripe of 4
    sums in another order than a batch of 8)."""
    from mcm_tpu_torch.config import SupervisedViTConfig
    from mcm_tpu_torch.models.init import init_supervised_vit
    from mcm_tpu_torch.parallel import VitLinearStep
    from mcm_tpu_torch.parallel.eval_step import Replicated, Striped, to_host
    from mcm_tpu_torch.parallel.mesh import make_mesh

    cfg = SupervisedViTConfig(width=128, layers=2, heads=2, num_classes=10)
    params = init_supervised_vit(0, cfg)
    images = np.random.default_rng(6).integers(0, 256, size=(8, 224, 224, 3),
                                               dtype=np.uint8)
    out = []
    for mesh in (make_mesh(1, device="cuda:0"), make_mesh(2, device="cuda:0")):
        step = VitLinearStep(cfg, precision=Precision.fast(), mesh=mesh)
        model = step.put_params(params)
        before = attention.bsd_attention.launches
        feats = step.features(model, step.put_batch(images))
        scores = step.score(model, step.put_batch(images))
        torch.cuda.synchronize()
        out.append((to_host(feats), to_host(scores),
                    attention.bsd_attention.launches - before))
        if len(mesh.devices) > 1:
            assert isinstance(model, Replicated)
            assert isinstance(scores, Striped) and len(scores) == 2
    (f1, s1, n1), (f2, s2, n2) = out
    assert n1 == 2 * cfg.layers and n2 == 2 * 2 * cfg.layers
    np.testing.assert_allclose(f2, f1, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(s2, s1, rtol=5e-3, atol=5e-4)


# -- dense epilogue: bit-equal to the plain chain --------------------------------

#: (rows, N): ViT-L/14 at B = 512 (q/k/v/o and fc2 at 1024, fc1 at 4096),
#: ViT-B/16 at B = 512 (768, 3072), the text tower of B/16 on 1,000 prompts
#: of 77 tokens (512, 2048), widths that end in a part of a 256-column tile
#: (1000, 12), and widths that take the scalar kernel (771, 1); ViT-bigG/14
#: at B = 512 (1664, fc1 at 8192) and its text tower (1280, fc1 at 5120)
_EPI_SHAPES = [(512 * 257, 1024), (512 * 257, 4096), (512 * 197, 768),
               (512 * 197, 3072), (1000 * 77, 512), (1000 * 77, 2048),
               (37, 1000), (5, 12), (37, 771), (3, 1),
               (512 * 257, 1664), (512 * 257, 8192), (1000 * 77, 5120)]
_EPI_MODES = ["bias", "bias_quick_gelu", "bias_residual", "bias_gelu"]
_EPI_KW = {"bias_quick_gelu": lambda r: {"act": "quick_gelu"},
           "bias_gelu": lambda r: {"act": "gelu"},
           "bias_residual": lambda r: {"residual": r}}


def _epi_operands(rows, n, device, seed=0):
    """An fp32 product of a few units, an fp32 bias, a bf16 residual; the
    first row holds both tails of QuickGELU and the GELU (expf overflows
    at -1e4)."""
    gen = torch.Generator(device=device).manual_seed(seed + rows + n)
    acc = torch.randn((rows, n), generator=gen, device=device) * 3.0
    special = torch.tensor([-1e4, -100.0, -20.0, -5.0, -0.5, 0.0, 0.5, 5.0,
                            20.0, 100.0, 1e4], device=device)
    k = min(n, special.numel())
    acc[0, :k] = special[:k]
    b = torch.randn((n,), generator=gen, device=device) * 0.5
    r = torch.randn((rows, n), generator=gen, device=device).bfloat16()
    return acc, b, r


def _bits_equal(got, want):
    return got.dtype == want.dtype and torch.equal(got.view(torch.int16),
                                                   want.view(torch.int16))


@pytest.mark.parametrize("mode", _EPI_MODES)
@pytest.mark.parametrize("rows,n", _EPI_SHAPES)
def test_dense_epilogue_is_bit_equal_to_the_plain_chain(cuda, rows, n, mode):
    from mcm_tpu_torch.ops import dense_epilogue as epi
    acc, b, r = _epi_operands(rows, n, cuda)
    kw = _EPI_KW.get(mode, lambda r: {})(r)
    before = epi.dense_epilogue.launches, epi.dense_epilogue.gelu_launches
    got = epi.dense_epilogue(acc, b, **kw)
    torch.cuda.synchronize()
    assert (epi.dense_epilogue.launches, epi.dense_epilogue.gelu_launches) \
        == (before[0] + 1, before[1] + (mode == "bias_gelu"))
    want = epi.epilogue_reference(acc, b, torch.bfloat16, **kw)
    assert _bits_equal(got, want)


@pytest.mark.parametrize("mode", _EPI_MODES)
def test_dense_epilogue_off_16_byte_alignment(cuda, mode):
    """A product that starts 4 bytes into its storage takes the scalar
    kernel at a width of 1024, with the same bits."""
    from mcm_tpu_torch.ops import dense_epilogue as epi
    acc, b, r = _epi_operands(64, 1024, cuda, seed=1)
    shifted = torch.empty(acc.numel() + 1, device=cuda)[1:].view(acc.shape)
    shifted.copy_(acc)
    assert shifted.data_ptr() % 16 != 0
    kw = _EPI_KW.get(mode, lambda r: {})(r)
    got = epi.dense_epilogue(shifted, b, **kw)
    assert _bits_equal(got, epi.epilogue_reference(acc, b, torch.bfloat16,
                                                   **kw))


@pytest.mark.parametrize("bad", ["non-contiguous residual",
                                 "residual of another dtype"])
def test_dense_raises_where_the_kernel_cannot_take_its_inputs(cuda, bad):
    """On the card a bf16 ``_dense`` with a bias is the kernel's route; a
    residual the kernel cannot read raises there instead of falling back
    to the plain chain."""
    from mcm_tpu_torch.models import clip as tclip
    from mcm_tpu_torch.ops import dense_epilogue as epi

    x = torch.randn((4, 8, 32), device=cuda).bfloat16()
    w = torch.randn((32, 16), device=cuda).bfloat16()
    b = torch.randn((16,), device=cuda)
    r = (torch.randn((4, 8, 32), device=cuda).bfloat16()[..., ::2]
         if bad == "non-contiguous residual"
         else torch.randn((4, 8, 16), device=cuda))
    launched, plain = epi.dense_epilogue.launches, tclip._dense.plain
    with pytest.raises(ValueError):
        tclip._dense(x, w, b, Precision.fast(), residual=r)
    assert (epi.dense_epilogue.launches, tclip._dense.plain) == (launched,
                                                                 plain)


def test_l14_tower_is_bit_equal_with_and_without_the_epilogue(cuda,
                                                              monkeypatch):
    """``encode_image`` at ViT-L/14, B = 8, fast: the features with the
    route on equal those with it off to the bit, and the tower launches
    the epilogue 144 times (24 layers × 6 products with a bias) and takes
    the plain chain twice (``patch_embed``, ``proj``)."""
    from mcm_tpu_torch.config import CLIP_CONFIGS
    from mcm_tpu_torch.models import clip as tclip
    from mcm_tpu_torch.models.init import init_vision
    from mcm_tpu_torch.ops import dense_epilogue as epi

    cfg = CLIP_CONFIGS["ViT-L/14"]().vision
    tree = init_vision(0, cfg)
    rng = np.random.default_rng(2)
    for group in tree["layers"].values():
        for name in group:
            if name.startswith("b"):
                group[name] = (0.1 * rng.standard_normal(
                    group[name].shape)).astype(np.float32)
    params = tclip.ParamTree({"vision": tree}, cuda, torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal(
        (8, cfg.image_size, cfg.image_size, 3)).astype(np.float32)).to(cuda)
    fast = Precision.fast()
    def totals():
        return epi.dense_epilogue.launches, tclip._dense.plain

    with torch.no_grad():
        launched, plain = totals()
        got = tclip.encode_image(params, cfg, x, fast)
        torch.cuda.synchronize()
        assert totals() == (launched + 144, plain + 2)
        monkeypatch.setattr(epi, "takes_kernel", lambda *a, **k: False)
        want = tclip.encode_image(params, cfg, x, fast)
        assert totals() == (launched + 144, plain + 2 + 146)
    assert bool(torch.isfinite(got.float()).all())
    assert _bits_equal(got, want)


# -- attention at ViT-bigG/14's head of 104 --------------------------------------

@pytest.mark.parametrize("width,route", [(1664, "math"), (1024, "bsd")],
                         ids=["bigg", "l14"])
def test_encoder_attention_route_is_counted(cuda, width, route):
    """``encoder_attention`` at (B, S, D, H) = (2, 257, width, 16) in bf16:
    ViT-bigG/14's head of 104 takes the math path, bit-equal to
    ``_math_attention`` on the split heads, and counts as
    ``encoder_attention.math``; ViT-L/14's head of 64 takes the bsd kernel
    and counts as ``encoder_attention.bsd``, within the bf16 bound of the
    math path."""
    from mcm_tpu_torch.ops import attention
    q, k, v = _qkv((2, 257, width), torch.bfloat16, cuda)
    fast = Precision.fast()

    def counts():
        return (attention.encoder_attention.bsd,
                attention.encoder_attention.math,
                attention.bsd_attention.launches)

    before = counts()
    got = attention.encoder_attention(q, k, v, heads=16, mask=None,
                                      precision=fast)
    torch.cuda.synchronize()
    bsd = route == "bsd"
    assert counts() == (before[0] + bsd, before[1] + (not bsd),
                        before[2] + bsd)

    def split(x):
        return x.reshape(2, 257, 16, width // 16).transpose(1, 2)

    want = attention._math_attention(split(q), split(k), split(v), None,
                                     fast).transpose(1, 2).reshape(2, 257,
                                                                   width)
    if bsd:
        torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                                   atol=5e-2)
    else:
        assert _bits_equal(got, want)
