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
it at ~1e-13 after cancelling ``p - mean``: rtol 1e-4 there.
"""

import numpy as np
import pytest
import torch

from mcm_tpu_torch.config import Precision
from mcm_tpu_torch.ops import attention, mcm_score

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
