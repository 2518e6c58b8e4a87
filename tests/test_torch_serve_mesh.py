"""Serving on a single-process mesh of several devices, on the CPU.

The port's ``OODDetector(n_devices=2, device="cpu")`` holds a model
replica on each of two CPU "devices", splits every padded bucket into two
stripes and joins the scores in row order.  It is held against the JAX
package's single-device ``OODDetector`` on the same ``.npz`` weights (the
tiny ViT-B/16 double, parity precision, buckets (2, 4)) at the bounds of
JAX's own mesh test (``tests/serve_mesh_suite.py``): rtol 1e-4 / atol 1e-5
direct, rtol 5e-3 / atol 5e-4 through the ``MicroBatcher``.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from mcm_tpu_torch.parallel import multihost
from mcm_tpu_torch.parallel.eval_step import Replicated, Striped, to_host
from mcm_tpu_torch.parallel.mesh import make_local_mesh

CLASSES = ["cat", "dog", "owl"]
IMGS = np.random.default_rng(21).integers(
    0, 256, size=(4, 224, 224, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """The tiny ViT-B/16 double's seed-0 weights as ``ViT-B-16.npz``."""
    from mcm_tpu_torch.config import CLIP_CONFIGS
    from mcm_tpu_torch.models.convert import save_params
    from mcm_tpu_torch.models.init import init_clip
    d = tmp_path_factory.mktemp("serve_mesh_ckpt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCM_TPU_TEST_TINY_B16", "1")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            save_params(init_clip(0, CLIP_CONFIGS["ViT-B/16"]()),
                        str(d / "ViT-B-16.npz"))
    return str(d)


def _build(module, ckpt_dir, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCM_TPU_TEST_TINY_B16", "1")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            # allow_random_weights only lets the hash tokenizer stand in
            det = module.OODDetector(**{
                "class_names": CLASSES, "ckpt_dir": ckpt_dir,
                "allow_random_weights": True, "precision": "parity",
                "batch_sizes": (2, 4), **kw})
    assert not [w for w in caught if "RANDOM WEIGHTS" in str(w.message)]
    return det


@pytest.fixture(scope="module")
def two(ckpt_dir):
    from mcm_tpu_torch import serve
    return _build(serve, ckpt_dir, n_devices=2, device="cpu")


@pytest.fixture(scope="module")
def one(ckpt_dir):
    from mcm_tpu_torch import serve
    return _build(serve, ckpt_dir, n_devices=1, device="cpu")


@pytest.fixture(scope="module")
def jax_single(ckpt_dir):
    from mcm_tpu import serve
    return _build(serve, ckpt_dir, n_devices=1)


def test_two_devices_match_jax_single_device(two, jax_single):
    got = two.score_images(IMGS)
    want = jax_single.score_images(IMGS)
    assert got.shape == (4,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_microbatcher_on_two_devices_matches_direct(two):
    from mcm_tpu_torch.serve import MicroBatcher
    direct = two.score_images(IMGS)
    with MicroBatcher(two, max_wait_ms=20) as mb:
        futs = [mb.submit(img) for img in IMGS]
        got = np.array([f.result(timeout=300) for f in futs], np.float32)
    # coalesced batches land on bucket 2 or 4, both split over the mesh
    np.testing.assert_allclose(got, direct, rtol=5e-3, atol=5e-4)
    assert mb.n_images == 4


def test_score_order_preserved(two, one):
    """Each row's score lands at its own index: scored alone (bucket 2, one
    row a stripe) and in the full batch (two rows a stripe), it is the
    single-device detector's."""
    full = two.score_images(IMGS)
    singles = np.array([two.score_images(IMGS[i])[0] for i in range(4)])
    np.testing.assert_allclose(full, singles, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(full, one.score_images(IMGS), rtol=1e-5,
                               atol=1e-6)
    assert len(set(np.round(full, 7))) == 4   # the rows are distinguishable


def test_every_stripe_on_its_device_and_replica(two, monkeypatch):
    """A bucket of 4 becomes two stripes of 2 rows; each replica encodes
    its own stripe with its own copy of the model."""
    from mcm_tpu_torch.models import clip as tclip
    batch = two.step.put_batch(IMGS)
    assert isinstance(batch, Striped) and [s.shape[0] for s in batch] == [2, 2]
    np.testing.assert_array_equal(to_host(batch), IMGS)
    assert isinstance(two.params, Replicated) and len(two.params) == 2
    assert two.params[0] is not two.params[1]
    assert isinstance(two.text_feats, Replicated)
    torch.testing.assert_close(two.text_feats[0], two.text_feats[1],
                               rtol=0, atol=0)
    seen = []
    real = tclip.encode_image

    def spy(params, *a, **k):
        seen.append(params)
        return real(params, *a, **k)

    monkeypatch.setattr(tclip, "encode_image", spy)
    scores = two.step.score(two.params, batch, two.text_feats)
    assert isinstance(scores, Striped) and len(scores) == 2
    assert seen == list(two.params)
    assert to_host(scores).shape == (4,)


def test_classify_and_maha_on_two_devices(two, one, tmp_path):
    idx2, s2 = two.classify_images(IMGS)
    idx1, s1 = one.classify_images(IMGS)
    np.testing.assert_array_equal(idx2, idx1)
    np.testing.assert_allclose(s2, s1, rtol=1e-5, atol=1e-6)
    rng = np.random.default_rng(3)
    mu = rng.standard_normal((3, 64)).astype(np.float32)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    prec = (np.eye(64) + 0.01 * (a @ a.T) / 64).astype(np.float32)
    path = str(tmp_path / "t.npz")
    np.savez(path, classwise_mean=mu, precision=prec, normalize=False)
    for det in (two, one):
        det.load_maha_templates(path)
    try:
        m2, m1 = two.score_images(IMGS), one.score_images(IMGS)
        np.testing.assert_allclose(m2, m1, rtol=1e-4, atol=1e-4)
        _, c2 = two.classify_images(IMGS)
        np.testing.assert_allclose(c2, m2, rtol=1e-4, atol=1e-4)
    finally:
        two._maha = one._maha = None


def test_score_files_and_warmup_on_two_devices(two, tmp_path):
    from PIL import Image
    paths = []
    for i, img in enumerate(IMGS[:3]):
        p = str(tmp_path / f"{i}.png")
        Image.fromarray(img).save(p)
        paths.append(p)
    got = two.score_files(paths, num_workers=1)
    np.testing.assert_allclose(got, two.score_images(IMGS[:3]), rtol=1e-5,
                               atol=1e-6)
    logs = []
    two.warmup(include_features=True, log=logs.append)
    assert logs == ["warmed bucket 2", "warmed bucket 4"]


def test_bucket_not_divisible_raises(ckpt_dir):
    from mcm_tpu_torch import serve
    with pytest.raises(ValueError, match=r"batch_sizes \[1, 3\] not "
                                         r"divisible by the data-parallel "
                                         r"mesh size 2"):
        _build(serve, ckpt_dir, n_devices=2, device="cpu",
               batch_sizes=(1, 2, 3, 4))


def test_more_cards_than_visible_raises(monkeypatch):
    """``cuda`` means cards 0 … n-1: asking for more than there are never
    shrinks quietly; ``cuda:K`` puts every replica on card K.  (No CUDA
    call is made: availability and count are stood in for.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 card.* visible"):
        make_local_mesh(2, device="cuda")
    assert make_local_mesh(None, device="cuda").devices == (
        torch.device("cuda", 0),)
    assert make_local_mesh(2, device="cuda:0").devices == (
        torch.device("cuda", 0),) * 2
    from mcm_tpu.parallel import make_mesh as jax_make_mesh
    with pytest.raises(ValueError) as want:
        jax_make_mesh(1, model_parallel=2)
    with pytest.raises(ValueError) as got:
        make_local_mesh(1, model_parallel=2, device="cpu")
    assert str(got.value) == str(want.value)
    # two consecutive devices a group: cuda:0, cuda:1 then cuda:2, cuda:3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    tp = make_local_mesh(4, model_parallel=2, device="cuda")
    assert tp.groups == ((torch.device("cuda", 0), torch.device("cuda", 1)),
                         (torch.device("cuda", 2), torch.device("cuda", 3)))
    assert tp.devices == (torch.device("cuda", 0), torch.device("cuda", 2))
    assert tp.shape == {"data": 2, "model": 2}


def test_detector_inside_a_process_group_raises(monkeypatch, ckpt_dir):
    from mcm_tpu_torch import serve
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        _build(serve, ckpt_dir, n_devices=2, device="cpu")


def test_http_server_on_two_devices(two):
    """A JSON request of three PNGs is scored over both replicas as the
    direct path scores the decoded pixels; ``/metrics`` names the
    replicas."""
    import base64
    import http.client
    import io

    from PIL import Image

    from mcm_tpu_torch.serve_http import OODServer, decode_image_bytes
    blobs = []
    for img in IMGS[:3]:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        blobs.append(buf.getvalue())
    body = json.dumps({"images_b64": [base64.b64encode(b).decode()
                                      for b in blobs]})
    with OODServer(two, host="127.0.0.1", port=0) as srv:
        srv.start()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        try:
            conn.request("POST", "/v1/score", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            status, reply = resp.status, json.loads(resp.read())
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
        finally:
            conn.close()
    assert status == 200
    want = two.score_images(np.stack([decode_image_bytes(b) for b in blobs]))
    np.testing.assert_allclose(reply["scores"], want, rtol=5e-3, atol=5e-4)
    assert 'mcm_replicas{device="cpu"} 2' in text


def test_http_cli_takes_a_card_index(monkeypatch):
    """``--device cuda:K`` is no longer refused by the parser: it reaches
    the detector, which raises here only because no card is present."""
    from mcm_tpu_torch import serve_http
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_http.main(["--in_dataset", "ImageNet10", "--device", "cuda:0",
                         "--n-devices", "2", "--allow-random-weights"])
    assert os.environ.get("WORLD_SIZE", "1") == "1"
