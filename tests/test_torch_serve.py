"""The port's serving API (``mcm_tpu_torch.serve``) against the JAX
package's ``mcm_tpu.serve`` on the CPU, with the tiny ViT-B/16 double
(``MCM_TPU_TEST_TINY_B16``), random weights from seed 0 in both (the same
numpy init and the same hash tokenizer) and buckets (1, 4).

Tolerances are those of the JAX package's serve tests
(``tests/test_serve.py``): scores of one bucket shape to rtol 1e-5 /
atol 1e-6, across packages or bucket shapes (bf16 summation order) to
rtol 5e-3 / atol 5e-4, Mahalanobis to rtol 1e-4 / atol 1e-4."""

import time
import warnings

import numpy as np
import pytest
import torch

from util_synth import make_imagefolder_tree


def _build(module, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCM_TPU_TEST_TINY_B16", "1")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return module.OODDetector(**{
                "class_names": ["cat", "dog", "owl"],
                "allow_random_weights": True, "batch_sizes": (1, 4),
                "n_devices": 1, **kw})


@pytest.fixture(scope="module")
def detector():
    from mcm_tpu_torch import serve
    return _build(serve, device="cpu")


@pytest.fixture(scope="module")
def jax_detector():
    from mcm_tpu import serve
    return _build(serve)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, size=(6, 224, 224, 3), dtype=np.uint8)


def _templates(tmp_path, seed=3, d=64, normalize=False, name="t.npz",
               **extra):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((3, d)).astype(np.float32)
    a = rng.standard_normal((d, d)).astype(np.float32)
    prec = (np.eye(d) + 0.01 * (a @ a.T) / d).astype(np.float32)
    path = tmp_path / name
    np.savez(path, classwise_mean=mu, precision=prec, normalize=normalize,
             **extra)
    return str(path), mu, prec


# -- the detector against JAX's ---------------------------------------------------

def test_scores_match_jax_detector(detector, jax_detector, images):
    got = detector.score_images(images)          # buckets (1, 4): 2 chunks
    want = jax_detector.score_images(images)
    assert got.shape == (6,) and got.dtype == np.float32
    assert np.isfinite(got).all() and (got <= 0).all() and (got >= -1).all()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)
    # padding does not leak: a prefix in the same bucket scores the same
    np.testing.assert_allclose(detector.score_images(images[:3]), got[:3],
                               rtol=1e-5, atol=1e-6)
    # one unbatched image: the bucket-1 shape
    np.testing.assert_allclose(detector.score_images(images[0]), got[:1],
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(detector.text_feats.numpy(),
                               np.asarray(jax_detector.text_feats),
                               rtol=0, atol=2e-2)


def test_classify_matches_jax_detector(detector, jax_detector, images):
    idx, scores = detector.classify_images(images)
    j_idx, j_scores = jax_detector.classify_images(images)
    assert idx.dtype == np.int64 and scores.dtype == np.float32
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_allclose(scores, j_scores, rtol=5e-3, atol=5e-4)
    # host fp32 scoring from device features tracks the device score path
    np.testing.assert_allclose(scores, detector.score_images(images),
                               rtol=5e-3, atol=5e-4)
    one_idx, _ = detector.classify_images(images[0])
    assert one_idx[0] == idx[0]


def test_refusals_are_client_errors(detector, images):
    from mcm_tpu_torch.serve import RequestRefused
    with pytest.raises(TypeError, match="uint8"):
        detector.score_images(images.astype(np.float32) / 255.0)
    with pytest.raises(TypeError, match="uint8"):
        detector.classify_images(images.astype(np.float32))
    for fn in (detector.score_images, detector.classify_images):
        with pytest.raises(RequestRefused, match="preprocessed"):
            fn(np.zeros((1, 128, 128, 3), np.uint8))
    import dataclasses
    orig = detector.cfg
    try:
        detector.cfg = dataclasses.replace(orig, score="odin")
        with pytest.raises(RequestRefused, match="use score_images"):
            detector.classify_images(images[:1])
    finally:
        detector.cfg = orig
    assert issubclass(RequestRefused, ValueError)


def test_multichunk_maha_classify_returns_score_images_scores(
        detector, jax_detector, images, tmp_path):
    """The JAX package's defect (ADVICE.md, high: ``serve.py:297-303``
    rebinds the per-request ``maha`` snapshot to the first chunk's scores)
    does not come across: classifying more images than the largest bucket
    under templates returns ``score_images``'s Mahalanobis scores, which
    equal JAX's ``score_images`` and the direct computation."""
    from mcm_tpu_torch.scores.mahalanobis import mahalanobis_score
    path, mu, prec = _templates(tmp_path)
    detector.load_maha_templates(path)
    jax_detector.load_maha_templates(path)
    try:
        assert len(images) > detector.batch_sizes[-1]
        maha = detector.score_images(images)
        idx, scores = detector.classify_images(images)
        np.testing.assert_allclose(scores, maha, rtol=1e-4, atol=1e-4)
        assert ((idx >= 0) & (idx < 3)).all()
        np.testing.assert_allclose(maha, jax_detector.score_images(images),
                                   rtol=5e-3, atol=5e-4)
        feats = detector.step.features(detector.params,
                                       detector.step.put_batch(images))
        want = mahalanobis_score(feats, torch.from_numpy(mu),
                                 torch.from_numpy(prec)).numpy()
        np.testing.assert_allclose(maha, want, rtol=1e-4, atol=1e-4)
    finally:
        detector._maha = None
        jax_detector._maha = None


def test_maha_templates_refusals_and_pt_pair(detector, tmp_path):
    path, mu, prec = _templates(tmp_path)
    with pytest.raises(ValueError, match="contradicts"):
        detector.load_maha_templates(path, normalize=True)
    legacy = tmp_path / "legacy.npz"
    np.savez(legacy, classwise_mean=mu, precision=prec)
    with pytest.raises(ValueError, match="normalize"):
        detector.load_maha_templates(str(legacy))
    # templates fingerprinted with other weights: refused only when the
    # detector's own weights have a fingerprint (random weights have none)
    signed, _, _ = _templates(tmp_path, name="signed.npz",
                              weight_sig='{"size": 1, "sha": "x"}')
    detector.load_maha_templates(signed)
    detector._maha = None

    mean_path = tmp_path / "CLIP_classwise_mean_pet37_250_False.pt"
    torch.save(torch.from_numpy(mu), mean_path)
    torch.save(torch.from_numpy(prec),
               tmp_path / "CLIP_precision_pet37_250_False.pt")
    with pytest.raises(ValueError, match="contradicts"):
        detector.load_maha_templates(str(mean_path), normalize=True)
    with pytest.raises(ValueError, match="classwise_mean"):
        detector.load_maha_templates(
            str(tmp_path / "CLIP_precision_pet37_250_False.pt"))
    detector.load_maha_templates(str(mean_path))
    try:
        got_mu, got_prec, got_norm = detector._maha
        np.testing.assert_array_equal(got_mu.numpy(), mu)
        np.testing.assert_array_equal(got_prec.numpy(), prec)
        assert got_norm is False
    finally:
        detector._maha = None


def test_maha_templates_of_other_weights_are_refused(tmp_path):
    """A detector on real (fingerprinted) weights refuses templates whose
    ``weight_sig`` names other weights, and takes its own."""
    from mcm_tpu_torch import serve
    from mcm_tpu_torch.config import CLIP_CONFIGS
    from mcm_tpu_torch.models.convert import file_identity, save_params
    from mcm_tpu_torch.models.init import init_clip
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCM_TPU_TEST_TINY_B16", "1")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            save_params(init_clip(1, CLIP_CONFIGS["ViT-B/16"]()),
                        str(tmp_path / "ViT-B-16.npz"))
    det = _build(serve, device="cpu", ckpt_dir=str(tmp_path))
    ident = file_identity(str(tmp_path / "ViT-B-16.npz"))
    own = ('{"size": %d, "sha": "%s"}'
           % (ident["size"], ident["sha256_sampled"]))
    other, _, _ = _templates(tmp_path, name="other.npz",
                             weight_sig='{"size": 1, "sha": "x"}')
    with pytest.raises(ValueError, match="different weights"):
        det.load_maha_templates(other)
    mine, _, _ = _templates(tmp_path, name="mine.npz", weight_sig=own)
    det.load_maha_templates(mine)
    assert det._maha is not None


def test_score_images_snapshots_the_scoring_family(detector, images,
                                                   monkeypatch):
    orig = detector._score_device
    seen = []

    def spy(images_device, maha=type(detector)._MAHA_LIVE):
        seen.append(maha)
        detector._maha = ("mu", "prec", False)   # a racing load lands
        return orig(images_device, maha=maha)

    monkeypatch.setattr(detector, "_score_device", spy)
    try:
        scores = detector.score_images(images)
        assert seen == [None, None]
        assert np.isfinite(scores).all()
    finally:
        detector._maha = None


@pytest.mark.parametrize("route", ["native", "pil"])
def test_score_files_matches_score_images(detector, tmp_path, monkeypatch,
                                          route):
    """``score_files`` decodes as the file pipeline does: natively by
    default, through PIL under ``MCM_TPU_DISABLE_NATIVE=1``; the images
    decoded on the same route score the same."""
    from mcm_tpu_torch.data.transforms import load_image_uint8
    from mcm_tpu_torch.runtime import native
    if route == "pil":
        monkeypatch.setenv("MCM_TPU_DISABLE_NATIVE", "1")
    else:
        assert native.native_available(), native.native_info()
    make_imagefolder_tree(str(tmp_path / "t"), ["x"], 5)
    paths = sorted(str(p) for p in (tmp_path / "t" / "x").iterdir())
    from_files = detector.score_files(paths, num_workers=1)
    decode = native.decode_one if route == "native" else load_image_uint8
    imgs = np.stack([decode(p) for p in paths])
    np.testing.assert_allclose(from_files, detector.score_images(imgs),
                               rtol=5e-3, atol=5e-4)
    out = detector.score_files([])
    assert out.shape == (0,) and out.dtype == np.float32


def test_calibrate_and_is_id(detector):
    rng = np.random.default_rng(1)
    id_scores = rng.uniform(-1.0, -0.6, 1000)
    thr = detector.calibrate(id_scores, tpr=0.95)
    assert thr == pytest.approx(np.quantile(id_scores, 0.95))
    assert detector.is_id(id_scores).mean() == pytest.approx(0.95, abs=0.01)
    assert not detector.is_id(np.array([-0.1])).any()
    detector.threshold = None
    with pytest.raises(RuntimeError, match="calibrate"):
        detector.is_id(id_scores)


def test_warmup_runs_every_bucket_in_order(detector, images):
    logs = []
    detector.warmup(include_features=True, log=logs.append)
    assert logs == ["warmed bucket 1", "warmed bucket 4"]
    assert detector._text_host is not None
    s1 = detector.score_images(images[:2])
    detector.warmup()
    np.testing.assert_array_equal(s1, detector.score_images(images[:2]))


def test_warmup_raises_a_bucket_failure(detector, monkeypatch):
    real_put = detector.step.put_batch
    logs = []

    def failing_put(batch):
        if batch.shape[0] == detector.batch_sizes[-1]:
            raise RuntimeError("synthetic bucket failure")
        return real_put(batch)

    monkeypatch.setattr(detector.step, "put_batch", failing_put)
    with pytest.raises(RuntimeError, match="synthetic bucket failure"):
        detector.warmup(log=logs.append)
    assert logs == ["warmed bucket 1"]


def test_detector_rejects_bad_configurations():
    from mcm_tpu_torch import serve
    with pytest.raises(ValueError, match="load_maha_templates"):
        serve.OODDetector(class_names=["a"], score="maha", device="cpu",
                          allow_random_weights=True)
    with pytest.raises(ValueError, match="non-empty"):
        _build(serve, device="cpu", batch_sizes=())
    with pytest.raises(ValueError, match="positive"):
        serve.OODDetector(class_names=["a"], allow_random_weights=True,
                          batch_sizes=(0, 4), device="cpu")
    # one device and model_parallel=2: JAX's detector raises its mesh's
    # error, and so does the port's
    from mcm_tpu import serve as jax_serve
    with pytest.raises(ValueError) as want:
        jax_serve.OODDetector(class_names=["a"], allow_random_weights=True,
                              model_parallel=2)
    with pytest.raises(ValueError) as got:
        serve.OODDetector(class_names=["a"], allow_random_weights=True,
                          device="cpu", model_parallel=2)
    assert str(got.value) == str(want.value) == (
        "1 devices not divisible by model_parallel=2")
    # two devices serve (buckets that split over them)
    two = _build(serve, device="cpu", n_devices=2, batch_sizes=(2, 4))
    assert two.step.mesh.devices == (torch.device("cpu"),) * 2
    assert two.cfg.n_devices == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.OODDetector(class_names=["a"], allow_random_weights=True)


def test_all_visible_devices_is_one_on_the_cpu():
    """The detector's mesh: 0 or None is every visible device, one replica
    on the CPU; a count is honoured."""
    from mcm_tpu_torch.parallel.mesh import make_local_mesh
    assert make_local_mesh(0, device="cpu").data == 1
    assert make_local_mesh(None, device="cpu").data == 1
    assert make_local_mesh(3, device="cpu").devices == (torch.device("cpu"),) * 3


# -- MicroBatcher ------------------------------------------------------------------


def test_microbatcher_coalesces_concurrent_submits(detector):
    from concurrent.futures import ThreadPoolExecutor

    from mcm_tpu_torch.serve import MicroBatcher
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, size=(24, 224, 224, 3), dtype=np.uint8)
    direct = detector.score_images(imgs)
    with MicroBatcher(detector, max_wait_ms=20) as mb:
        with ThreadPoolExecutor(8) as pool:
            futures = list(pool.map(mb.submit, imgs))
        got = np.array([f.result(timeout=300) for f in futures], np.float32)
    np.testing.assert_allclose(got, direct, rtol=5e-3, atol=5e-4)
    assert mb.n_images == 24
    # buckets (1, 4): at least 6 batches, and far fewer than one a request
    assert 6 <= mb.n_batches <= 12, mb.n_batches


def test_microbatcher_idle_resolution_and_reuse(detector):
    from mcm_tpu_torch.serve import MicroBatcher
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, size=(224, 224, 3), dtype=np.uint8)
    with MicroBatcher(detector, max_wait_ms=1) as mb:
        s1 = mb.submit(img).result(timeout=300)
        s2 = mb.submit(img).result(timeout=300)
        assert s1 == s2
        assert mb.score(np.stack([img, img])).shape == (2,)


def test_microbatcher_rejects_bad_input(detector):
    from mcm_tpu_torch.serve import BatcherClosed, MicroBatcher, RequestRefused
    with MicroBatcher(detector) as mb:
        with pytest.raises(TypeError, match="uint8"):
            mb.submit(np.zeros((224, 224, 3), np.float32))
        with pytest.raises(RequestRefused, match="one \\["):
            mb.submit(np.zeros((2, 224, 224, 3), np.uint8))
    with pytest.raises(BatcherClosed, match="closed"):
        mb.submit(np.zeros((224, 224, 3), np.uint8))
    assert not mb.alive
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatcher(detector, max_batch=512)


def test_microbatcher_fans_out_dispatch_failure(detector, monkeypatch):
    from mcm_tpu_torch.serve import MicroBatcher

    def boom(images_device):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(detector, "_score_device", boom)
    with MicroBatcher(detector, max_wait_ms=1) as mb:
        fut = mb.submit(np.zeros((224, 224, 3), np.uint8))
        with pytest.raises(RuntimeError, match="illegal memory access"):
            fut.result(timeout=60)
        assert mb.alive   # one failed batch does not stop the loop


def test_microbatcher_fans_out_readback_failure(detector, monkeypatch):
    """A CUDA error surfaces at the readback of an asynchronous batch: its
    futures fail and the dispatcher keeps serving."""
    from mcm_tpu_torch.serve import MicroBatcher

    class Poisoned:
        def __array__(self, *a, **k):
            raise RuntimeError("CUDA error: device-side assert triggered")

    real = detector._score_device
    calls = []

    def poisoned_once(images_device):
        calls.append(1)
        return Poisoned() if len(calls) == 1 else real(images_device)

    monkeypatch.setattr(detector, "_score_device", poisoned_once)
    img = np.zeros((224, 224, 3), np.uint8)
    with MicroBatcher(detector, max_wait_ms=1) as mb:
        with pytest.raises(RuntimeError, match="device-side assert"):
            mb.submit(img).result(timeout=60)
        assert np.isfinite(mb.submit(img).result(timeout=60))


def test_microbatcher_crash_fails_queued_and_in_flight(detector,
                                                       monkeypatch):
    """A failure of the dispatcher loop itself fails every queued and
    in-flight future and marks the batcher dead."""
    from mcm_tpu_torch.serve import BatcherClosed, MicroBatcher

    def slow(images_device):
        time.sleep(0.2)
        return np.zeros(int(images_device.shape[0]), np.float32)

    monkeypatch.setattr(detector, "_score_device", slow)
    # the loop's own re-raise reaches threading's excepthook
    monkeypatch.setattr("threading.excepthook", lambda args: None)
    mb = MicroBatcher(detector, max_wait_ms=1)
    try:
        # the dispatcher is already blocked in its first _collect: the
        # next call, made while f0's batch is in flight, is the fault
        def crash(block):
            raise SystemError("dispatcher loop fault")

        mb._collect = crash
        img = np.zeros((224, 224, 3), np.uint8)
        f0 = mb.submit(img)
        time.sleep(0.05)
        f1 = mb.submit(img)
        for f in (f0, f1):
            with pytest.raises(SystemError, match="loop fault"):
                f.result(timeout=60)
        mb._thread.join(timeout=60)
        assert not mb._thread.is_alive() and not mb.alive
        with pytest.raises(BatcherClosed):
            mb.submit(img)
    finally:
        mb.close()


def test_microbatcher_close_drains_in_flight(detector):
    from mcm_tpu_torch.serve import MicroBatcher
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, size=(6, 224, 224, 3), dtype=np.uint8)
    mb = MicroBatcher(detector, max_wait_ms=50)
    futures = [mb.submit(img) for img in imgs]
    mb.close()
    for f in futures:
        assert np.isfinite(f.result(timeout=300))


def _slow_fake_scores(detector, monkeypatch, delay=0.25):
    def fake(images_device):
        time.sleep(delay)
        return np.zeros(int(images_device.shape[0]), np.float32)

    monkeypatch.setattr(detector, "_score_device", fake)


def test_microbatcher_cancelled_request_is_skipped(detector, monkeypatch):
    from mcm_tpu_torch.serve import MicroBatcher
    _slow_fake_scores(detector, monkeypatch)
    img = np.zeros((224, 224, 3), np.uint8)
    with MicroBatcher(detector, max_wait_ms=1) as mb:
        f0 = mb.submit(img)
        time.sleep(0.05)
        f1 = mb.submit(img)
        f2 = mb.submit(img)
        assert f1.cancel()
        assert f2.result(timeout=60) == 0.0
        assert f0.result(timeout=60) == 0.0
        assert f1.cancelled()
        assert mb.submit(img).result(timeout=60) == 0.0
    assert mb.n_images == 3


def test_microbatcher_max_pending_backpressure(detector, monkeypatch):
    from mcm_tpu_torch.serve import MicroBatcher, Overloaded
    _slow_fake_scores(detector, monkeypatch)
    img = np.zeros((224, 224, 3), np.uint8)
    with MicroBatcher(detector, max_wait_ms=1, max_pending=2) as mb:
        f0 = mb.submit(img)
        time.sleep(0.05)
        f1 = mb.submit(img)
        with pytest.raises(Overloaded, match="max_pending=2"):
            mb.submit(img)
        assert f0.result(timeout=60) == 0.0
        assert f1.result(timeout=60) == 0.0
        assert mb.submit(img).result(timeout=60) == 0.0


def test_microbatcher_score_awaits_prefix_on_overload(detector, monkeypatch):
    from mcm_tpu_torch.serve import MicroBatcher, Overloaded
    _slow_fake_scores(detector, monkeypatch)
    imgs = np.zeros((4, 224, 224, 3), np.uint8)
    with MicroBatcher(detector, max_wait_ms=1, max_pending=2) as mb:
        with pytest.raises(Overloaded):
            mb.score(imgs)
        deadline = time.monotonic() + 10
        while mb.pending and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mb.pending == 0
        assert mb.submit(imgs[0]).result(timeout=60) == 0.0


def test_microbatcher_extra_load_sheds(detector):
    from mcm_tpu_torch.serve import MicroBatcher, Overloaded
    img = np.zeros((224, 224, 3), np.uint8)
    with MicroBatcher(detector, max_pending=2, extra_load=lambda: 2) as mb:
        with pytest.raises(Overloaded):
            mb.submit(img)
    with MicroBatcher(detector, max_pending=2, extra_load=lambda: 1) as mb:
        assert mb.submit(img).result(timeout=60) is not None


def test_microbatcher_copies_the_submitted_buffer(detector):
    from mcm_tpu_torch.serve import MicroBatcher
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, size=(224, 224, 3), dtype=np.uint8)
    expected = detector.score_images(img)
    buf = img.copy()
    with MicroBatcher(detector, max_wait_ms=200) as mb:
        fut = mb.submit(buf)
        buf[:] = 0
        got = fut.result(timeout=300)
    np.testing.assert_allclose(got, expected[0], rtol=1e-6, atol=1e-7)
