"""The port's HTTP front end (``mcm_tpu_torch.serve_http``) on the CPU,
with the tiny ViT-B/16 double and buckets (1, 4): request decode, scoring
through the MicroBatcher, thresholding, metrics, every endpoint and
status, and the CLI's SIGTERM drain.  The cases of the JAX package's
``tests/test_serve_http.py``, on the port, plus the statuses the port
changes: only :class:`~mcm_tpu_torch.serve.RequestRefused` is a 400, an
internal ``ValueError`` (or any other exception out of scoring) is a
logged 500 (``ADVICE.md``, low: the JAX package answers every
``ValueError`` with 400), and a closed batcher is a 503.

Every socket and subprocess wait has its own timeout."""

import base64
import http.client
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def detector():
    from mcm_tpu_torch.serve import OODDetector
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCM_TPU_TEST_TINY_B16", "1")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return OODDetector(class_names=["cat", "dog", "owl"],
                               allow_random_weights=True,
                               batch_sizes=(1, 4), device="cpu")


@pytest.fixture(scope="module")
def server(detector):
    from mcm_tpu_torch.serve_http import OODServer
    with OODServer(detector, host="127.0.0.1", port=0,
                   max_wait_ms=2.0) as srv:
        yield srv.start()


def _request(server, method, path, body=None, ctype="image/jpeg"):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        headers = {"Content-Type": ctype} if body is not None else {}
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _jpeg_bytes(rng, w=260, h=300, quality=92):
    from PIL import Image
    img = Image.fromarray(
        rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _raw_exchange(server, raw: bytes, timeout=20.0) -> bytes:
    """Send raw bytes, read until the server closes."""
    with socket.create_connection(("127.0.0.1", server.port),
                                  timeout=timeout) as s:
        s.sendall(raw)
        data = b""
        try:
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
        except TimeoutError:
            pass
        return data


# -- decode ---------------------------------------------------------------------

@pytest.mark.parametrize("route", ["native", "pil"])
def test_decode_image_bytes_matches_the_file_pipeline(tmp_path, monkeypatch,
                                                      route):
    """Request bytes decode as the same file through ``DataPipeline``, on
    either route (``MCM_TPU_DISABLE_NATIVE=1``: PIL on both)."""
    from PIL import Image

    from mcm_tpu_torch.data import DataPipeline
    from mcm_tpu_torch.runtime import native
    from mcm_tpu_torch.serve_http import decode_image_bytes, decode_images_bulk
    if route == "pil":
        monkeypatch.setenv("MCM_TPU_DISABLE_NATIVE", "1")
    assert native.native_available() == (route == "native")
    data = _jpeg_bytes(np.random.default_rng(0))
    p = tmp_path / "img.jpg"
    p.write_bytes(data)
    batch = next(iter(DataPipeline([(str(p), 0)], 1, num_workers=1)))
    assert np.array_equal(decode_image_bytes(data), batch.images[0])
    buf = io.BytesIO()
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(buf, "PNG")
    assert decode_image_bytes(buf.getvalue()).shape == (224, 224, 3)
    with pytest.raises(ValueError, match="undecodable"):
        decode_image_bytes(b"definitely not an image")
    bulk = decode_images_bulk([data, buf.getvalue()])
    assert np.array_equal(bulk[0], decode_image_bytes(data))
    with pytest.raises(ValueError, match=r"images_b64\[1\]"):
        decode_images_bulk([data, b"junk", data])


def test_bulk_decode_falls_back_per_row_and_matches_jax(monkeypatch):
    """A bulk request decodes on the native pool, and only its refused rows
    (a PNG, a scan cut short) go to PIL, without a second native parse;
    every row equals the JAX server's decode of it."""
    from PIL import Image

    from mcm_tpu.serve_http import decode_images_bulk as jax_bulk
    from mcm_tpu_torch.runtime import native
    from mcm_tpu_torch.serve_http import decode_images_bulk
    rng = np.random.default_rng(5)
    jpeg = _jpeg_bytes(rng)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
                    ).save(buf, "PNG")
    cut = jpeg[:len(jpeg) // 2] + b"\xff\xd9"   # PIL fills grey
    rows = [jpeg, buf.getvalue(), cut, _jpeg_bytes(rng, w=500, h=375)]
    want = jax_bulk(rows)

    def no_second_parse(*a, **k):
        raise AssertionError("a refused row was parsed natively again")

    monkeypatch.setattr(native, "decode_one_mem", no_second_parse)
    got = decode_images_bulk(rows)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _, status = native.decode_mem_batch(rows)
    assert status.tolist()[:3] == [0, 1, 1]


def _bomb(side: int) -> bytes:
    """A small JPEG whose frame header declares side x side pixels."""
    data = bytearray(_jpeg_bytes(np.random.default_rng(4), w=64, h=48))
    i = 2
    while True:
        marker, seg_len = data[i + 1], int.from_bytes(data[i + 2:i + 4],
                                                      "big")
        if marker in (0xC0, 0xC2):
            data[i + 5:i + 9] = side.to_bytes(2, "big") * 2
            return bytes(data)
        i += 2 + seg_len


@pytest.mark.parametrize("side,match", [
    (10000, "declares"),        # past the cap, below PIL's own refusal
    (60000, "undecodable")])    # PIL's DecompressionBombError
def test_decode_refuses_a_decompression_bomb(server, side, match):
    from mcm_tpu_torch.serve_http import decode_image_bytes
    with pytest.raises(ValueError, match=match):
        decode_image_bytes(_bomb(side))
    status, body, _ = _request(server, "POST", "/v1/score", _bomb(side))
    assert status == 400 and match in json.loads(body)["error"]


# -- endpoints ------------------------------------------------------------------

def test_score_single_jpeg_matches_detector(server, detector):
    from mcm_tpu_torch.serve_http import decode_image_bytes
    data = _jpeg_bytes(np.random.default_rng(1))
    status, body, _ = _request(server, "POST", "/v1/score", data)
    assert status == 200
    out = json.loads(body)
    direct = detector.score_images(decode_image_bytes(data)[None])
    np.testing.assert_allclose(out["scores"], direct, rtol=1e-5, atol=1e-6)
    assert "is_id" not in out


def test_score_json_batch(server, detector):
    from mcm_tpu_torch.serve_http import decode_image_bytes
    rng = np.random.default_rng(2)
    blobs = [_jpeg_bytes(rng, w=230 + 10 * i) for i in range(3)]
    payload = json.dumps(
        {"images_b64": [base64.b64encode(b).decode() for b in blobs]})
    status, body, _ = _request(server, "POST", "/v1/score", payload,
                               ctype="application/json")
    assert status == 200
    imgs = np.stack([decode_image_bytes(b) for b in blobs])
    np.testing.assert_allclose(json.loads(body)["scores"],
                               detector.score_images(imgs),
                               rtol=5e-3, atol=5e-4)


def test_classify_endpoint(server, detector):
    from mcm_tpu_torch.serve_http import decode_image_bytes
    rng = np.random.default_rng(12)
    blobs = [_jpeg_bytes(rng, w=235 + 9 * i) for i in range(6)]
    payload = json.dumps(
        {"images_b64": [base64.b64encode(b).decode() for b in blobs],
         "classify": True})
    status, body, _ = _request(server, "POST", "/v1/score", payload,
                               ctype="application/json")
    assert status == 200
    out = json.loads(body)
    idx, scores = detector.classify_images(
        np.stack([decode_image_bytes(b) for b in blobs]))
    assert out["class_index"] == idx.tolist()
    assert out["class_name"] == [detector.class_names[i] for i in idx]
    np.testing.assert_allclose(out["scores"], scores, rtol=1e-5, atol=1e-6)
    status, body, _ = _request(server, "POST", "/v1/score?classify=1",
                               blobs[0])
    assert status == 200
    out1 = json.loads(body)
    assert out1["class_name"][0] == out["class_name"][0]
    np.testing.assert_allclose(out1["scores"], out["scores"][:1],
                               rtol=5e-3, atol=5e-4)


def test_is_id_appears_once_calibrated(server, detector):
    data = _jpeg_bytes(np.random.default_rng(3))
    old = detector.threshold
    try:
        detector.threshold = 0.0  # MCM scores are < 0: everything ID
        status, body, _ = _request(server, "POST", "/v1/score", data)
        out = json.loads(body)
        assert status == 200
        assert out["threshold"] == 0.0 and out["is_id"] == [True]
        detector.threshold = -2.0
        status, body, _ = _request(server, "POST", "/v1/score", data)
        assert json.loads(body)["is_id"] == [False]
    finally:
        detector.threshold = old


def test_healthz_and_metrics(server):
    status, body, _ = _request(server, "GET", "/healthz")
    assert status == 200
    health = json.loads(body)
    assert health["status"] == "ok" and health["model"] == "ViT-B/16"
    assert health["batch_buckets"] == [1, 4]
    _request(server, "POST", "/v1/score",
             _jpeg_bytes(np.random.default_rng(4)))
    status, body, headers = _request(server, "GET", "/metrics")
    assert status == 200
    text = body.decode()
    assert headers["Content-Type"].startswith("text/plain")
    assert 'mcm_requests_total{endpoint="/v1/score",status="200"}' in text
    for name in ("mcm_images_total", "mcm_coalescing_ratio",
                 "mcm_device_batches_total",
                 "mcm_score_latency_seconds_count"):
        assert name in text


def test_client_error_paths_are_400(server):
    assert _request(server, "GET", "/nope")[0] == 404
    assert _request(server, "POST", "/nope", b"x")[0] == 404
    status, body, _ = _request(server, "POST", "/v1/score", b"garbage")
    assert status == 400 and "undecodable" in json.loads(body)["error"]
    for payload in (b"{not json", b'{"images": []}',
                    b'{"images_b64": ["!!!not-b64!!!"]}',
                    b'{"images_b64": []}'):
        status, _, _ = _request(server, "POST", "/v1/score", payload,
                                ctype="application/json")
        assert status == 400, payload


def test_detector_refusal_is_a_400(server, monkeypatch):
    from mcm_tpu_torch.serve import RequestRefused

    def refuse(images):
        raise RequestRefused("classify_images supports ... use score_images")

    monkeypatch.setattr(server.detector, "classify_images", refuse)
    status, body, _ = _request(server, "POST", "/v1/score?classify=1",
                               _jpeg_bytes(np.random.default_rng(7)))
    assert status == 400
    assert "score_images" in json.loads(body)["error"]


@pytest.mark.parametrize("exc", [
    ValueError("not enough values to unpack (expected 3, got 1)"),
    RuntimeError("CUDA error: an illegal memory access at /secret/path"),
    IndexError("index 4 is out of bounds")])
def test_internal_errors_are_logged_500s(detector, exc, caplog):
    """The ADVICE.md defect (low) does not come across: a ValueError from
    inside the step is the server's fault, not the client's — a 500 with a
    generic body, logged with its traceback, as is any other exception
    out of scoring."""
    from mcm_tpu_torch.serve_http import OODServer
    with OODServer(detector, host="127.0.0.1", port=0) as srv:
        srv.start()

        def boom(images):
            raise exc

        srv.batcher.score = boom
        with caplog.at_level("ERROR", logger="mcm_tpu_torch.serve_http"):
            status, body, _ = _request(srv, "POST", "/v1/score",
                                       _jpeg_bytes(np.random.default_rng(5)))
        assert status == 500
        assert json.loads(body) == {"error": "internal error"}
        assert b"secret" not in body and b"unpack" not in body
        assert any(r.exc_info and r.exc_info[1] is exc
                   for r in caplog.records)
        status, body, _ = _request(srv, "GET", "/metrics")
        assert 'endpoint="/v1/score",status="500"} 1' in body.decode()


def test_a_failed_device_batch_reaches_the_client_as_500(detector,
                                                         monkeypatch):
    """A CUDA error in the dispatcher fails the batch's futures; the
    handler answers 500 and the batcher keeps serving."""
    from mcm_tpu_torch.serve_http import OODServer
    real = detector._score_device
    calls = []

    def fail_once(images_device):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("CUDA error: device-side assert triggered")
        return real(images_device)

    monkeypatch.setattr(detector, "_score_device", fail_once)
    data = _jpeg_bytes(np.random.default_rng(6))
    with OODServer(detector, host="127.0.0.1", port=0) as srv:
        srv.start()
        assert _request(srv, "POST", "/v1/score", data)[0] == 500
        assert _request(srv, "POST", "/v1/score", data)[0] == 200
        assert _request(srv, "GET", "/healthz")[0] == 200


def test_closed_batcher_is_a_503_and_healthz_follows(detector):
    from mcm_tpu_torch.serve_http import OODServer
    with OODServer(detector, host="127.0.0.1", port=0) as srv:
        srv.start()
        status, body, _ = _request(srv, "GET", "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        srv.batcher.close()   # as after a dispatcher crash
        status, body, _ = _request(srv, "GET", "/healthz")
        assert status == 503 and json.loads(body)["status"] == "unavailable"
        status, body, _ = _request(srv, "POST", "/v1/score",
                                   _jpeg_bytes(np.random.default_rng(8)))
        assert status == 503
        assert json.loads(body)["error"] == "backend unavailable"
        status, body, _ = _request(srv, "GET", "/metrics")
        assert "mcm_overloaded_total 0" in body.decode()


def test_overload_sheds_with_503(detector):
    from mcm_tpu_torch.serve_http import OODServer
    with OODServer(detector, host="127.0.0.1", port=0,
                   max_pending=0) as srv:
        srv.start()
        data = _jpeg_bytes(np.random.default_rng(5))
        assert _request(srv, "POST", "/v1/score", data)[0] == 503
        assert _request(srv, "POST", "/v1/score?classify=1", data)[0] == 503
        status, body, _ = _request(srv, "GET", "/metrics")
        assert "mcm_overloaded_total 2" in body.decode()


def test_concurrent_clients_coalesce(server):
    from concurrent.futures import ThreadPoolExecutor
    rng = np.random.default_rng(6)
    blobs = [_jpeg_bytes(rng, w=240 + i) for i in range(8)]
    before = server.batcher.n_batches
    with ThreadPoolExecutor(8) as pool:
        results = list(pool.map(
            lambda b: _request(server, "POST", "/v1/score", b), blobs))
    assert all(status == 200 for status, _, _ in results)
    used = server.batcher.n_batches - before
    assert used <= 6, f"barely coalescing: {used} batches for 8 requests"


# -- framing and connection limits ----------------------------------------------

def test_body_size_limit(detector):
    from mcm_tpu_torch.serve_http import OODServer
    with OODServer(detector, host="127.0.0.1", port=0,
                   max_body_bytes=1024) as srv:
        srv.start()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        try:
            conn.request("POST", "/v1/score", body=b"x" * 2048,
                         headers={"Content-Type": "image/jpeg"})
            resp = conn.getresponse()
            assert resp.status == 413
            assert resp.getheader("Connection") == "close"
            resp.read()
        finally:
            conn.close()
        assert _request(srv, "GET", "/healthz")[0] == 200


def test_framing_attacks_are_rejected(server):
    resp = _raw_exchange(server, (
        b"POST /v1/score HTTP/1.1\r\nHost: x\r\n"
        b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n"))
    assert resp.startswith(b"HTTP/1.1 501")
    assert b"connection: close" in resp.lower()
    resp = _raw_exchange(server, (
        b"POST /v1/score HTTP/1.1\r\nHost: x\r\n"
        b"Content-Length: 5\r\nContent-Length: 100\r\n\r\nxxxxx"))
    assert resp.startswith(b"HTTP/1.1 400")
    for bad in (b"1_6", b"+16", b"abc"):
        resp = _raw_exchange(server, (
            b"POST /v1/score HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: " + bad + b"\r\n\r\n"))
        assert resp.startswith(b"HTTP/1.1 400"), bad
    body = b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n"
    resp = _raw_exchange(server, (
        b"POST /nope HTTP/1.1\r\nHost: x\r\n"
        b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body))
    assert resp.startswith(b"HTTP/1.1 404")
    assert resp.lower().count(b"http/1.1 ") == 1, "smuggled request answered"


def test_body_read_deadline(detector):
    from mcm_tpu_torch.serve_http import OODServer
    with OODServer(detector, host="127.0.0.1", port=0) as srv:
        srv.start()
        srv._httpd.RequestHandlerClass.body_deadline_s = 0.5
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=20) as s:
            s.sendall(b"POST /v1/score HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: 10\r\n\r\nab")
            time.sleep(0.9)
            s.sendall(b"c")
            data = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
        assert b"408" in data.split(b"\r\n", 1)[0]


def test_header_trickle_hits_deadline(detector):
    from mcm_tpu_torch.serve_http import OODServer
    with OODServer(detector, host="127.0.0.1", port=0) as srv:
        srv._httpd.RequestHandlerClass.header_deadline_s = 1.0
        srv.start()
        conn = socket.create_connection(("127.0.0.1", srv.port), timeout=15)
        try:
            conn.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n")
            conn.settimeout(15)
            assert conn.recv(1024) == b""
        finally:
            conn.close()


def test_too_many_images_rejected(detector):
    from mcm_tpu_torch.serve_http import OODServer
    tiny = base64.b64encode(
        _jpeg_bytes(np.random.default_rng(3), w=32, h=32)).decode()
    with OODServer(detector, host="127.0.0.1", port=0,
                   max_images_per_request=4) as srv:
        srv.start()
        status, body, _ = _request(
            srv, "POST", "/v1/score",
            json.dumps({"images_b64": [tiny] * 5}).encode(),
            ctype="application/json")
        assert status == 400 and "too many images" in json.loads(body)["error"]
        status, _, _ = _request(
            srv, "POST", "/v1/score",
            json.dumps({"images_b64": [tiny] * 4}).encode(),
            ctype="application/json")
        assert status == 200


def test_connection_cap_sheds_with_raw_503(detector):
    from mcm_tpu_torch.serve_http import OODServer
    with OODServer(detector, host="127.0.0.1", port=0,
                   max_connections=1) as srv:
        srv.start()
        holder = socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=10)
        try:
            deadline = time.monotonic() + 10
            while srv._conn_slots._value != 0:
                assert time.monotonic() < deadline, "slot never acquired"
                time.sleep(0.01)
            status, body, _ = _request(srv, "GET", "/healthz")
            assert status == 503
            assert "too many connections" in json.loads(body)["error"]
        finally:
            holder.close()
        deadline = time.monotonic() + 10
        while srv._conn_slots._value != 1:
            assert time.monotonic() < deadline, "slot never released"
            time.sleep(0.01)
        assert _request(srv, "GET", "/healthz")[0] == 200


def test_unknown_paths_share_one_metrics_label(detector):
    from mcm_tpu_torch.serve_http import OODServer
    with OODServer(detector, host="127.0.0.1", port=0) as srv:
        srv.start()
        for path in ("/scan1", "/scan2", "/x%22injected"):
            assert _request(srv, "GET", path)[0] == 404
        text = _request(srv, "GET", "/metrics")[1].decode()
        assert 'mcm_requests_total{endpoint="other",status="404"} 3' in text
        assert "scan1" not in text and "injected" not in text


def test_bind_failure_and_close_without_start(detector):
    from mcm_tpu_torch.serve_http import OODServer

    def batcher_threads():
        return sum(1 for t in threading.enumerate()
                   if t.name == "mcm-microbatcher")

    with socket.socket() as blocker:
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        before = batcher_threads()
        with pytest.raises(OSError):
            OODServer(detector, host="127.0.0.1",
                      port=blocker.getsockname()[1])
        assert batcher_threads() == before
    srv = OODServer(detector, host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.close, daemon=True)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive(), "close() deadlocked on a never-started server"


def test_metrics_overloaded_counts_only_shed():
    from mcm_tpu_torch.serve_http import ServeMetrics
    m = ServeMetrics()
    m.record("/v1/score", 503)
    assert m.overloaded == 0
    m.record("/v1/score", 503, shed=True)
    m.record("connection", 503, shed=True)
    assert m.overloaded == 2 and m.requests[("/v1/score", 503)] == 2


def test_server_close_answers_in_flight_requests(detector):
    """close() drains: requests the batcher accepted before close are
    answered, not dropped."""
    from mcm_tpu_torch.serve_http import OODServer
    rng = np.random.default_rng(13)
    imgs = rng.integers(0, 256, size=(6, 224, 224, 3), dtype=np.uint8)
    srv = OODServer(detector, host="127.0.0.1", port=0, max_wait_ms=50)
    srv.start()
    futures = [srv.batcher.submit(img) for img in imgs]
    srv.close()
    assert all(np.isfinite(f.result(timeout=60)) for f in futures)
    assert not srv.batcher.alive


# -- CLI --------------------------------------------------------------------------

def test_cli_classnames_file(tmp_path):
    from mcm_tpu_torch.serve_http import _load_class_names
    f = tmp_path / "names.txt"
    f.write_text("alpha\n\nbeta\n  gamma  \n")

    class Args:
        def __init__(self, classnames_file, in_dataset):
            self.classnames_file, self.in_dataset = classnames_file, in_dataset

    assert _load_class_names(Args(str(f), None)) == ["alpha", "beta", "gamma"]
    assert len(_load_class_names(Args(None, "ImageNet10"))) == 10
    with pytest.raises(SystemExit, match="classnames-file"):
        _load_class_names(Args(None, "pet37"))


def test_cli_warms_calibrates_serves_and_drains_on_sigterm(tmp_path):
    """``python -m mcm_tpu_torch.serve_http --device cpu``: calibrates on
    a held-out tree, warms every bucket (the log lines), binds, answers,
    and exits 0 with "shutdown complete" after SIGTERM."""
    import signal

    from util_synth import make_imagefolder_tree
    make_imagefolder_tree(str(tmp_path / "calib"), ["a", "b"], 3)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    names = tmp_path / "names.txt"
    names.write_text("cat\ndog\n")
    env = dict(os.environ, PYTHONPATH=REPO, MCM_TPU_TEST_TINY_B16="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mcm_tpu_torch.serve_http", "--device", "cpu",
         "--classnames-file", str(names), "--allow-random-weights",
         "--host", "127.0.0.1", "--port", str(port), "--batch-buckets",
         "1,4", "--warmup", "all", "--calibrate-dir",
         str(tmp_path / "calib")],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    addr = type("S", (), {"port": port})
    try:
        deadline = time.monotonic() + 120
        health = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                status, body, _ = _request(addr, "GET", "/healthz")
                health = json.loads(body)
                break
            except OSError:
                time.sleep(0.5)
        assert health is not None, "server never came up"
        assert health["status"] == "ok" and health["threshold"] is not None
        status, body, _ = _request(addr, "POST", "/v1/score",
                                   _jpeg_bytes(np.random.default_rng(10)))
        assert status == 200 and "is_id" in json.loads(body)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out[-2000:]
        for line in ("calibrating on 6 held-out ID images",
                     "warmed bucket 1", "warmed bucket 4",
                     "shutdown complete"):
            assert line in out, out[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
