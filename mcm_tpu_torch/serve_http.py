"""HTTP serving front end: a deployable server around :class:`OODDetector`.

:mod:`mcm_tpu_torch.serve` provides the in-process serving primitives (a
long-lived detector with batch buckets, and a :class:`MicroBatcher` that
coalesces concurrent requests into device-sized batches).  This module is
the network shape of the same capability, the JAX package's
``mcm_tpu/serve_http.py`` on the port:

* stdlib-only threaded HTTP server (one thread per connection, which is
  exactly the concurrency shape ``MicroBatcher`` coalesces best);
* request bodies decode in memory through the native libjpeg decoder
  (bulk requests on its GIL-free thread pool), PIL for the rows it
  refuses (non-JPEG formats, quirks) or where the route is unavailable;
  resize shorter side + center crop (the evaluator's transform), under a
  declared-pixels cap against decompression bombs on both routes;
* per-request scores come back through the batcher's futures, so a burst
  of N single-image clients costs ~1 device batch, not N;
* ``/metrics`` exposes Prometheus-style counters (requests, images,
  batches, coalescing ratio, latency quantiles), the detector's replicas
  per device and each card's peak allocated memory;
* ``--n-devices N`` serves on N devices in this one process (a replica on
  each, every bucket split over them); ``--device cuda:K`` puts them all on
  card K.

Endpoints
---------

``POST /v1/score``
    Body either a single image (``Content-Type: image/jpeg`` or any
    non-JSON type — format sniffed by PIL) or a JSON batch
    ``{"images_b64": ["...", ...]}``.  Response JSON:
    ``{"scores": [...], "is_id": [...]}`` (``is_id`` present once a
    threshold is set; scores follow the evaluator's lower = more ID
    convention).  ``?classify=1`` (or ``"classify": true`` in the JSON
    body) additionally returns ``class_index``/``class_name`` — the
    zero-shot prediction from the same similarity logits the OOD score
    reduces, one encoder pass for both.
``GET /healthz``
    Liveness + model identity (the listener only binds after the detector
    finished building — weights loaded, prompts encoded, buckets warmed —
    so reaching it at all implies readiness; 503 once the dispatcher is
    gone).
``GET /metrics``
    Prometheus text format.

Statuses of ``/v1/score``: 400 for an undecodable or malformed request and
for :class:`~mcm_tpu_torch.serve.RequestRefused` (what the detector refuses
of the client's request); 503 for load shedding and for a closed batcher;
500, logged with its traceback and a generic body, for any other exception
out of scoring (a CUDA error included).

Run: ``python -m mcm_tpu_torch.serve_http --in_dataset ImageNet10
--clip_ckpt ViT-B/16 --port 8000 [--device cpu]`` (or
``--classnames-file`` for custom label sets; ``--threshold`` /
``--calibrate-dir`` to enable ``is_id``).
"""

from __future__ import annotations

import argparse
import base64
import binascii
import io
import json
import logging
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from mcm_tpu_torch.runtime import native
from mcm_tpu_torch.serve import (BatcherClosed, MicroBatcher, OODDetector,
                                 Overloaded, RequestRefused)

log = logging.getLogger("mcm_tpu_torch.serve_http")

#: reject absurd request bodies before reading them into memory
MAX_BODY_BYTES = 64 * 1024 * 1024

#: cap on decoded images per request: the decoded batch allocates
#: size²·3 bytes per row (~150 KB at 224) regardless of how small the
#: compressed rows are, so an images_b64 count bound — not just the body
#: byte bound — is what keeps one request from demanding gigabytes
MAX_IMAGES_PER_REQUEST = 1024

#: untrusted image bytes may not declare more pixels than this (PIL's
#: default MAX_IMAGE_PIXELS, the same cap the native decoder enforces:
#: runtime/decoder.cpp's bomb guard); PIL alone would still *decode* up to
#: 2x this (~534 MB RGB) and only warn
MAX_DECODE_PIXELS = 89_478_485


class _BombCapError(ValueError):
    """Our own declared-pixels rejection — the ONE decode error whose
    message is safe (we wrote it) and useful to surface verbatim.  A
    plain ``except ValueError: raise`` would also pass PIL/preprocess-
    internal ValueErrors through with their full text to HTTP clients."""


def _pil_decode(data: bytes, size: int) -> np.ndarray:
    """PIL for bytes the native decoder can't or won't decode (non-JPEG
    formats, quirks, or no native route).  Enforces the same
    declared-pixels bomb cap as the native path: PIL by default decodes up
    to ~178M px with only a warning."""
    try:
        from PIL import Image

        from mcm_tpu_torch.data.transforms import preprocess_uint8
        with Image.open(io.BytesIO(data)) as img:
            w, h = img.size  # header-only; no pixel allocation yet
            if w * h > MAX_DECODE_PIXELS:
                raise _BombCapError(
                    f"image declares {w}x{h} pixels "
                    f"(limit {MAX_DECODE_PIXELS})")
            return preprocess_uint8(img, size)
    except _BombCapError:
        raise
    except Exception as e:  # noqa: BLE001 — surface as a client error
        # type name only: PIL/codec messages can embed local detail the
        # client has no business seeing (full text goes to the debug log)
        log.debug("PIL decode failed: %s: %s", type(e).__name__, e)
        raise ValueError(f"undecodable image ({type(e).__name__})")


def decode_image_bytes(data: bytes, size: int = 224) -> np.ndarray:
    """Request bytes → preprocessed uint8 [size, size, 3] (resize shorter
    side + center crop, the evaluator's transform).  Native decode in
    memory first, PIL for what it refuses.  Raises ValueError if neither
    can decode the bytes."""
    out = native.decode_one_mem(data, size)
    if out is not None:
        return out
    return _pil_decode(data, size)


def decode_images_bulk(datas: Sequence[bytes],
                       size: int = 224) -> Sequence[np.ndarray]:
    """Decode a bulk request on the native thread pool
    (``mcm_decode_mem_batch``), PIL per failed row: the same results as
    mapping :func:`decode_image_bytes`, with the JPEG majority decoded in
    parallel outside the GIL.  Raises ValueError naming the first
    undecodable row."""
    batch, status = native.decode_mem_batch(datas, size)
    images = []
    for i, data in enumerate(datas):
        if batch is not None and status[i] == 0:
            images.append(batch[i])
            continue
        try:
            # a row the native pool refused is not parsed natively again
            images.append(_pil_decode(data, size))
        except ValueError as e:
            raise ValueError(f"images_b64[{i}]: {e}")
    return images


class ServeMetrics:
    """Thread-safe counters + a bounded latency window for /metrics."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self.requests = {}          # (endpoint, status) -> count
        self.images = 0
        self.decode_failures = 0
        self.overloaded = 0
        self._latency = deque(maxlen=window)  # seconds, /v1/score only
        self.started = time.time()

    def record(self, endpoint: str, status: int, images: int = 0,
               latency_s: Optional[float] = None,
               decode_failure: bool = False, shed: bool = False) -> None:
        with self._lock:
            key = (endpoint, status)
            self.requests[key] = self.requests.get(key, 0) + 1
            self.images += images
            if shed:
                # only genuine load shedding: a 503 for "backend
                # unavailable" (device failure, shutdown) is NOT overload
                # — counting it would make a failing idle replica look
                # traffic-saturated to dashboards/autoscalers keyed on
                # mcm_overloaded_total
                self.overloaded += 1
            if decode_failure:
                self.decode_failures += 1
            if latency_s is not None:
                self._latency.append(latency_s)

    def render(self, batcher: Optional[MicroBatcher]) -> str:
        """Prometheus text exposition format."""
        with self._lock:
            lines = [
                "# TYPE mcm_requests_total counter",
            ]
            for (endpoint, status), n in sorted(self.requests.items()):
                lines.append(f'mcm_requests_total{{endpoint="{endpoint}",'
                             f'status="{status}"}} {n}')
            lines += [
                "# TYPE mcm_images_total counter",
                f"mcm_images_total {self.images}",
                "# TYPE mcm_decode_failures_total counter",
                f"mcm_decode_failures_total {self.decode_failures}",
                "# TYPE mcm_overloaded_total counter",
                f"mcm_overloaded_total {self.overloaded}",
                "# TYPE mcm_uptime_seconds gauge",
                f"mcm_uptime_seconds {time.time() - self.started:.1f}",
            ]
            lat = sorted(self._latency)
        if batcher is not None:
            devices = batcher.detector.step.mesh.devices
            cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
            lines.append("# TYPE mcm_replicas gauge")
            lines += [f'mcm_replicas{{device="{d}"}} {devices.count(d)}'
                      for d in dict.fromkeys(devices)]
            if cards:
                lines.append("# TYPE mcm_device_max_memory_allocated_bytes "
                             "gauge")
                lines += [f'mcm_device_max_memory_allocated_bytes{{device='
                          f'"{d}"}} {torch.cuda.max_memory_allocated(d)}'
                          for d in cards]
            lines += [
                "# TYPE mcm_device_batches_total counter",
                f"mcm_device_batches_total {batcher.n_batches}",
                "# TYPE mcm_device_images_total counter",
                f"mcm_device_images_total {batcher.n_images}",
                "# TYPE mcm_coalescing_ratio gauge",
                f"mcm_coalescing_ratio "
                f"{batcher.n_images / max(1, batcher.n_batches):.3f}",
            ]
        if lat:
            def q(p: float) -> float:
                return lat[min(len(lat) - 1, int(p * len(lat)))]
            lines += [
                "# TYPE mcm_score_latency_seconds summary",
                f'mcm_score_latency_seconds{{quantile="0.5"}} {q(0.5):.6f}',
                f'mcm_score_latency_seconds{{quantile="0.99"}} {q(0.99):.6f}',
                f"mcm_score_latency_seconds_count {len(lat)}",
                f"mcm_score_latency_seconds_sum {sum(lat):.6f}",
            ]
        return "\n".join(lines) + "\n"


class OODServer:
    """Own one detector + batcher + HTTP listener.

    ``port=0`` binds an ephemeral port (tests); read it back from
    ``server.port``.  Use as a context manager, or ``start()`` /
    ``close()`` explicitly.  ``serve_forever()`` blocks (the CLI shape).
    """

    def __init__(self, detector: OODDetector, host: str = "0.0.0.0",
                 port: int = 8000, max_wait_ms: float = 5.0,
                 max_pending: Optional[int] = 4096,
                 max_body_bytes: int = MAX_BODY_BYTES,
                 max_images_per_request: int = MAX_IMAGES_PER_REQUEST,
                 max_connections: int = 64):
        self.detector = detector
        # concurrent-connection cap: ThreadingHTTPServer spawns one
        # thread per accepted connection with NO limit
        # (request_queue_size only bounds the accept backlog), so without
        # this the per-request 64 MB body cap multiplies by an unbounded
        # connection count — N malicious connections × max_body_bytes
        # buffered bodies = OOM.  Excess
        # connections get an immediate raw 503 without reading a byte.
        self._conn_slots = threading.BoundedSemaphore(max_connections)
        # classify requests bypass the batcher, but they shed against the
        # same max_pending budget — this counts their in-flight images.
        # The extra_load hook reads the int WITHOUT _classify_lock
        # (GIL-atomic): it runs under the batcher's own lock, and taking
        # _classify_lock there would invert the handler's
        # batcher.pending → _classify_lock order into a deadlock.
        self._classify_inflight = 0
        self._classify_lock = threading.Lock()
        self.batcher = MicroBatcher(detector, max_wait_ms=max_wait_ms,
                                    max_pending=max_pending,
                                    extra_load=lambda: self._classify_inflight)
        self.metrics = ServeMetrics()
        self.max_body_bytes = max_body_bytes
        self.max_images_per_request = max_images_per_request
        handler = _make_handler(self)
        try:
            self._httpd = ThreadingHTTPServer((host, port), handler)
        except Exception:
            # bind failed (e.g. EADDRINUSE) — don't leak the dispatcher
            # thread the MicroBatcher already started
            self.batcher.close()
            raise
        # NON-daemon handler threads: server_close() only joins non-daemon
        # threads (socketserver._Threads skips daemons), and the drain
        # contract needs in-flight handlers finished before the batcher
        # closes.  Handler.timeout bounds how long a wedged/idle
        # connection can hold its thread (and thus the drain).
        self._httpd.daemon_threads = False
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._started = False
        self._close_lock = threading.Lock()
        self._close_done = threading.Event()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "OODServer":
        """Serve in a background thread (tests / embedding)."""
        self._started = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="mcm-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve on the calling thread until interrupted (the CLI shape)."""
        self._started = True
        try:
            self._httpd.serve_forever()
        finally:
            self.close()

    def close(self) -> None:
        """Stop accepting, then drain in-flight requests (idempotent;
        callable from any thread, including a signal-spawned one while
        ``serve_forever`` blocks the main thread)."""
        with self._close_lock:
            if self._closed:
                # someone else is (or finished) closing — wait so no
                # caller returns while the drain is still in progress
                # (e.g. main exiting serve_forever while the
                # signal-spawned closer is mid-drain)
                self._close_done.wait()
                return
            self._closed = True
        try:
            if self._started:
                # shutdown() waits on an event only serve_forever() sets;
                # on a constructed-but-never-served instance (context-
                # manager body raised before start()) it would deadlock
                # forever — server_close()
                # alone releases the socket in that case
                self._httpd.shutdown()
            self._httpd.server_close()
            if self._thread is not None:
                self._thread.join()
            self.batcher.close()
        finally:
            self._close_done.set()

    def __enter__(self) -> "OODServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _HeaderDeadlineFile:
    """rfile proxy enforcing a wall-clock deadline across the request-line
    + header phase.  The per-recv idle timeout resets on every byte, so a
    client trickling one header byte every ~25 s could hold a (non-daemon)
    handler thread for days — and with it a SIGTERM'd replica's graceful
    drain (``_read_body`` already bounds the BODY
    phase the same way).  Armed per request by ``handle_one_request``,
    disarmed once headers are parsed; pass-through while disarmed so
    ``_read_body``'s own timeout management is untouched."""

    def __init__(self, raw, conn, idle_timeout: float):
        self._raw, self._conn, self._idle = raw, conn, idle_timeout
        self.deadline: Optional[float] = None

    def _arm_socket(self) -> None:
        if self.deadline is None:
            return
        budget = self.deadline - time.monotonic()
        if budget <= 0:
            # handle_one_request catches TimeoutError and closes
            raise TimeoutError("request header read deadline exceeded")
        self._conn.settimeout(min(self._idle, budget))

    def readline(self, limit: int = -1) -> bytes:
        self._arm_socket()
        return self._raw.readline(limit)

    def read(self, n: int = -1) -> bytes:
        self._arm_socket()
        return self._raw.read(n)

    def __getattr__(self, name):
        return getattr(self._raw, name)


def _make_handler(server: OODServer):
    detector = server.detector
    batcher = server.batcher
    metrics = server.metrics

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: clients reuse connections between requests
        protocol_version = "HTTP/1.1"
        # socket timeout: a client that stalls mid-body (or parks an idle
        # keep-alive connection) must release its handler thread — both
        # for slowloris resistance and so close()'s join terminates.
        # NOTE this is a per-recv idle timeout; a byte-trickling client
        # resets it on every byte, so _read_body additionally enforces a
        # whole-body deadline below.
        timeout = 30.0
        # hard wall-clock bound on receiving one request body: bounds how
        # long a slowloris-style trickler can pin a handler thread (and
        # thus how long a graceful drain can hang on one connection)
        body_deadline_s = 120.0
        # same bound for the request-line + header phase (enforced by the
        # _HeaderDeadlineFile rfile proxy; generous for any legitimate
        # client — headers fit one packet)
        header_deadline_s = 30.0

        def log_message(self, fmt, *args):  # noqa: N802 — stdlib name
            log.debug("%s %s", self.address_string(), fmt % args)

        # -- connection lifecycle -----------------------------------------

        def handle(self):  # noqa: A003 — stdlib name
            # connection cap: past max_connections, reply a raw 503 and
            # close WITHOUT reading anything — the whole point is not to
            # buffer the excess connection's body
            if not server._conn_slots.acquire(blocking=False):
                metrics.record("connection", 503, shed=True)
                body = b'{"error": "too many connections"}'
                try:
                    self.wfile.write(
                        b"HTTP/1.1 503 Service Unavailable\r\n"
                        b"Content-Type: application/json\r\n"
                        b"Content-Length: " + str(len(body)).encode()
                        + b"\r\nConnection: close\r\n\r\n" + body)
                except OSError:
                    pass
                return
            try:
                super().handle()
            finally:
                server._conn_slots.release()

        def setup(self):
            super().setup()
            # every header-phase read goes through the deadline proxy;
            # body reads pass through once parse_request disarms it
            self.rfile = _HeaderDeadlineFile(self.rfile, self.connection,
                                             self.timeout)

        def handle_one_request(self):
            # arm per request (keep-alive connections parse many)
            self.rfile.deadline = (time.monotonic()
                                   + self.header_deadline_s)
            try:
                super().handle_one_request()
            finally:
                self.rfile.deadline = None
                try:
                    # restore the per-recv idle timeout for the next
                    # keep-alive request on this connection
                    self.connection.settimeout(self.timeout)
                except OSError:
                    pass

        def parse_request(self):
            ok = super().parse_request()
            # headers are in; _read_body manages its own deadline
            self.rfile.deadline = None
            return ok

        # -- plumbing -----------------------------------------------------

        def _reply(self, status: int, payload, endpoint: str,
                   images: int = 0, latency_s: Optional[float] = None,
                   decode_failure: bool = False, shed: bool = False,
                   content_type: str = "application/json") -> None:
            body = (payload if isinstance(payload, bytes)
                    else json.dumps(payload).encode())
            # record BEFORE writing: the moment the body hits the wire a
            # client can issue a follow-up /metrics that must already see
            # this request counted
            metrics.record(endpoint, status, images=images,
                           latency_s=latency_s,
                           decode_failure=decode_failure, shed=shed)
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                # tell the client (keep-alive protocol-wise) the server
                # is dropping this connection, e.g. after an unread
                # oversized body
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def _reject(self, status: int, msg: str,
                    endpoint: str = "/v1/score") -> None:
            # every framing rejection drops the connection: the unread
            # (or unreadable) body would otherwise be parsed as the next
            # request on this keep-alive connection (request smuggling /
            # connection desync)
            self.close_connection = True
            self._reply(status, {"error": msg}, endpoint)

        def _read_body(self) -> Optional[bytes]:
            # http.server has no chunked-transfer support; per RFC 7230
            # an unimplemented transfer coding must be rejected and the
            # connection closed — silently framing by Content-Length
            # would desync the connection into smuggled requests
            if self.headers.get("Transfer-Encoding"):
                self._reject(501, "Transfer-Encoding not supported")
                return None
            cls = self.headers.get_all("Content-Length") or ["0"]
            # RFC 7230 3.3.2: differing duplicate Content-Lengths are a
            # framing attack (front proxy and this server would frame the
            # stream differently) — reject rather than pick one
            if len({c.strip() for c in cls}) > 1:
                self._reject(400, "conflicting Content-Length headers")
                return None
            cl = cls[0].strip()
            # strict digits-only: Python int() also accepts '+16', '1_6'
            # and unicode digits, which an intermediary may frame
            # differently than this server
            if not (cl.isascii() and cl.isdigit()):
                self._reject(400, "malformed Content-Length")
                return None
            n = int(cl)
            if n > server.max_body_bytes:
                self._reject(413, f"body must be <= "
                                  f"{server.max_body_bytes} bytes")
                return None
            # chunked reads under a whole-body deadline: rfile.read(n) in
            # one call would reset the 30 s idle timeout on every recv,
            # letting a byte-trickler hold this thread (and block drain)
            # indefinitely
            deadline = time.monotonic() + self.body_deadline_s
            chunks, remaining = [], n
            try:
                while remaining:
                    budget = deadline - time.monotonic()
                    if budget <= 0:
                        self._reject(408, "request body read timed out")
                        return None
                    self.connection.settimeout(min(self.timeout, budget))
                    try:
                        chunk = self.rfile.read(min(remaining, 1 << 20))
                    except TimeoutError:
                        self._reject(408, "request body read timed out")
                        return None
                    except OSError:
                        # connection reset / broken pipe mid-body: drop the
                        # connection quietly instead of letting the handler
                        # raise (ThreadingHTTPServer would log a full
                        # traceback per dropped client)
                        self.close_connection = True
                        return None
                    if not chunk:  # client closed mid-body
                        self.close_connection = True
                        return None
                    chunks.append(chunk)
                    remaining -= len(chunk)
            finally:
                self.connection.settimeout(self.timeout)
            return b"".join(chunks)

        # -- endpoints ----------------------------------------------------

        def do_GET(self):  # noqa: N802 — stdlib name
            if (self.headers.get("Transfer-Encoding")
                    or self.headers.get("Content-Length", "0").strip()
                    not in ("", "0")):
                # a GET carrying a body would leave unread bytes to be
                # parsed as the next request — close instead of desyncing
                self.close_connection = True
            if self.path == "/healthz":
                # liveness must track the dispatcher, not build-time
                # state: after the MicroBatcher closes (shutdown drain or
                # a dispatcher crash) every score request gets 503, and a
                # load balancer probing /healthz must see that too or the
                # dead replica stays in rotation
                alive = batcher.alive
                self._reply(200 if alive else 503, {
                    "status": "ok" if alive else "unavailable",
                    "model": detector.cfg.clip_ckpt,
                    "score": detector.cfg.score,
                    "image_size": detector.image_size,
                    "batch_buckets": list(detector.batch_sizes),
                    "threshold": detector.threshold,
                }, "/healthz")
            elif self.path == "/metrics":
                self._reply(200, metrics.render(batcher).encode(),
                            "/metrics",
                            content_type="text/plain; version=0.0.4")
            else:
                # fixed label: raw client paths would give the requests
                # counter unbounded cardinality and allow Prometheus
                # label injection via quotes in the path
                self._reply(404, {"error": f"no such path {self.path}"},
                            "other")

        def do_POST(self):  # noqa: N802 — stdlib name
            path, _, query = self.path.partition("?")
            if path != "/v1/score":
                # the unread POST body would desync this keep-alive
                # connection into smuggled requests — close it
                self._reject(404, f"no such path {self.path}", "other")
                return
            body = self._read_body()
            if body is None:
                return
            if batcher.max_pending is not None:
                # cheap pre-decode shed: decoding a shed-bound request
                # first would pay its full CPU+memory cost anyway (the
                # authoritative all-or-nothing check still runs at
                # submit time below)
                if batcher.pending + server._classify_inflight \
                        > batcher.max_pending:
                    self._reply(503, {"error": "overloaded"}, "/v1/score",
                                shed=True)
                    return
            t0 = time.monotonic()
            classify = "classify=1" in query.split("&")
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            try:
                if ctype == "application/json":
                    images, classify = self._decode_json_batch(body,
                                                               classify)
                else:
                    images = [decode_image_bytes(body, detector.image_size)]
            except ValueError as e:
                self._reply(400, {"error": str(e)}, "/v1/score",
                            decode_failure=True)
                return
            if not images:
                self._reply(400, {"error": "no images in request"},
                            "/v1/score")
                return
            out = {}
            try:
                if classify:
                    # joint zero-shot classification + OOD score: one
                    # device feature pass, host logits (detector path —
                    # classification requests are batch-shaped already,
                    # so they skip the single-image coalescer).  They
                    # still shed against the SAME max_pending budget the
                    # batcher enforces, or unbounded handler threads
                    # could dispatch unbounded device work.
                    if batcher.max_pending is not None:
                        # read batcher.pending OUTSIDE _classify_lock:
                        # it takes the batcher lock, whose holder may
                        # call our extra_load hook
                        batcher_load = batcher.pending
                        with server._classify_lock:
                            load = (batcher_load
                                    + server._classify_inflight)
                            if load + len(images) > batcher.max_pending:
                                raise Overloaded(
                                    f"{load} requests already pending "
                                    f"(max_pending={batcher.max_pending})")
                            server._classify_inflight += len(images)
                    try:
                        idx, s = detector.classify_images(np.stack(images))
                    finally:
                        if batcher.max_pending is not None:
                            with server._classify_lock:
                                server._classify_inflight -= len(images)
                    scores = [float(x) for x in s]
                    out["class_index"] = [int(i) for i in idx]
                    out["class_name"] = [detector.class_names[i]
                                         for i in idx]
                else:
                    # batcher.score, not a submit loop: on Overloaded
                    # partway through a batch it awaits the already-
                    # consumed prefix before re-raising — a bare loop
                    # would orphan those futures while the device still
                    # scores them
                    scores = [float(x)
                              for x in batcher.score(np.stack(images))]
            except Overloaded as e:
                self._reply(503, {"error": str(e)}, "/v1/score", shed=True)
                return
            except RequestRefused as e:
                # what the detector refuses of the CLIENT's request (e.g.
                # ?classify=1 on a score family without a host-from-logits
                # form): the client's 400, with the detector's message
                self._reply(400, {"error": str(e)}, "/v1/score")
                return
            except BatcherClosed:
                # shutdown drain or a dead dispatcher: the replica is gone
                self._reply(503, {"error": "backend unavailable"},
                            "/v1/score")
                return
            except Exception:  # noqa: BLE001 — the server's fault: a CUDA
                # error, or a defect of the detector or the step.  Logged
                # with its traceback; its message may embed host paths and
                # backend internals, so the client body stays generic.
                log.exception("score request failed")
                self._reply(500, {"error": "internal error"}, "/v1/score")
                return
            out["scores"] = scores
            if detector.threshold is not None:
                out["threshold"] = detector.threshold
                out["is_id"] = [s <= detector.threshold for s in scores]
            self._reply(200, out, "/v1/score", images=len(scores),
                        latency_s=time.monotonic() - t0)

        def _decode_json_batch(self, body: bytes, classify: bool):
            try:
                payload = json.loads(body)
            except json.JSONDecodeError as e:
                raise ValueError(f"bad JSON: {e}")
            if (not isinstance(payload, dict)
                    or not isinstance(payload.get("images_b64"), list)):
                raise ValueError('JSON body must be {"images_b64": [...]}')
            if len(payload["images_b64"]) > server.max_images_per_request:
                # the decoded batch costs size²·3 bytes/row no matter how
                # small the compressed rows are — a body-byte cap alone
                # would let ~300k tiny rows demand ~45 GB
                raise ValueError(
                    f"too many images ({len(payload['images_b64'])} > "
                    f"{server.max_images_per_request})")
            raws = []
            for i, b64 in enumerate(payload["images_b64"]):
                try:
                    raws.append(base64.b64decode(b64, validate=True))
                except (binascii.Error, TypeError):
                    raise ValueError(f"images_b64[{i}] is not valid base64")
            images = decode_images_bulk(raws, detector.image_size)
            return images, bool(payload.get("classify", classify))

    return Handler


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _load_class_names(args) -> Sequence[str]:
    if args.classnames_file:
        with open(args.classnames_file) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        if not names:
            raise SystemExit(f"{args.classnames_file} contains no names")
        return names
    from mcm_tpu_torch.data.labels import get_test_labels
    try:
        return list(get_test_labels(args.in_dataset))
    except ValueError as e:
        raise SystemExit(
            f"{e}; fine-grained datasets derive names from their metadata "
            f"files — pass --classnames-file instead")


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(
        description="Serve zero-shot OOD detection over HTTP (PyTorch/CUDA)")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--in_dataset", help="ID dataset whose class list to "
                   "serve (ImageNet/ImageNet10/20/100)")
    g.add_argument("--classnames-file", help="file with one class name "
                   "per line (custom label sets)")
    p.add_argument("--clip_ckpt", default="ViT-B/16")
    p.add_argument("--score", default="MCM",
                   choices=["MCM", "energy", "max-logit", "entropy", "var"])
    p.add_argument("--T", type=float, default=1.0)
    p.add_argument("--ckpt-dir", default=None,
                   help="converted checkpoint dir (MCM_TPU_CKPT_DIR also "
                        "honored)")
    p.add_argument("--template_ensemble", action="store_true")
    p.add_argument("--allow-random-weights", action="store_true",
                   help="smoke-test without a checkpoint (scores are "
                        "meaningless)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-buckets", default="1,8,64,512",
                   help="comma-separated batch bucket sizes")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="microbatch coalescing window")
    p.add_argument("--max-pending", type=int, default=4096,
                   help="load-shed bound on queued requests")
    p.add_argument("--max-connections", type=int, default=64,
                   help="concurrent-connection cap (bounds aggregate "
                        "request-body memory at max-connections × 64 MB "
                        "worst case); excess connections get an "
                        "immediate 503")
    p.add_argument("--max-batch-images", type=int,
                   default=MAX_IMAGES_PER_REQUEST,
                   help="cap on images_b64 rows per JSON request (each "
                        "decoded row costs ~150 KB regardless of its "
                        "compressed size)")
    p.add_argument("--threshold", type=float, default=None,
                   help="ID/OOD decision threshold (enables is_id)")
    p.add_argument("--calibrate-dir", default=None,
                   help="directory tree of held-out ID images; scored at "
                        "startup to set the threshold at --calibrate-tpr")
    p.add_argument("--calibrate-tpr", type=float, default=0.95)
    p.add_argument("--maha-templates", default=None,
                   help="Mahalanobis template cache (npz from the "
                        "evaluator's --template_dir, or the reference's "
                        "*_classwise_mean_*.pt)")
    p.add_argument("--n-devices", type=int, default=1,
                   help="serving devices (0 = all visible): a model "
                        "replica on each, every batch bucket split over "
                        "them (each bucket must divide by the count)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor-parallel span; only 1 is ported")
    p.add_argument("--warmup", default="score",
                   choices=["none", "score", "all"],
                   help="run every batch bucket BEFORE binding the port "
                        "(kernel builds, cuBLAS, allocator), so a "
                        "reachable /healthz means ready ('all' also warms "
                        "the classify/features path; 'none' starts fast "
                        "but the first request per bucket pays the "
                        "first use)")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (cards 0 … n-1), cuda:K (every replica on "
                        "card K) or cpu (only when asked for)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    class_names = _load_class_names(args)
    log.info("building detector: %s, %d classes, score=%s",
             args.clip_ckpt, len(class_names), args.score)
    detector = OODDetector(
        class_names=class_names, clip_ckpt=args.clip_ckpt,
        score=args.score, T=args.T, ckpt_dir=args.ckpt_dir,
        template_ensemble=args.template_ensemble,
        allow_random_weights=args.allow_random_weights,
        batch_sizes=tuple(int(b) for b in args.batch_buckets.split(",")),
        n_devices=args.n_devices or None,
        model_parallel=args.model_parallel, device=args.device)
    if args.maha_templates:
        detector.load_maha_templates(args.maha_templates)
    if args.threshold is not None:
        detector.threshold = args.threshold
    elif args.calibrate_dir:
        import glob
        import os
        paths = sorted(
            p for p in glob.glob(os.path.join(args.calibrate_dir, "**", "*"),
                                 recursive=True) if os.path.isfile(p))
        if not paths:
            raise SystemExit(f"--calibrate-dir {args.calibrate_dir} holds "
                             f"no files")
        log.info("calibrating on %d held-out ID images", len(paths))
        thr = detector.calibrate(detector.score_files(paths),
                                 tpr=args.calibrate_tpr)
        log.info("threshold @ TPR %.2f = %.6f", args.calibrate_tpr, thr)

    if args.warmup != "none":
        log.info("warming %d bucket(s) before binding (%s)",
                 len(detector.batch_sizes), args.warmup)
        detector.warmup(include_features=args.warmup == "all",
                        log=lambda m: log.info("%s", m))

    server = OODServer(detector, host=args.host, port=args.port,
                       max_wait_ms=args.max_wait_ms,
                       max_pending=args.max_pending,
                       max_images_per_request=args.max_batch_images,
                       max_connections=args.max_connections)

    # graceful drain: stop accepting, finish in-flight requests, then
    # exit — a SIGTERM'd replica must not drop scores it already owes.
    # close() runs on a helper thread because the signal handler executes
    # on the main thread, which is blocked inside serve_forever (shutdown
    # from the same thread would deadlock).
    import signal

    def _graceful(signum, frame):
        log.info("signal %d: draining and shutting down", signum)
        threading.Thread(target=server.close, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    log.info("serving on %s:%d (buckets %s, devices %s)", args.host,
             server.port, detector.batch_sizes,
             ", ".join(str(d) for d in detector.step.mesh.devices))
    server.serve_forever()
    log.info("shutdown complete")


if __name__ == "__main__":
    main()
