"""Soak the HTTP serving front end on one card: sustained concurrent load
through the whole network stack (HTTP parse → in-memory native JPEG decode
→ MicroBatcher coalescing → device → JSON response).

    python -m mcm_tpu_torch.tools.http_soak [--device cuda|cpu]

The port of ``tools/http_soak.py``, on the port's ``OODDetector`` and
``OODServer`` (CLIP ViT-B/16, random weights from a seed: throughput does
not depend on them; 1000 classes; buckets 1/8/64, warmed before the
listener serves).  ``serve_soak`` measures the in-process batcher; this
adds the deployable layer on top, the number a load balancer sees.

Phases, each after the request shapes were served once:

  decode   the request JPEGs decoded in-process, one at a time natively
           and through PIL, and as one bulk batch on the native pool: the
           host's share of a request
  serial   one client, sequential single-JPEG requests (the floor: every
           request pays a full HTTP + decode + device round trip)
  burst    threads x requests of single JPEGs (the MicroBatcher's case)
  batch    JSON base64 batches of 64 from concurrent clients (the bulk
           client's case)

Prints one JSON line (req/s, p50 / p99 latency and img/s per phase, the
device's name and the decode route) and returns it.  ``--device cuda``
(the default) raises without a card.
"""

from __future__ import annotations

import argparse
import base64
import http.client
import io
import json
import threading
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from mcm_tpu_torch.config import resolve_device
from mcm_tpu_torch.tools.serve_soak import percentiles_ms

BUCKETS = (1, 8, 64)
N_CLASSES = 1000
SERIAL_N = 48
BURST_THREADS = 16
BURST_PER_THREAD = 16
BATCH_CLIENTS = 4
BATCH_SIZE = 64
JPEG_HW = (420, 500)      # the JAX tool's request image


def make_jpegs(n: int, seed: int = 0) -> List[bytes]:
    """``n`` random JPEG request bodies of ``JPEG_HW``."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    blobs = []
    for _ in range(n):
        arr = rng.integers(0, 256, (*JPEG_HW, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr, "RGB").save(buf, "JPEG", quality=88)
        blobs.append(buf.getvalue())
    return blobs


def post(port: int, path: str, body, ctype: str, timeout: float = 1200):
    """One request on its own connection: (reply JSON, seconds)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t = time.perf_counter()
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {data[:200]!r}")
        return json.loads(data), time.perf_counter() - t
    finally:
        conn.close()


def decode_split(blobs: List[bytes], size: int) -> dict:
    """ms an image of the request decode, in-process: native one at a
    time, PIL one at a time, and the bulk native pool."""
    from mcm_tpu_torch.runtime import native
    from mcm_tpu_torch.serve_http import _pil_decode, decode_images_bulk
    out = {}
    if native.native_available():
        t = time.perf_counter()
        for b in blobs:
            native.decode_one_mem(b, size)
        out["native_ms_per_image"] = (time.perf_counter() - t) * 1e3 / len(blobs)
    t = time.perf_counter()
    for b in blobs:
        _pil_decode(b, size)
    out["pil_ms_per_image"] = (time.perf_counter() - t) * 1e3 / len(blobs)
    t = time.perf_counter()
    decode_images_bulk(blobs, size)
    out["bulk_ms_per_image"] = (time.perf_counter() - t) * 1e3 / len(blobs)
    return out


def main(device: str = "cuda") -> dict:
    """Run the soak on ``device``, print its JSON line and return it."""
    from mcm_tpu_torch.runtime.native import native_info
    from mcm_tpu_torch.serve import OODDetector
    from mcm_tpu_torch.serve_http import OODServer

    dev = resolve_device(device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the random-weights warning
        det = OODDetector(class_names=[f"class {i}" for i in range(N_CLASSES)],
                          allow_random_weights=True, batch_sizes=BUCKETS,
                          device=device)
    t0 = time.perf_counter()
    det.warmup()
    warm_s = time.perf_counter() - t0

    blobs = make_jpegs(BURST_THREADS)
    b64 = [base64.b64encode(b).decode() for b in blobs]
    bulk_body = json.dumps({"images_b64": (b64 * BATCH_SIZE)[:BATCH_SIZE]})
    split = decode_split((blobs * BATCH_SIZE)[:BATCH_SIZE], det.image_size)

    with OODServer(det, host="127.0.0.1", port=0, max_wait_ms=5.0) as srv:
        srv.start()
        port = srv.port
        # each content type and request shape once before timing
        post(port, "/v1/score", blobs[0], "image/jpeg")
        post(port, "/v1/score", json.dumps({"images_b64": b64[:8]}),
             "application/json")
        post(port, "/v1/score", bulk_body, "application/json")

        # -- serial floor ----------------------------------------------------
        serial_lat = []
        t0 = time.perf_counter()
        for i in range(SERIAL_N):
            serial_lat.append(post(port, "/v1/score", blobs[i % len(blobs)],
                                   "image/jpeg")[1])
        serial = SERIAL_N / (time.perf_counter() - t0)

        # -- concurrent burst ------------------------------------------------
        n_batches0, n_images0 = srv.batcher.n_batches, srv.batcher.n_images
        burst_lat, errors = [], []
        lock = threading.Lock()

        def client(tid):
            try:
                for _ in range(BURST_PER_THREAD):
                    _, dt = post(port, "/v1/score", blobs[tid % len(blobs)],
                                 "image/jpeg")
                    with lock:
                        burst_lat.append(dt)
            except Exception as e:  # noqa: BLE001 — reported below
                with lock:
                    errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(BURST_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst_s = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f"burst requests failed: {errors[:3]}")
        total = BURST_THREADS * BURST_PER_THREAD
        burst = total / burst_s
        batches = srv.batcher.n_batches - n_batches0
        coalesce = (srv.batcher.n_images - n_images0) / max(1, batches)

        # -- bulk JSON batches -----------------------------------------------
        results, bulk_lat = [], []

        def bulk():
            out, dt = post(port, "/v1/score", bulk_body, "application/json")
            with lock:
                results.append(len(out["scores"]))
                bulk_lat.append(dt)

        threads = [threading.Thread(target=bulk) for _ in range(BATCH_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        bulk_s = time.perf_counter() - t0
        if sum(results) != BATCH_CLIENTS * BATCH_SIZE:
            raise RuntimeError(f"bulk replies held {results} scores")

    row = {"tool": "http_soak",
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "decoder": native_info(), "buckets": list(BUCKETS),
           "classes": N_CLASSES, "warmup_s": warm_s,
           "decode": split,
           "serial_requests": SERIAL_N, "serial_req_per_sec": serial,
           **{f"serial_{k}": v for k, v in percentiles_ms(serial_lat).items()},
           "burst_requests": total, "burst_threads": BURST_THREADS,
           "burst_req_per_sec": burst, "burst_speedup": burst / serial,
           **{f"burst_{k}": v for k, v in percentiles_ms(burst_lat).items()},
           "coalescing_img_per_batch": coalesce,
           "bulk_requests": BATCH_CLIENTS, "bulk_batch": BATCH_SIZE,
           "bulk_json_img_per_sec": sum(results) / bulk_s,
           **{f"bulk_{k}": v for k, v in percentiles_ms(bulk_lat).items()}}
    print(json.dumps(row), flush=True)
    return row


def cli(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (default; raises without a card) or cpu")
    main(parser.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
