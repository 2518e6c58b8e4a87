"""Online-serving soak: the port's ``OODDetector`` end to end on one card.

    python -m mcm_tpu_torch.tools.serve_soak [--device cuda|cpu]

The port of ``tools/serve_soak.py``.  Builds one detector (CLIP ViT-B/16,
random weights from a seed: throughput does not depend on them; 1000
classes; buckets 1/8/64/512), warms every bucket, then:

  buckets       per-bucket request latency, warm (mean of a few requests)
  invariance    a prefix scored in a bigger bucket matches within the bf16
                bucket tolerance, and a wrong image shape is refused
  files         JPEG files scored through ``score_files`` (the native
                decoder in ``DataPipeline``), a threshold calibrated on
                them and the share called ID
  concurrent    a serial per-request baseline, then concurrent single-image
                clients through the ``MicroBatcher``: req/s, p50 / p99
                latency, and the batches the dispatcher ran

Prints one JSON line (the device's name and the decode route in it) and
returns it.  ``--device cuda`` (the default) raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from mcm_tpu_torch.config import resolve_device

BUCKETS = (1, 8, 64, 512)
N_CLASSES = 1000
IMAGE_SIZE = 224
REPS = 3                  # warm requests a bucket
N_FILES = 96
N_SERIAL = 32
N_REQUESTS, N_CLIENTS = 256, 16
BUCKET_ATOL = 5e-3        # the JAX tool's bucket-invariance bound


def write_jpegs(root: str, n: int, seed: int = 0) -> List[str]:
    """``n`` random non-square JPEGs (so the resize and the crop both run)
    under ``root``; returns their paths in order."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        w, h = (int(x) for x in rng.integers(232, 400, size=2))
        arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        p = os.path.join(root, f"{i:05d}.jpg")
        Image.fromarray(arr).save(p, quality=90)
        paths.append(p)
    return paths


def percentiles_ms(latencies_s) -> Dict[str, float]:
    lat = np.asarray(latencies_s, dtype=np.float64) * 1e3
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def main(device: str = "cuda") -> dict:
    """Run the soak on ``device``, print its JSON line and return it."""
    from mcm_tpu_torch.runtime.native import native_info
    from mcm_tpu_torch.serve import MicroBatcher, OODDetector, RequestRefused

    dev = resolve_device(device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the random-weights warning
        det = OODDetector(class_names=[f"class {i}" for i in range(N_CLASSES)],
                          clip_ckpt="ViT-B/16", allow_random_weights=True,
                          batch_sizes=BUCKETS, image_size=IMAGE_SIZE,
                          device=device)
    rng = np.random.default_rng(0)
    s = IMAGE_SIZE
    imgs = rng.integers(0, 256, size=(BUCKETS[-1], s, s, 3), dtype=np.uint8)

    t0 = time.perf_counter()
    det.warmup()
    warmup_s = time.perf_counter() - t0

    # per-bucket request latency, warm (score_images reads the scores back)
    bucket_ms = {}
    for b in BUCKETS:
        t0 = time.perf_counter()
        for _ in range(REPS):
            det.score_images(imgs[:b])
        bucket_ms[b] = (time.perf_counter() - t0) / REPS * 1e3

    # bucket invariance: the same images in another batch shape
    small = BUCKETS[1] if len(BUCKETS) > 1 else BUCKETS[0]
    s_big = det.score_images(imgs)
    s_small = det.score_images(imgs[:small])
    err = float(np.max(np.abs(s_big[:small] - s_small)))
    if err >= BUCKET_ATOL:
        raise RuntimeError(f"bucket mismatch: {err} >= {BUCKET_ATOL}")
    try:
        det.score_images(rng.integers(0, 256, size=(2, s + 32, s + 32, 3),
                                      dtype=np.uint8))
        raise RuntimeError("a wrong image shape was not refused")
    except RequestRefused:
        pass

    # files through the native decode pipeline, then calibration
    with tempfile.TemporaryDirectory(prefix="mcm_serve_soak_") as tree:
        paths = write_jpegs(tree, N_FILES)
        t0 = time.perf_counter()
        fs = det.score_files(paths)
        files_s = time.perf_counter() - t0
    if fs.shape != (N_FILES,) or not np.isfinite(fs).all():
        raise RuntimeError(f"file scores: shape {fs.shape}, finite "
                           f"{np.isfinite(fs).all()}")
    thr = det.calibrate(fs, tpr=0.95)
    frac = float(det.is_id(fs).mean())
    if not 0.90 <= frac <= 1.0:
        raise RuntimeError(f"{frac:.2%} of the calibration set called ID")

    # concurrent single-image clients: MicroBatcher coalescing against the
    # serial per-request floor
    t0 = time.perf_counter()
    for i in range(N_SERIAL):
        det.score_images(imgs[i % len(imgs)])
    serial_rps = N_SERIAL / (time.perf_counter() - t0)

    def request(i):
        t = time.perf_counter()
        score = mb.submit(imgs[i % len(imgs)]).result(timeout=600)
        return score, time.perf_counter() - t

    with MicroBatcher(det, max_wait_ms=5) as mb:
        mb.submit(imgs[0]).result(timeout=600)   # warm the path
        n_batches0, n_images0 = mb.n_batches, mb.n_images
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_CLIENTS) as pool:
            done = list(pool.map(request, range(N_REQUESTS)))
        wall = time.perf_counter() - t0
        batches, images = mb.n_batches - n_batches0, mb.n_images - n_images0
    if not all(np.isfinite(score) for score, _ in done):
        raise RuntimeError("a concurrent request scored non-finite")
    if batches >= images:
        raise RuntimeError(f"no coalescing: {batches} batches for {images} "
                           f"requests")
    row = {"tool": "serve_soak",
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "decoder": native_info(), "buckets": list(BUCKETS),
           "classes": N_CLASSES, "warmup_s": warmup_s,
           "bucket_ms": {str(b): v for b, v in bucket_ms.items()},
           "bucket_img_per_s": {str(b): b / v * 1e3
                                for b, v in bucket_ms.items()},
           "bucket_invariance_max_delta": err,
           "files": N_FILES, "files_s": files_s,
           "files_img_per_s": N_FILES / files_s,
           "calibrated_threshold": thr, "called_id_fraction": frac,
           "serial_req_per_s": serial_rps,
           "concurrent_requests": N_REQUESTS, "clients": N_CLIENTS,
           "concurrent_req_per_s": N_REQUESTS / wall,
           **{f"concurrent_{k}": v for k, v in
              percentiles_ms([t for _, t in done]).items()},
           "batcher_batches": batches, "batcher_images": images,
           "coalescing_img_per_batch": images / batches}
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
