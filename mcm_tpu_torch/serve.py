"""Online-serving API: build an OOD detector once, score images on demand.

The batch evaluator walks whole datasets (reference
``eval_ood_detection.py:53-99``); a deployment also needs the *online*
shape of the same capability: one long-lived object holding the model on
the card, the cached class-prompt embeddings and a calibrated ID/OOD
threshold, scoring request-sized batches.  The JAX package's
``mcm_tpu/serve.py``, on one CUDA device:

* requests are padded up to a small ladder of batch shapes (default
  1/8/64/512), so the card sees at most that many shapes (cuBLAS picks its
  algorithms per shape, and every bucket is warmed before traffic);
* text prompts are encoded exactly once at build time;
* thresholds come from :meth:`OODDetector.calibrate` over held-out ID
  scores at a target TPR (the online analogue of the evaluator's FPR@95,
  same "lower score = more in-distribution" convention,
  ``detection_util.py:247-249``);
* :class:`MicroBatcher` coalesces concurrent single-image requests into
  one padded batch on a dispatcher thread;
* ``n_devices`` > 1 serves on a single-process mesh of local devices (JAX's
  ``n_devices``): a model replica on each device, every padded batch split
  into one stripe per device, all stripes launched before any is read, and
  the scores joined back in row order
  (:func:`~mcm_tpu_torch.parallel.eval_step.to_host`).

Requests the detector refuses (images of the wrong shape, a score family
``classify_images`` cannot reproduce) raise :class:`RequestRefused`, the
one error type of scoring that the HTTP front end answers with 400.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Optional, Sequence, Tuple

import numpy as np

from mcm_tpu_torch.config import resolve_device
from mcm_tpu_torch.parallel.eval_step import to_host as _to_host
from mcm_tpu_torch.parallel.mesh import make_local_mesh
from mcm_tpu_torch.runner import (RunConfig, _StreamReadback, _encode_prompts,
                                  build_model_and_step)


class RequestRefused(ValueError):
    """A request the detector refuses because of what the CLIENT sent
    (images of the wrong shape, a classification this detector's score
    family has no form for).  The HTTP front end maps this type, and
    no other, to 400: any other exception out of scoring is the server's
    fault."""


class OODDetector:
    """Long-lived zero-shot OOD detector bound to one CLIP checkpoint.

    >>> det = OODDetector(class_names=["cat", "dog"], score="MCM",
    ...                   allow_random_weights=True)  # smoke
    >>> scores = det.score_images(batch_u8)           # [N] lower = more ID
    >>> det.calibrate(id_scores, tpr=0.95)
    >>> det.is_id(scores)                             # [N] bool

    ``device`` (default ``cuda``, which raises without a card) and
    ``n_devices`` (0 or None: every visible device) make the mesh
    (:func:`~mcm_tpu_torch.parallel.mesh.make_local_mesh`): ``cuda`` is cards
    ``0 … n-1``, ``cuda:K`` puts every replica on card K, ``cpu`` on the
    CPU.  Every bucket must divide by ``n_devices``.  ``model_parallel > 1``
    raises ``NotImplementedError`` naming ``ROADMAP.md`` Queue 1, item 9b,
    and so does a detector built inside a process group of several ranks
    (``ValueError``): serving is one process.
    """

    def __init__(self, class_names: Sequence[str], clip_ckpt: str = "ViT-B/16",
                 score: str = "MCM", T: float = 1.0,
                 precision: str = "fast", ckpt_dir: Optional[str] = None,
                 template_ensemble: bool = False,
                 allow_random_weights: bool = False,
                 noise_magnitude: float = 0.0014,
                 batch_sizes: Sequence[int] = (1, 8, 64, 512),
                 image_size: int = 224, n_devices: Optional[int] = 1,
                 model_parallel: int = 1, device: str = "cuda"):
        if score == "maha":
            raise ValueError(
                "for maha, build with score='MCM' and call "
                "load_maha_templates(<templates npz from the batch "
                "evaluator's --template_dir>) — scoring then uses the "
                "Mahalanobis path")
        resolve_device(device)   # no card and no device="cpu": fail first
        mesh = make_local_mesh(n_devices, model_parallel, device=device)
        cfg = RunConfig(clip_ckpt=clip_ckpt, score=score, T=T,
                        precision=precision, ckpt_dir=ckpt_dir,
                        template_ensemble=template_ensemble,
                        allow_random_weights=allow_random_weights,
                        noise_magnitude=noise_magnitude,
                        image_size=image_size, n_devices=mesh.data,
                        model_parallel=model_parallel, device=device)
        self.cfg = cfg
        self.image_size = image_size
        self.batch_sizes = tuple(sorted(batch_sizes))
        if not self.batch_sizes:
            raise ValueError("batch_sizes must be non-empty")
        if self.batch_sizes[0] < 1:
            # a 0 bucket would only fail at request time, inside the
            # dispatcher — fail at construction instead
            raise ValueError(f"batch_sizes must be positive, got "
                             f"{self.batch_sizes}")
        bad = [b for b in self.batch_sizes if b % mesh.data]
        if bad:
            # each bucket is split into one equal stripe per device
            raise ValueError(f"batch_sizes {bad} not divisible by the "
                             f"data-parallel mesh size {mesh.data}")
        self.params, tokenizer, self.step = build_model_and_step(cfg,
                                                                 mesh=mesh)
        self.class_names = list(class_names)
        self.text_feats = _encode_prompts(self.step, self.params, tokenizer,
                                          self.class_names,
                                          cfg.template_ensemble)
        self.threshold: Optional[float] = None
        self._maha = None  # (mean, precision, normalize) once loaded
        self._text_host = None  # lazy host copy for classify

    def load_maha_templates(self, path: str,
                            normalize: Optional[bool] = None) -> None:
        """Switch scoring to Mahalanobis using class means + precision
        estimated offline by the batch evaluator (``--score maha
        --generate``, saved under ``--template_dir``).

        Whether the templates were estimated over L2-normalized features
        (the evaluator's ``--normalize``) is read from the npz itself;
        scoring with the wrong flag is silent corruption, so a mismatching
        explicit ``normalize=`` raises.  Templates fingerprinted with other
        weights than this detector's are refused too.

        Also accepts the reference's torch template format
        (``detection_util.py:175-176``): pass the ``*_classwise_mean_*.pt``
        path and the sibling ``*_precision_*.pt`` is derived from it; the
        normalize flag is parsed from the ``_{True|False}.pt`` suffix.

        Calling it on a live detector is safe per request: every public
        entry point snapshots the scoring family once at entry."""
        if path.endswith(".pt"):
            from mcm_tpu_torch.scores.mahalanobis import load_pt_templates
            if "classwise_mean" not in os.path.basename(path):
                raise ValueError(
                    f"expected the reference's *_classwise_mean_*.pt "
                    f"template path, got {path}")
            # derive the sibling from the FILENAME only: a directory
            # named "classwise_mean" must not be rewritten
            prec_path = os.path.join(
                os.path.dirname(path),
                os.path.basename(path).replace("classwise_mean",
                                               "precision"))
            mu, prec = load_pt_templates(path, prec_path)
            stem = os.path.basename(path)[:-len(".pt")]
            stored = (True if stem.endswith("_True") else
                      False if stem.endswith("_False") else None)
            data = {"classwise_mean": mu, "precision": prec}
        else:
            with np.load(path) as z:
                data = {k: z[k] for k in z.files}
            stored = (bool(data["normalize"]) if "normalize" in data
                      else None)
            if "weight_sig" in data:
                import json

                from mcm_tpu_torch.runner import _weight_identity
                ident = _weight_identity(self.cfg).get("weights") or {}
                if "sha256_sampled" in ident:
                    sig = {"size": ident["size"],
                           "sha": ident["sha256_sampled"]}
                    tmpl = json.loads(str(data["weight_sig"]))
                    if tmpl != sig:
                        raise ValueError(
                            f"templates at {path} were estimated from "
                            f"different weights than this detector "
                            f"resolves (template size/sha {tmpl} vs "
                            f"detector {sig}); regenerate them with the "
                            f"batch evaluator (--score maha --generate)")
        if normalize is None:
            if stored is None:
                raise ValueError(
                    f"{path} records no 'normalize' flag; pass normalize= "
                    f"matching the evaluator's --normalize setting "
                    f"explicitly")
            normalize = stored
        elif stored is not None and normalize != stored:
            raise ValueError(
                f"normalize={normalize} contradicts the templates at "
                f"{path}, which were estimated with normalize={stored}")
        self._maha = (self.step.put_replicated(data["classwise_mean"]),
                      self.step.put_replicated(data["precision"]),
                      normalize)

    # -- scoring ---------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def _pad_to_bucket(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """Stack ≤ biggest-bucket images into a fresh zero-padded array of
        the smallest bucket shape (one assembly path for the offline
        chunker and the MicroBatcher)."""
        b = self._bucket(len(images))
        s = self.image_size
        batch = np.zeros((b, s, s, 3), np.uint8)
        for i, img in enumerate(images):
            batch[i] = img
        return batch

    def _validate_images(self, images_u8, caller: str) -> np.ndarray:
        images_u8 = np.asarray(images_u8)
        if images_u8.dtype != np.uint8:
            raise TypeError(
                f"{caller} expects uint8 pixels in [0, 255] (got "
                f"{images_u8.dtype}); normalization happens on the device — "
                f"scale float inputs by 255 and cast explicitly")
        if images_u8.ndim == 3:
            images_u8 = images_u8[None]
        s = self.image_size
        if images_u8.shape[1:] != (s, s, 3):
            raise RequestRefused(
                f"expected [N, {s}, {s}, 3] preprocessed uint8 images "
                f"(detector built with image_size={s}), got "
                f"{images_u8.shape}; decode+resize via score_files or "
                f"mcm_tpu_torch.data.DataPipeline first")
        return images_u8

    def score_images(self, images_u8: np.ndarray) -> np.ndarray:
        """[N, S, S, 3] uint8 (preprocessed) → [N] fp32 scores
        (lower = more in-distribution, the evaluator's convention)."""
        images_u8 = self._validate_images(images_u8, "score_images")
        maha = self._maha   # one scoring family for the WHOLE request
        n = images_u8.shape[0]
        out = np.empty((n,), np.float32)
        done = 0
        while done < n:
            chunk = min(n - done, self.batch_sizes[-1])
            batch = self._pad_to_bucket(images_u8[done:done + chunk])
            scores = self._score_device(self.step.put_batch(batch),
                                        maha=maha)
            out[done:done + chunk] = _to_host(scores)[:chunk]
            done += chunk
        return out

    #: sentinel: "read self._maha now" (dispatcher path) vs an explicit
    #: per-request snapshot (public entry points) — a load_maha_templates
    #: racing a multi-chunk request must not switch scoring families
    #: mid-request
    _MAHA_LIVE = object()

    def _score_device(self, images_device, maha=_MAHA_LIVE):
        if maha is OODDetector._MAHA_LIVE:
            maha = self._maha
        if maha is not None:
            mu, prec, norm = maha
            feats = self.step.features(self.params, images_device)
            return self.step.maha(feats, mu, prec, normalize=norm)
        return self.step.score(self.params, images_device, self.text_feats)

    def classify_images(self, images_u8: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Joint zero-shot classification + OOD scoring:
        [N, S, S, 3] uint8 → ``(class_idx [N] int64, scores [N] fp32)``.

        The class is the argmax over the same prompt-similarity logits the
        CLIP scores reduce (host fp32 from the device features, one encoder
        pass; ``detection_util.py:225-231``).  The SCORES follow the
        detector's scoring path (Mahalanobis once templates are loaded,
        else ``cfg.score`` from the host logits), so a calibrated threshold
        means the same on ``score_images`` and here."""
        from mcm_tpu_torch.scores.clip_scores import (CLIP_SCORES,
                                                      _scores_from_logits_host)
        images_u8 = self._validate_images(images_u8, "classify_images")
        maha = self._maha   # one scoring family for the WHOLE request
        if maha is None and self.cfg.score not in CLIP_SCORES:
            # e.g. score="odin": its input-perturbation score has no
            # host-from-logits form
            raise RequestRefused(
                f"classify_images supports {sorted(CLIP_SCORES)} and "
                f"Mahalanobis templates; this detector scores with "
                f"{self.cfg.score!r} — use score_images")
        if self._text_host is None:
            self._text_host = _to_host(self.text_feats).astype(np.float32)
        n = images_u8.shape[0]
        idx = np.empty((n,), np.int64)
        scores = np.empty((n,), np.float32)
        done = 0
        while done < n:
            chunk = min(n - done, self.batch_sizes[-1])
            batch = self._pad_to_bucket(images_u8[done:done + chunk])
            feats_dev = self.step.features(self.params,
                                           self.step.put_batch(batch))
            feats = _to_host(feats_dev).astype(np.float32)[:chunk]
            fn = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
            logits = fn @ self._text_host.T
            idx[done:done + chunk] = np.argmax(logits, axis=-1)
            if maha is not None:
                # score EXACTLY like _score_device; the chunk's result gets
                # its own name, so the family snapshot ``maha`` still holds
                # (mu, prec, normalize) for the next chunk
                mu, prec, norm = maha
                chunk_scores = self.step.maha(feats_dev, mu, prec,
                                              normalize=norm)
                scores[done:done + chunk] = _to_host(chunk_scores)[:chunk]
            else:
                scores[done:done + chunk] = _scores_from_logits_host(
                    logits, self.cfg.T)[self.cfg.score].astype(np.float32)
            done += chunk
        return idx, scores

    def warmup(self, include_features: bool = False, log=None) -> None:
        """Run every batch bucket once before serving traffic.

        Nothing compiles per shape here, but the first use of a bucket
        still pays the kernels' first-use ``nvcc`` builds, cuBLAS's handle
        and algorithm choice for that shape, and the caching allocator's
        first allocations; without warmup the first request of each size
        eats that, and a reachable /healthz overstates readiness.  Warms
        the scoring path of every bucket (the Mahalanobis route when
        templates are loaded), plus ``features`` when ``include_features``
        (what ``classify_images`` runs) and the host copy of the prompt
        features.  The buckets run one after another on the device's one
        stream (the JAX package warms them on concurrent threads, to
        overlap per-shape compiles the port does not have); ``log`` gets
        ``"warmed bucket {b}"`` after each, and a failing bucket raises at
        once."""
        s = self.image_size
        for b in self.batch_sizes:
            zero = self.step.put_batch(np.zeros((b, s, s, 3), np.uint8))
            _to_host(self._score_device(zero))
            if include_features:
                _to_host(self.step.features(self.params, zero))
            if log:
                log(f"warmed bucket {b}")
        if include_features and self._text_host is None:
            self._text_host = _to_host(self.text_feats).astype(np.float32)

    def score_files(self, paths: Sequence[str],
                    num_workers: Optional[int] = None) -> np.ndarray:
        """Decode (the native decoder through ``DataPipeline``'s default,
        PIL for the rows it refuses) + score image files, with the
        evaluator's one-batch-behind readback so decode, H2D, device
        compute and D2H overlap."""
        from mcm_tpu_torch.data.pipeline import DataPipeline, collect_scores
        ds = [(p, 0) for p in paths]
        if not ds:
            return np.zeros((0,), np.float32)
        b = self._bucket(len(ds))
        maha = self._maha   # one scoring family for the WHOLE request
        pipe = DataPipeline(ds, b, image_size=self.image_size,
                            num_workers=num_workers)
        stream = _StreamReadback()
        valids = []
        for batch in pipe:
            stream.push(self._score_device(self.step.put_batch(batch.images),
                                           maha=maha))
            valids.append(batch.valid)
        return collect_scores(stream.finish(), valids, len(ds))

    # -- thresholding ----------------------------------------------------------

    def calibrate(self, id_scores: np.ndarray, tpr: float = 0.95) -> float:
        """Set the ID/OOD threshold so ``tpr`` of held-out ID scores pass.

        The online analogue of FPR@95%TPR: everything at or below the
        ``tpr``-quantile of ID scores is called in-distribution."""
        self.threshold = float(np.quantile(np.asarray(id_scores), tpr))
        return self.threshold

    def is_id(self, scores: np.ndarray) -> np.ndarray:
        """[N] bool — True where the image is called in-distribution."""
        if self.threshold is None:
            raise RuntimeError("call calibrate(id_scores) first")
        return np.asarray(scores) <= self.threshold


class Overloaded(RuntimeError):
    """Raised by :meth:`MicroBatcher.submit` when ``max_pending``
    unresolved requests are already queued — the caller should shed load
    (reject / retry later), not pile onto an unbounded queue."""


class BatcherClosed(RuntimeError):
    """Raised by :meth:`MicroBatcher.submit` once the batcher was closed or
    its dispatcher died: the replica is unavailable."""


class MicroBatcher:
    """Concurrent request coalescing in front of an :class:`OODDetector`.

    Requests from any number of client threads queue up; one dispatcher
    thread coalesces whatever arrived within ``max_wait_ms`` (up to the
    detector's largest bucket) into a single padded batch, and results fan
    back out through per-request futures.  The card sees the same bucket
    shapes as the offline path.

    The dispatcher pipelines one batch: batch *i+1* is queued on the card
    before batch *i*'s scores are read back (the evaluator's one-behind
    readback), so readback overlaps device compute under sustained load.
    Every step call enters inference mode itself, so the dispatcher
    thread (inference mode is thread-local) needs no mode of its own.  A
    failure in a batch (a CUDA error at launch or at readback) fails that
    batch's futures; a failure of the loop itself fails every queued and
    in-flight future and closes the batcher.

    Callers may abandon a request with ``future.cancel()``; ``max_pending``
    bounds unresolved requests, past it ``submit`` raises
    :class:`Overloaded`.

    >>> with MicroBatcher(det, max_wait_ms=5) as mb:
    ...     futures = [mb.submit(img) for img in images]   # any threads
    ...     scores = [f.result() for f in futures]
    """

    _SHUTDOWN = object()

    def __init__(self, detector: OODDetector, max_wait_ms: float = 5.0,
                 max_batch: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 extra_load=None):
        biggest = detector.batch_sizes[-1]
        if max_batch is None:
            max_batch = biggest
        if not 1 <= max_batch <= biggest:
            raise ValueError(f"max_batch={max_batch} outside the "
                             f"detector's buckets (max {biggest})")
        self.detector = detector
        self.max_wait = max_wait_ms / 1e3
        self.max_batch = max_batch
        self.max_pending = max_pending
        # co-located non-batcher device work (the HTTP classify path)
        # counts against the same budget: submit adds extra_load() to its
        # headroom check, and that path checks .pending before dispatching
        self._extra_load = extra_load or (lambda: 0)
        self.n_batches = 0
        self.n_images = 0
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = False
        self._lock = threading.Lock()   # orders submit()s vs close()
        self._outstanding = 0           # unresolved futures, for max_pending
        self._pending = None            # claimed in-flight batch
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mcm-microbatcher")
        self._thread.start()

    # -- client side -----------------------------------------------------------

    def submit(self, image_u8: np.ndarray) -> Future:
        """One [S, S, 3] uint8 image → Future of its fp32 score.

        Thread-safe; shape/dtype errors raise here in the caller.  The
        pixels are copied: the caller may reuse its buffer at once."""
        image_u8 = np.asarray(image_u8)
        s = self.detector.image_size
        if image_u8.dtype != np.uint8:
            raise TypeError(f"submit expects one uint8 image, got dtype "
                            f"{image_u8.dtype}")
        if image_u8.shape != (s, s, 3):
            raise RequestRefused(f"submit expects one [{s}, {s}, 3] image "
                                 f"(batches go through score()); got "
                                 f"{image_u8.shape}")
        with self._lock:
            # the queue put happens under the lock close() takes, so every
            # accepted request is enqueued BEFORE the shutdown sentinel
            if self._closed:
                raise BatcherClosed("MicroBatcher is closed")
            load = (self._outstanding + self._extra_load()
                    if self.max_pending is not None else 0)
            if self.max_pending is not None and load >= self.max_pending:
                raise Overloaded(
                    f"{load} requests already pending "
                    f"(max_pending={self.max_pending})")
            fut: Future = Future()
            fut.add_done_callback(self._on_done)
            self._outstanding += 1
            self._queue.put((image_u8.copy(), fut))
        return fut

    def _on_done(self, _fut) -> None:
        with self._lock:
            self._outstanding -= 1

    @property
    def pending(self) -> int:
        """Unresolved requests right now (the quantity ``max_pending``
        bounds)."""
        with self._lock:
            return self._outstanding

    @property
    def alive(self) -> bool:
        """False once closed OR after the dispatcher thread crashed (its
        crash handler flips ``_closed``), so a health endpoint keyed on
        this takes a dead replica out of rotation."""
        with self._lock:
            return not self._closed

    def score(self, images_u8: np.ndarray) -> np.ndarray:
        """Blocking convenience: submit each image, gather scores.

        All-or-nothing under backpressure: if ``max_pending`` headroom runs
        out partway through, the already-submitted prefix is awaited (the
        dispatcher scores it regardless) before ``Overloaded`` is
        re-raised."""
        images_u8 = np.asarray(images_u8)
        if images_u8.ndim == 3:
            images_u8 = images_u8[None]
        futures = []
        try:
            for img in images_u8:
                futures.append(self.submit(img))
        except Overloaded:
            for f in futures:
                try:
                    f.result()
                except Exception:  # noqa: BLE001 — Overloaded is re-raised
                    pass
            raise
        return np.array([f.result() for f in futures], np.float32)

    def close(self) -> None:
        """Drain outstanding requests, then stop the dispatcher."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._queue.put(self._SHUTDOWN)
        self._thread.join()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatcher ------------------------------------------------------------

    def _collect(self, block: bool):
        """Wait for the first request (non-blocking when a dispatched batch
        is pending readback), then coalesce what arrives within the wait
        window.  Returns (requests, saw_shutdown)."""
        try:
            first = self._queue.get() if block else self._queue.get_nowait()
        except queue.Empty:
            return [], False
        if first is self._SHUTDOWN:
            return [], True
        reqs = [first]
        deadline = time.monotonic() + self.max_wait
        while len(reqs) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is self._SHUTDOWN:
                return reqs, True
            reqs.append(item)
        return reqs, False

    def _dispatch(self, reqs):
        """Pad to a bucket (a fresh array per batch) and queue it on the
        device."""
        det = self.detector
        batch = det._pad_to_bucket([img for img, _ in reqs])
        return det._score_device(det.step.put_batch(batch))

    @staticmethod
    def _fail(reqs, exc) -> None:
        for _, fut in reqs:
            try:
                fut.set_exception(exc)
            except InvalidStateError:
                pass  # racing cancel(); the caller already walked away

    @staticmethod
    def _resolve(pending):
        device_scores, reqs = pending
        try:
            host = _to_host(device_scores)  # the real barrier + D2H
            # every value BEFORE resolving anything: too few scores must
            # fail the whole batch, not resolve a prefix
            values = [float(host[i]) for i in range(len(reqs))]
        except Exception as e:  # noqa: BLE001 — fan the failure out
            MicroBatcher._fail(reqs, e)
            return
        for (_, fut), val in zip(reqs, values):
            try:
                fut.set_result(val)
            except InvalidStateError:
                pass  # cancelled between dispatch-claim and readback

    def _run_batch(self, reqs):
        """Claim, dispatch, and account one coalesced batch.  Returns the
        (device_scores, reqs) pending tuple, or None."""
        # a False claim means the caller cancelled while queued
        reqs = [r for r in reqs if r[1].set_running_or_notify_cancel()]
        if not reqs:
            return None
        try:
            pending = (self._dispatch(reqs), reqs)
        except Exception as e:  # noqa: BLE001
            self._fail(reqs, e)
            return None
        self.n_batches += 1
        self.n_images += len(reqs)
        return pending

    def _loop(self):
        try:
            self._loop_inner()
        except BaseException as e:  # noqa: BLE001 — must not die silently:
            # refuse new work and fail whatever is queued AND the claimed
            # in-flight batch (its futures are RUNNING)
            with self._lock:
                self._closed = True
            if self._pending is not None:
                self._fail(self._pending[1], e)
                self._pending = None
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not self._SHUTDOWN:
                    self._fail([item], e)
            raise

    def _loop_inner(self):
        self._pending = None
        shutdown = False
        while not shutdown:
            reqs, shutdown = self._collect(block=self._pending is None)
            if not reqs and not shutdown:
                # queue went idle with a batch in flight: read it back now
                done, self._pending = self._pending, None
                self._resolve(done)
                continue
            new_pending = self._run_batch(reqs) if reqs else None
            done, self._pending = self._pending, new_pending
            if done is not None:
                self._resolve(done)
        if self._pending is not None:
            done, self._pending = self._pending, None
            self._resolve(done)
        # requests coalesced together with the shutdown sentinel (submit
        # holds the close() lock, so nothing arrives after the sentinel)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is self._SHUTDOWN:
                continue
            done = self._run_batch([item])
            if done is not None:
                self._resolve(done)
