"""End-to-end evaluation runner — the orchestration behind the CLI.

Mirrors the reference's ``eval_ood_detection.py:main`` (``:53-99``) flow:
model → ID loader → labels → ID scores → per-OOD-set scores → metrics →
plots → CSV, on the devices of the run's mesh:

* text prompts tokenized + encoded once per ID dataset (the reference
  re-encodes them every batch, ``detection_util.py:228-231``);
* the native libjpeg decoder (PIL for the rows it refuses, or every row
  where the route is unavailable: the log's ``decoder:`` line names it)
  prefetches ahead on host threads; uint8 batches go up through pinned
  memory without blocking; kernels are queued asynchronously and each
  batch's scores are read back one batch behind, so decode, H2D, compute
  and D2H overlap;
* per-dataset score arrays are written under the same ``results/…``
  layout as the JAX package, and ``--resume`` reuses them (and the cached
  ID and text features) per dataset when ``cache_meta.json`` says they
  were produced under the same configuration and weights;
* Mahalanobis templates are cached as ``.npz`` (the reference uses
  ``.pt``, ``detection_util.py:175-176``; a reference pair is read too);
* data parallel in two forms (``parallel/mesh.py::make_mesh``):
  ``--n_devices N`` without a launcher runs one process over N of its
  devices, as JAX's runner does: each batch splits into one stripe per
  data group, a model replica on each, and the stripes' results come back
  in dataset order (:func:`~mcm_tpu_torch.parallel.eval_step.to_host`).
  Under ``python -m torch.distributed.run`` (one process per card,
  :mod:`mcm_tpu_torch.parallel.multihost`) each rank decodes and scores
  its stripe of every batch and the passes gather the outputs back into
  dataset order on every rank.  Which caches exist is read once, on rank
  0, and broadcast, so every rank takes the same passes; only rank 0 logs
  and writes (caches, templates, CSV, plots), the others wait for it.

This covers ``--model CLIP`` with every score (the five logit scores,
``maha`` and ``odin``), ``--model CLIP-Linear`` (the same, on a fine-tuned
tree from ``--finetune_ckpt``, as ``mcm_tpu_torch.tools.finetune_clip``
writes it) and ``--model vit-Linear`` (the supervised ViT + linear head,
scored from its logits; ``maha`` refused).  ``--model_parallel T``
splits the CLIP towers over ``T`` devices of each data group
(:mod:`mcm_tpu_torch.parallel.tensor`); ``vit-Linear`` refuses it, as in
the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import logging
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mcm_tpu_torch.config import (CLIP_CONFIGS, CLIP_FEAT_DIMS, resolve_device,
                                  resolve_precision)
from mcm_tpu_torch.data import (DataPipeline, default_out_datasets,
                                get_test_labels, set_ood_loader,
                                set_train_loader, set_val_loader,
                                validate_out_datasets)
from mcm_tpu_torch.metrics import get_and_print_results, print_measures
from mcm_tpu_torch.models.clip import _dense, layer_norm
from mcm_tpu_torch.models.convert import (file_identity, load_params,
                                          resolve_clip_params,
                                          resolve_clip_weight_source)
from mcm_tpu_torch.models.init import init_clip
from mcm_tpu_torch.ops import layer_norm as ln
from mcm_tpu_torch.ops.attention import encoder_attention
from mcm_tpu_torch.ops.dense_epilogue import dense_epilogue
from mcm_tpu_torch.parallel import EvalStep, VitLinearStep, multihost
from mcm_tpu_torch.parallel.eval_step import Replicated, to_host
from mcm_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh
from mcm_tpu_torch.runtime import native
from mcm_tpu_torch.scores.clip_scores import (_scores_from_logits_host,
                                              compute_scores_host, l2_normalize)
from mcm_tpu_torch.scores.mahalanobis import (estimate_mean_precision,
                                              load_pt_templates,
                                              reference_template_paths)
from mcm_tpu_torch.text import CLIPTokenizer, build_prompts
from mcm_tpu_torch.text.prompts import DEFAULT_TEMPLATE, OPENAI_IMAGENET_TEMPLATES
from mcm_tpu_torch.utils import Telemetry, load_scores, save_scores, setup_log
from mcm_tpu_torch.utils.plotting import plot_distribution
from mcm_tpu_torch.utils.results import (atomic_write, save_as_dataframe,
                                         scores_path)
from mcm_tpu_torch.utils.seed import setup_seed
from mcm_tpu_torch.utils.telemetry import maybe_profile


@dataclasses.dataclass
class RunConfig:
    """Typed config underneath the argparse surface
    (reference args at ``eval_ood_detection.py:15-51``)."""

    in_dataset: str = "ImageNet"
    root_dir: str = "datasets"
    name: str = "eval_ood"
    seed: int = 5
    batch_size: int = 512
    T: float = 1.0
    model: str = "CLIP"
    clip_ckpt: str = "ViT-B/16"
    score: str = "MCM"
    # Mahalanobis
    feat_dim: Optional[int] = None          # derived from ckpt if None
    normalize: bool = False
    generate: bool = True
    template_dir: str = "img_templates"
    subset: bool = False
    max_count: int = 250
    # extensions
    precision: str = "fast"                 # fast (bf16) | parity (fp32)
    device: str = "cuda"                    # cuda | cpu
    model_parallel: int = 1
    n_devices: Optional[int] = None
    num_workers: Optional[int] = None
    prefetch: int = 2
    resume: bool = False
    template_ensemble: bool = False         # 80-template prompt ensembling
    ckpt_dir: Optional[str] = None
    allow_random_weights: bool = False      # tests/smoke only
    image_size: int = 224
    trace_dir: Optional[str] = None
    eval_accuracy: bool = False
    fast_decode: bool = False
    finetune_ckpt: Optional[str] = None
    noise_magnitude: float = 0.0014
    out_datasets: Optional[List[str]] = None

    @property
    def log_directory(self) -> str:
        # identical results layout (reference ``eval_ood_detection.py:48``)
        return (f"results/{self.in_dataset}/{self.score}/"
                f"{self.model}_{self.clip_ckpt}_T_{self.T_str}_ID_{self.name}")

    @property
    def T_str(self) -> str:
        # reference --T is an int; print it like one when integral
        return str(int(self.T)) if float(self.T).is_integer() else str(self.T)


def check_ported(cfg: RunConfig) -> None:
    """Raise for every option of the JAX runner the port does not have."""
    if cfg.model not in ("CLIP", "CLIP-Linear", "vit-Linear"):
        raise ValueError(f"unknown --model {cfg.model!r}")


def _validate_batch_divisibility(cfg: RunConfig, mesh: Mesh) -> None:
    """Fail before the weights load: each data group of the mesh (a device
    of this process, or a rank) scores an equal stripe of every (padded,
    static) batch."""
    dp = mesh.shape[DATA_AXIS]
    if cfg.batch_size % dp:
        raise ValueError(
            f"--batch_size {cfg.batch_size} is not divisible by the "
            f"data-parallel mesh size {dp}; pick a multiple (every batch "
            f"is padded to the static batch size, so the tail is fine)")


def _rank0_log(log_directory: str, name: str) -> logging.Logger:
    """The run log on rank 0; on the other ranks a logger that drops every
    record (rank 0's ``ood_eval_info.log`` is the run's only one)."""
    if multihost.process_index() == 0:
        return setup_log(log_directory, name)
    log = logging.getLogger(f"mcm_tpu_torch.{name}.rank")
    log.disabled = True
    return log


class _HashTokenizer:
    """Deterministic fallback when no CLIP vocab is on disk (egress-free
    smoke runs with random weights): words hash into the id space.  Useless
    semantically, shape-identical mechanically — always warns."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.bos_id, self.eos_id = vocab_size - 2, vocab_size - 1
        self.pad_id = self.eos_id

    def __call__(self, texts: Sequence[str],
                 context_length: Optional[int] = None,
                 pad_to_multiple: Optional[int] = None):
        # parameter ORDER matches CLIPTokenizer.__call__ exactly: a
        # positional call must mean the same thing on the smoke fallback
        # as on the real tokenizer
        import hashlib

        from mcm_tpu_torch.text.tokenizer import pad_token_rows
        rows = []
        for t in texts:
            ids = [self.bos_id]
            for w in t.lower().split():
                h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
                ids.append(h % (self.vocab_size - 2))
            ids.append(self.eos_id)
            if context_length and len(ids) > context_length:
                ids = ids[:context_length - 1] + [self.eos_id]
            rows.append(ids)
        return pad_token_rows(rows, self.pad_id, pad_to_multiple,
                              context_length)


def _build_vit_linear(cfg: RunConfig, mesh: Mesh, log=None,
                      defer_put: bool = False):
    """Supervised ViT + linear head (reference ``vit-Linear``,
    ``detection_util.py:124-133``): backbone from an HF
    ``google/vit-base-patch16-224`` snapshot or its converted ``.npz``;
    head = the checkpoint's own classifier, or a trained linear probe
    ``{w, b}`` passed via ``--finetune_ckpt``.  No tokenizer."""
    from mcm_tpu_torch.config import supervised_vit_config
    from mcm_tpu_torch.models.init import init_supervised_vit
    from mcm_tpu_torch.models.vit import (resolve_vit_params,
                                          resolve_vit_weight_source)

    if cfg.score == "maha":
        raise ValueError("--score maha is CLIP-feature-based; "
                         "not supported with --model vit-Linear")
    vit_cfg = supervised_vit_config()
    t0 = time.perf_counter()
    params = resolve_vit_params(vit_cfg, cfg.ckpt_dir)
    if log is not None and params is not None:
        log.debug(f"weights resolved in {time.perf_counter() - t0:.2f}s from "
                  f"{file_identity(resolve_vit_weight_source(cfg.ckpt_dir))}")
    if params is None:
        if not cfg.allow_random_weights:
            raise FileNotFoundError(
                "no supervised ViT weights for --model vit-Linear; put an "
                "HF ViTForImageClassification snapshot (or converted .npz) "
                "under --ckpt_dir, or pass --allow_random_weights")
        warnings.warn("RANDOM WEIGHTS in use — scores are meaningless; "
                      "this mode is for smoke/throughput tests only")
        params = init_supervised_vit(0, vit_cfg)
    if cfg.finetune_ckpt:
        with np.load(cfg.finetune_ckpt) as head:
            params["head"] = {"w": head["w"].astype(np.float32),
                              "b": head["b"].astype(np.float32)}
    n_cls = np.asarray(params["head"]["b"]).shape[0]
    vit_cfg = dataclasses.replace(vit_cfg, num_classes=int(n_cls))
    step = VitLinearStep(vit_cfg, score=cfg.score, T=cfg.T,
                         precision=resolve_precision(cfg.precision),
                         noise_magnitude=cfg.noise_magnitude,
                         model_parallel=cfg.model_parallel, mesh=mesh)
    if defer_put:
        return (lambda: params), None, step
    return step.put_params(params), None, step


def build_model_and_step(cfg: RunConfig, log=None, defer_put: bool = False,
                         mesh: Optional[Mesh] = None):
    """Resolve weights + tokenizer and build the eval step (``EvalStep``
    for CLIP, ``VitLinearStep`` for ``--model vit-Linear``, which has no
    tokenizer) on this process's mesh (``mesh``: a mesh the caller made,
    e.g. serving's :func:`~mcm_tpu_torch.parallel.mesh.make_local_mesh`);
    returns the model on the step's device, the tokenizer and the step.  A
    mesh that cannot be made (more devices than are visible, or under a
    launch an ``--n_devices`` other than the world size) or a batch its
    data groups cannot split raises before any weight loads.

    ``defer_put=True`` returns, in the model's place, a zero-argument
    function that gives the HOST parameter tree (random CLIP weights are
    initialized only when it is called): :func:`run_eval` calls it and
    uploads the tree with ``step.put_params`` on first device use, so a
    fully cached ``--resume`` never touches the card nor initializes
    weights it will not use."""
    check_ported(cfg)
    if mesh is None:
        mesh = make_mesh(cfg.n_devices, cfg.model_parallel, device=cfg.device)
        _validate_batch_divisibility(cfg, mesh)
    if cfg.model == "vit-Linear":
        return _build_vit_linear(cfg, mesh, log, defer_put)
    clip_cfg = CLIP_CONFIGS[cfg.clip_ckpt]()
    precision = resolve_precision(cfg.precision)

    derived_dim = CLIP_FEAT_DIMS.get(cfg.clip_ckpt)
    if (cfg.feat_dim is not None and derived_dim is not None
            and cfg.feat_dim != derived_dim):
        warnings.warn(
            f"--feat_dim {cfg.feat_dim} contradicts {cfg.clip_ckpt}'s "
            f"feature dim {derived_dim}; the dim is derived from the "
            f"checkpoint and the flag value is ignored")

    t0 = time.perf_counter()
    if cfg.model == "CLIP-Linear":
        if not cfg.finetune_ckpt:
            raise ValueError("--model CLIP-Linear requires --finetune_ckpt")
        # the fine-tuned tree, whole (reference train_eval_util.py:24-25)
        params = load_params(cfg.finetune_ckpt)
    else:
        params = resolve_clip_params(cfg.clip_ckpt, cfg.ckpt_dir)
    if log is not None and params is not None:
        # record WHICH weight file fed this run: the CSVs key on flags only
        log.debug(f"weights resolved in {time.perf_counter() - t0:.2f}s from "
                  f"{file_identity(_clip_weight_source(cfg))}")
    if params is None:
        if not cfg.allow_random_weights:
            raise FileNotFoundError(
                f"no pretrained weights for {cfg.clip_ckpt}; set "
                f"MCM_TPU_CKPT_DIR (or --ckpt_dir) to a directory holding "
                f"the converted .npz, the OpenAI .pt or the HF snapshot "
                f"directory, or pass --allow_random_weights for smoke runs")
        warnings.warn("RANDOM WEIGHTS in use — scores are meaningless; "
                      "this mode is for smoke/throughput tests only")
    host = (functools.partial(init_clip, 0, clip_cfg) if params is None
            else lambda: params)

    tokenizer = CLIPTokenizer.resolve(cfg.ckpt_dir)
    if tokenizer is None:
        if not cfg.allow_random_weights:
            raise FileNotFoundError(
                "no CLIP vocab.json/merges.txt found; set MCM_TPU_CKPT_DIR")
        warnings.warn("hash-fallback tokenizer in use (no CLIP vocab found)")
        tokenizer = _HashTokenizer(clip_cfg.text.vocab_size)

    # maha scores image features: its step is MCM's (features + text)
    step = EvalStep(clip_cfg, score=cfg.score if cfg.score != "maha" else "MCM",
                    T=cfg.T, precision=precision, mesh=mesh,
                    noise_magnitude=cfg.noise_magnitude)
    if defer_put:
        return host, tokenizer, step
    return step.put_params(host()), tokenizer, step


def _clip_weight_source(cfg: RunConfig) -> Optional[str]:
    """The file the CLIP towers' weights come from: ``--finetune_ckpt`` for
    ``CLIP-Linear`` (its whole tree), else what resolution picks."""
    if cfg.model == "CLIP-Linear":
        return cfg.finetune_ckpt
    return resolve_clip_weight_source(cfg.clip_ckpt, cfg.ckpt_dir)


def _encode_prompts(step: EvalStep, params, tokenizer, class_names,
                    ensemble: bool) -> torch.Tensor:
    """Tokenize + encode + L2-normalize the concept prompts, once per
    dataset.  With ``ensemble=True``: 80-template CLIP ensembling
    (per-class mean of normalized per-template embeddings, re-normalized)."""
    templates = (OPENAI_IMAGENET_TEMPLATES if ensemble
                 else [DEFAULT_TEMPLATE])
    prompts = build_prompts(class_names, templates)
    # clamp to the text tower's context window (truncation keeps EOS)
    ids, mask = tokenizer(prompts, pad_to_multiple=8,
                          context_length=step.cfg.text.context_length)
    text = step.encode_text(params, ids, mask)          # [T*C, D] normalized
    if ensemble and len(templates) > 1:
        n_t, n_c = len(templates), len(class_names)

        def mean_of_templates(t):
            return l2_normalize(t.reshape(n_t, n_c, -1).mean(dim=0))

        if isinstance(text, Replicated):   # each copy alike on its device
            return Replicated(mean_of_templates(t) for t in text)
        text = mean_of_templates(text)
    return text


class _StreamReadback:
    """One-batch-behind host readback: batch i+1 is queued on the device
    while batch i's result comes back.  Each ``readback`` span records the
    batch read back and the last batch dispatched."""

    def __init__(self, telemetry: Optional[Telemetry] = None,
                 depth: int = 1):
        self._tel = telemetry or Telemetry()
        self._depth = depth
        self._pending: List[torch.Tensor] = []
        self._pushed = 0
        self.out: List[np.ndarray] = []

    def push(self, device_value: torch.Tensor) -> None:
        self._pending.append(device_value)
        self._pushed += 1
        self._drain(self._depth)

    def finish(self) -> List[np.ndarray]:
        self._drain(0)
        return self.out

    def _drain(self, limit: int) -> None:
        while len(self._pending) > limit:
            with self._tel.stage("readback", batch=len(self.out),
                                 dispatched=self._pushed - 1):
                self.out.append(to_host(self._pending.pop(0)))


def _make_pipe(dataset, cfg: RunConfig, drop_remainder: bool = False,
               telemetry: Optional[Telemetry] = None) -> DataPipeline:
    return DataPipeline(dataset, cfg.batch_size, image_size=cfg.image_size,
                        num_workers=cfg.num_workers, prefetch=cfg.prefetch,
                        drop_remainder=drop_remainder,
                        fast_decode=cfg.fast_decode, telemetry=telemetry)


def decoder_route(cfg: RunConfig) -> str:
    """The run log's ``decoder:`` line.  ``--fast_decode`` without the
    native decoder raises (the JAX package ignores the flag there)."""
    info = native.native_info()
    if info["available"]:
        return (f"decoder: native ({info['libjpeg']})"
                + (", fast" if cfg.fast_decode else ""))
    if cfg.fast_decode:
        raise RuntimeError(f"--fast_decode needs the native decoder, which "
                           f"is unavailable: {info['reason']}")
    return f"decoder: PIL ({info['reason']})"


#: ``towers.*`` counter → the module-level count it reads
_TOWER_COUNTS = {
    "towers.dense_epilogue": (dense_epilogue, "launches"),
    "towers.dense_epilogue_gelu": (dense_epilogue, "gelu_launches"),
    "towers.dense_plain": (_dense, "plain"),
    "towers.layer_norm": (ln.layer_norm, "launches"),
    "towers.layer_norm_plain": (layer_norm, "plain"),
    "towers.attention_bsd": (encoder_attention, "bsd"),
    "towers.attention_math": (encoder_attention, "math"),
}


@contextlib.contextmanager
def _tower_counts(tel: Telemetry):
    """Adds to ``tel``'s counters what the towers did inside the block: the
    dense epilogues launched (``towers.dense_epilogue``, of them in the
    erf-GELU mode ``towers.dense_epilogue_gelu``), the plain chains run
    (``towers.dense_plain``), the LayerNorm kernels launched
    (``towers.layer_norm``) and the LayerNorms on the plain chain
    (``towers.layer_norm_plain``), and the attention calls by route
    (``towers.attention_bsd``, ``towers.attention_math``)."""
    before = {n: getattr(*src) for n, src in _TOWER_COUNTS.items()}
    try:
        yield
    finally:
        for name, src in _TOWER_COUNTS.items():
            tel.count(name, getattr(*src) - before[name])


def _stream_pass(step, dispatch, dataset, cfg: RunConfig,
                 telemetry: Optional[Telemetry] = None,
                 drop_remainder: bool = False,
                 collect_labels: bool = False):
    """The shared device-streaming loop (decode → H2D → dispatch →
    one-batch-behind readback → dataset-order assembly, gathered over the
    ranks).  ``dispatch(images)`` is the per-batch device call."""
    tel = telemetry or Telemetry()
    pipe = _make_pipe(dataset, cfg, drop_remainder, tel)
    stream = _StreamReadback(tel)
    valids: List[int] = []
    labels: List[np.ndarray] = []
    with _tower_counts(tel):
        for b, batch in enumerate(pipe):
            with tel.stage("h2d", batch=b):
                images = step.put_batch(batch.images)
            with tel.stage("dispatch", batch=b):
                out = dispatch(images)
            stream.push(out)  # drains the previous batch under "readback"
            valids.append(batch.valid)
            if collect_labels:
                labels.append(batch.labels)
            tel.add_images(batch.valid)
    total = (len(pipe) * cfg.batch_size if drop_remainder
             else pipe.num_samples)
    total = min(total, sum(valids)) if valids else 0
    outs = multihost.assemble_global_outputs(stream.finish(), valids, total)
    if collect_labels:
        return outs, multihost.assemble_global_outputs(labels, valids, total)
    return outs


def score_dataset(step: EvalStep, params, dataset, text_feats,
                  cfg: RunConfig,
                  telemetry: Optional[Telemetry] = None) -> np.ndarray:
    """Stream a dataset through the score step (the reference keeps the
    final partial batch for every CLIP score — ``detection_util.py:249``
    truncates, never drops; only the maha OOD pass drops tails)."""
    return _stream_pass(step, lambda im: step.score(params, im, text_feats),
                        dataset, cfg, telemetry)


def extract_features(step: EvalStep, params, dataset, cfg: RunConfig,
                     telemetry: Optional[Telemetry] = None) -> tuple:
    """All image features + labels for a dataset (Mahalanobis templates,
    ``--eval_accuracy``)."""
    return _stream_pass(step, lambda im: step.features(params, im),
                        dataset, cfg, telemetry, collect_labels=True)


def _weight_content_sig(cfg: RunConfig) -> Optional[Dict[str, object]]:
    """Machine-independent content identity of the resolved weights (size
    + sampled sha only — no path, so templates travel between hosts).
    None when unresolvable (random-weights smoke runs)."""
    ident = _weight_identity(cfg).get("weights")
    if not ident or "sha256_sampled" not in ident:
        return None
    return {"size": ident["size"], "sha": ident["sha256_sampled"]}


def _on_disk(paths: Sequence[str]) -> frozenset:
    """The ``paths`` that exist, as rank 0 sees them, on every rank: a rank
    that saw a file appear or vanish a moment later would take another pass,
    and so join other collectives, than the rest."""
    found = ({p for p in paths if os.path.exists(p)}
             if multihost.process_index() == 0 else None)
    return frozenset(multihost.broadcast_object(found))


def _maha_templates(cfg: RunConfig, step: EvalStep, get_params, log,
                    telemetry: Optional[Telemetry] = None):
    """Estimate or load class means + precision (reference ``main:72-78``).

    ``get_params`` is a zero-arg callable returning device params — called
    only on the regenerate path, so a cached-template load stays free of
    the parameter upload (device-free resume).  Every rank extracts its
    stripe of the train features and gets them all back; rank 0 estimates
    and writes the templates, and every rank then loads that file."""
    writer = multihost.process_index() == 0
    if writer:
        os.makedirs(cfg.template_dir, exist_ok=True)
    # beyond the reference's tag ({model}_{in_dataset}_{max_count}_
    # {normalize}, detection_util.py:175): the checkpoint name AND the
    # subset flag are part of it — the reference lets B/16 and B/32 share
    # 512-d templates, and full-train-set and 250-per-class templates
    # collide at one path
    ckpt_tag = cfg.clip_ckpt.replace("/", "-")
    tag = (f"{cfg.model}_{ckpt_tag}_{cfg.in_dataset}_{cfg.max_count}_"
           f"{cfg.normalize}" + ("_subset" if cfg.subset else ""))
    path = os.path.join(cfg.template_dir, f"templates_{tag}.npz")
    mu_pt, prec_pt = reference_template_paths(
        cfg.template_dir, cfg.model, cfg.in_dataset, cfg.max_count,
        cfg.normalize)
    on_disk = _on_disk([path, mu_pt, prec_pt])
    # --resume honors an existing template cache even under the default
    # --generate: regenerating would re-extract the whole train set
    regenerate = cfg.generate and not (cfg.resume and path in on_disk)
    if not cfg.generate and path not in on_disk:
        # migrating users: accept the reference's torch .pt template pair
        # (detection_util.py:175-176) and re-cache it natively
        if mu_pt in on_disk and prec_pt in on_disk:
            if writer:
                mu, prec = load_pt_templates(mu_pt, prec_pt)
                log.debug(f"loaded reference-format .pt templates from "
                          f"{mu_pt} / {prec_pt}")
                # no weight_sig: which weights produced the pair is
                # unknowable
                atomic_write(path, lambda f: np.savez(
                    f, classwise_mean=mu, precision=prec,
                    normalize=cfg.normalize))
        else:
            raise FileNotFoundError(
                f"--generate was disabled but no cached Mahalanobis "
                f"templates exist at {path} (nor a reference-format pair at "
                f"{mu_pt}); run once with --generate first")
    sig = _weight_content_sig(cfg)
    if regenerate:   # (without it, the file is there or was just written)
        train_ds = set_train_loader(cfg.in_dataset, cfg.root_dir,
                                    subset=cfg.subset,
                                    max_count=cfg.max_count)
        t0 = time.perf_counter()
        feats, labels = extract_features(step, get_params(), train_ds, cfg,
                                         telemetry)
        t_extract = time.perf_counter() - t0
    if regenerate and writer:
        n_cls = len(get_test_labels(cfg.in_dataset, train_ds))
        t0 = time.perf_counter()
        mu, prec = estimate_mean_precision(feats, labels, n_cls,
                                           normalize=cfg.normalize)
        t_estimate = time.perf_counter() - t0
        cond = np.linalg.cond(prec)
        log.debug(f"cond number: {cond}")  # reference prints this (:174)
        log.debug(f"maha templates: {len(feats)} train features in "
                  f"{t_extract:.3f}s ({len(feats) / max(t_extract, 1e-9):.1f}"
                  f" img/s); fp64 covariance+inverse {t_estimate:.3f}s")
        # normalize is recorded so a consumer cannot score with the wrong
        # flag; weight_sig ties the templates to the weights that made them
        extra = {"weight_sig": json.dumps(sig)} if sig else {}
        atomic_write(path, lambda f: np.savez(
            f, classwise_mean=mu, precision=prec,
            normalize=cfg.normalize, **extra))
    multihost.barrier()   # rank 0's file is on disk before any rank reads it
    with np.load(path) as data:
        # templates live OUTSIDE the fingerprint-purged log_directory, so
        # a swapped checkpoint under an unchanged config would otherwise
        # silently score new-weight features against old-weight mu/prec
        if "weight_sig" in data and sig is not None:
            stored = json.loads(str(data["weight_sig"]))
            if stored != sig:
                raise ValueError(
                    f"Mahalanobis templates at {path} were estimated from "
                    f"DIFFERENT weights than this run resolves (stored "
                    f"size/sha {stored} vs current {sig}); rerun with "
                    f"--generate to re-estimate, or delete the file")
        elif "weight_sig" not in data:
            log.debug(f"templates at {path} carry no weight fingerprint "
                      f"(reference .pt ingestion) — weight/template "
                      f"consistency not verifiable")
        mu_arr, prec_arr = data["classwise_mean"], data["precision"]
    return step.put_replicated(mu_arr), step.put_replicated(prec_arr)


def maha_score_dataset(step: EvalStep, params, dataset, mu, prec,
                       cfg: RunConfig, in_dist: bool,
                       telemetry: Optional[Telemetry] = None) -> np.ndarray:
    """Mahalanobis scoring pass.  Reference quirk preserved: OOD passes drop
    the final partial batch (``detection_util.py:189``)."""
    def dispatch(images):
        f = step.features(params, images)
        return step.maha(f, mu, prec, normalize=cfg.normalize)

    return _stream_pass(step, dispatch, dataset, cfg, telemetry,
                        drop_remainder=not in_dist)


def _log_id_accuracy(cfg: RunConfig, feats, labels, text_feats, log) -> None:
    """Log ID top-1/top-5 accuracy from cached features (classifier logits
    for vit-Linear; zero-shot prompt matching otherwise)."""
    if cfg.model == "vit-Linear":
        from mcm_tpu_torch.utils.meters import accuracy
        top1, top5 = accuracy(feats, labels, topk=(1, 5))
        log.debug(f"ID classifier accuracy: top1 {top1:.2f}% "
                  f"top5 {top5:.2f}%")
        return
    from mcm_tpu_torch.data.labels import prompt_permutation
    from mcm_tpu_torch.utils.meters import zero_shot_accuracy
    # align label indices with prompt rows (ImageNet100 prompts follow
    # class_list order, not the sorted-wnid label order)
    perm = prompt_permutation(cfg.in_dataset)
    mapped = perm[labels] if perm is not None else labels
    top1, top5 = zero_shot_accuracy(feats, np.asarray(text_feats),
                                    mapped, topk=(1, 5))
    log.debug(f"ID zero-shot accuracy: top1 {top1:.2f}% top5 {top5:.2f}%")


def _id_features_path(cfg: RunConfig) -> str:
    return os.path.join(cfg.log_directory,
                        f"ID_{cfg.in_dataset}_features.npz")


def _id_features_cached(step, get_params, val_ds, cfg: RunConfig, log,
                        cached: frozenset, telemetry=None):
    """ID features (+labels), taken from the cache when ``cached`` (the
    run's view of its resumable files) holds it.  ``get_params`` (zero-arg
    callable) is invoked only on a cache miss, so the cached path stays
    free of the parameter upload."""
    path = _id_features_path(cfg)
    if path in cached:
        with np.load(path) as data:
            log.debug(f"resume: loaded cached ID features for "
                      f"{cfg.in_dataset}")
            return data["features"], data["labels"]
    with maybe_profile(cfg.trace_dir, telemetry):
        feats, labels = extract_features(step, get_params(), val_ds, cfg,
                                         telemetry)
    if multihost.process_index() == 0:
        atomic_write(path, lambda f: np.savez(f, features=feats,
                                              labels=labels))
    return feats, labels


def _weight_identity(cfg: RunConfig) -> Dict[str, object]:
    """Content identity of every weight file feeding this run (resolved
    path + size + sampled sha).  The config alone can't fingerprint the
    numbers: swapping the checkpoint under an unchanged ``--CLIP_ckpt``
    changes every score while every flag stays equal — without this,
    ``--resume`` would serve the old model's scores."""
    if cfg.model == "vit-Linear":
        from mcm_tpu_torch.models.vit import resolve_vit_weight_source
        ident: Dict[str, object] = {"weights": file_identity(
            resolve_vit_weight_source(cfg.ckpt_dir))}
    else:
        ident = {"weights": file_identity(_clip_weight_source(cfg))}
    if cfg.finetune_ckpt and cfg.model != "CLIP-Linear":
        # vit-Linear: the probe-head npz overriding the classifier
        ident["finetune_ckpt"] = file_identity(cfg.finetune_ckpt)
    if cfg.model != "vit-Linear" and cfg.score != "maha":
        # vocab.json/merges.txt determine every token id, hence every text
        # feature and score.  None = hash-fallback tokenizer, which itself
        # participates in the (mis)match.  A maha run never tokenizes and
        # its caches live in their own score-keyed log_directory, so a
        # vocab appearing must not purge them.
        tok_dir = CLIPTokenizer.resolve_dir(cfg.ckpt_dir)
        ident["tokenizer"] = None if tok_dir is None else {
            "vocab": file_identity(os.path.join(tok_dir, "vocab.json")),
            "merges": file_identity(os.path.join(tok_dir, "merges.txt")),
        }
    return ident


def _cache_meta(cfg: RunConfig) -> Dict[str, object]:
    """The fields that determine cached artifacts' NUMBERS (scores,
    features, text features).  The results layout keys the cache directory
    by {in_dataset, score, model, ckpt, T, name} only — every other
    numerically-relevant input lives here, and ``--resume`` refuses caches
    whose recorded meta mismatches.  batch_size is included because the
    maha OOD tail-drop truncates at a batch boundary; weight_identity
    because the flags alone can't see a swapped checkpoint.  Call AFTER
    weights resolve: resolution may write the ``.npz`` cache that later
    runs load (and get fingerprinted on)."""
    return {
        "clip_ckpt": cfg.clip_ckpt, "model": cfg.model, "score": cfg.score,
        "T": cfg.T_str, "in_dataset": cfg.in_dataset,
        "template_ensemble": cfg.template_ensemble,
        "normalize": cfg.normalize, "precision": cfg.precision,
        "image_size": cfg.image_size, "fast_decode": cfg.fast_decode,
        "noise_magnitude": cfg.noise_magnitude,
        "finetune_ckpt": cfg.finetune_ckpt,
        "allow_random_weights": cfg.allow_random_weights,
        "max_count": cfg.max_count, "subset": cfg.subset,
        "batch_size": cfg.batch_size,
        "weight_identity": _weight_identity(cfg),
    }


#: everything run_eval persists under log_directory — the artifacts the
#: meta fingerprint guards.  The second pattern's trailing * spans ID
#: features (ID_<ds>_features.npz), text features
#: (ID_<ds>_text_features.npz) and the ensemble variant (..._ens.npz).
_CACHE_ARTIFACT_GLOBS = ("*_scores.npy", "ID_*_features*.npz")


def _purge_stale_caches(log_directory: str, log) -> int:
    """Delete cached score/feature/text artifacts recorded under a
    different fingerprint.  Disabling --resume alone is not enough: a run
    under the new config writes the new meta at start, and if it crashes
    mid-sweep, per-dataset caches from the OLD config would sit on disk
    matching the NEW meta."""
    import glob
    removed = 0
    for pat in _CACHE_ARTIFACT_GLOBS:
        for path in glob.glob(os.path.join(log_directory, pat)):
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass
    if removed:
        log.debug(f"purged {removed} stale cached artifact(s) recorded "
                  f"under a different configuration")
    return removed


def _check_cache_meta(cfg: RunConfig, log) -> RunConfig:
    """Validate (and record) the cache fingerprint.  On mismatch: disable
    ``--resume`` for this run AND delete the stale artifacts."""
    meta_path = os.path.join(cfg.log_directory, "cache_meta.json")
    meta = _cache_meta(cfg)
    old = None
    try:
        with open(meta_path) as f:
            old = json.load(f)
    except (OSError, ValueError):
        pass
    if old != meta:
        if cfg.resume:
            if old is None:
                why = "no cache_meta.json (artifacts predate the check)"
            else:
                diff = sorted(k for k in meta
                              if old.get(k, "<absent>") != meta[k])
                why = "changed: " + ", ".join(
                    f"{k} {old.get(k, '<absent>')!r}→{meta[k]!r}"
                    for k in diff)
            warnings.warn(
                f"--resume: cached artifacts in {cfg.log_directory} were "
                f"produced under a different configuration ({why}); "
                f"ignoring them and rescoring")
            log.debug(f"resume disabled: cache meta mismatch ({why})")
            cfg = dataclasses.replace(cfg, resume=False)
        _purge_stale_caches(cfg.log_directory, log)
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
    return cfg


def run_eval(cfg: RunConfig) -> Dict[str, Dict[str, float]]:
    """Full evaluation (reference ``main``, ``eval_ood_detection.py:53-99``).

    Returns {out_dataset: {FPR95, AUROC, AUPR}} plus an "AVG" row, on every
    rank (rank 0 computes it)."""
    check_ported(cfg)
    resolve_device(cfg.device)   # no card and no --device cpu: fail first
    route = decoder_route(cfg)
    setup_seed(cfg.seed)
    writer = multihost.process_index() == 0
    log = _rank0_log(cfg.log_directory, cfg.name)
    log.debug(route)
    telemetry = Telemetry()

    # build BEFORE the cache-meta check: weight resolution may write the
    # .npz cache, and the fingerprint must record the file later runs
    # load.  The parameters stay on the host until first device use: a
    # fully cached --resume never uploads them.
    host_params, tokenizer, step = build_model_and_step(cfg, log,
                                                        defer_put=True)
    log.debug(f"mesh: {step.mesh.describe()}")
    _params: Dict[str, object] = {}

    def dev_params():
        """The model on the step's device, uploaded on first use only."""
        if "dev" not in _params:
            _params["dev"] = step.put_params(host_params())
        return _params["dev"]

    if writer:
        cfg = _check_cache_meta(cfg, log)
    cfg = dataclasses.replace(
        cfg, resume=multihost.broadcast_object(cfg.resume))
    out_datasets = cfg.out_datasets or default_out_datasets(cfg.in_dataset)
    # fail a typo'd --out_datasets before the ID pass
    validate_out_datasets(out_datasets)

    val_ds = set_val_loader(cfg.in_dataset, cfg.root_dir)
    test_labels = get_test_labels(cfg.in_dataset, val_ds)

    needs_text = cfg.score != "maha" and cfg.model != "vit-Linear"
    _text: Dict[str, object] = {}
    _text_cache = os.path.join(
        cfg.log_directory,
        f"ID_{cfg.in_dataset}_text_features"
        f"{'_ens' if cfg.template_ensemble else ''}.npz")
    # the caches --resume may take, as rank 0 sees them before any pass
    cached = _on_disk(
        [scores_path(cfg.log_directory, ds)
         for ds in (f"ID_{cfg.in_dataset}", *out_datasets)]
        + [_text_cache, _id_features_path(cfg)]) if cfg.resume else frozenset()

    def text_dev():
        """Prompt features on the device, encoded (or uploaded from the
        host cache) only when a dataset actually needs scoring."""
        if not needs_text:
            return None
        if "dev" not in _text:
            if "host" not in _text and _text_cache in cached:
                text_host()   # a partial resume uploads the cached copy
            if "host" in _text:
                _text["dev"] = step.put_replicated(_text["host"])
            else:
                with _tower_counts(telemetry):
                    _text["dev"] = _encode_prompts(step, dev_params(),
                                                   tokenizer, test_labels,
                                                   cfg.template_ensemble)
        return _text["dev"]

    def text_host():
        """Host copy of the prompt features, cached to disk: a fully
        cached --resume must touch the device ZERO times."""
        if not needs_text:
            return None
        if "host" not in _text:
            if "dev" not in _text and _text_cache in cached:
                with np.load(_text_cache) as data:
                    _text["host"] = data["text_features"]
                log.debug("resume: loaded cached text features")
            else:
                _text["host"] = to_host(text_dev())
                if writer:
                    atomic_write(_text_cache, lambda f: np.savez(
                        f, text_features=_text["host"]))
        return _text["host"]

    _maha: Dict[str, object] = {}

    def maha_templates():
        """Lazy mu/prec: a fully cached maha --resume never builds them."""
        if "mu" not in _maha:
            _maha["mu"], _maha["prec"] = _maha_templates(
                cfg, step, dev_params, log, telemetry)
        return _maha["mu"], _maha["prec"]

    def scores_for(dataset, ds_name, in_dist):
        if scores_path(cfg.log_directory, ds_name) in cached:
            log.debug(f"resume: loaded cached scores for {ds_name}")
            return load_scores(cfg.log_directory, ds_name)
        if cfg.score == "maha":
            mu, prec = maha_templates()
            s = maha_score_dataset(step, dev_params(), dataset, mu, prec,
                                   cfg, in_dist, telemetry)
        else:
            s = score_dataset(step, dev_params(), dataset, text_dev(), cfg,
                              telemetry)
        if writer:
            save_scores(cfg.log_directory, ds_name, s)
        return s

    # ODIN scores need the perturbed forward, so the shared-features path
    # below can't produce them.  Parity runs fall through too: that path
    # scores ID on the HOST while OOD sets score on the device, an
    # ulp-level mix a parity run must not carry — there --eval_accuracy
    # pays a second ID pass for the accuracy features instead.
    if (cfg.eval_accuracy and cfg.score not in ("maha", "odin")
            and cfg.precision != "parity"):
        # one ID pass: features once, both the ID scores and the accuracy
        # derived from them on the host; features cached for --resume
        feats, labels = _id_features_cached(step, dev_params, val_ds, cfg,
                                            log, cached, telemetry)
        if cfg.model == "vit-Linear":
            # the "features" are classifier logits: score them directly
            in_score = _scores_from_logits_host(
                np.asarray(feats, np.float32), cfg.T)[cfg.score]
            in_score = np.asarray(in_score, np.float32)
        else:
            in_score = compute_scores_host(feats, text_host(),
                                           score=cfg.score, T=cfg.T)
        _log_id_accuracy(cfg, feats, labels, text_host(), log)
        if writer:
            save_scores(cfg.log_directory, f"ID_{cfg.in_dataset}", in_score)
    else:
        with maybe_profile(cfg.trace_dir, telemetry):
            in_score = scores_for(val_ds, f"ID_{cfg.in_dataset}", True)
        if cfg.eval_accuracy:
            if cfg.score == "maha":
                warnings.warn("--eval_accuracy is ignored with --score maha "
                              "(no prompt features to classify against)")
            else:  # odin/parity: accuracy from a separate (cached) feature
                   # pass — scores stay pure device output
                feats, labels = _id_features_cached(step, dev_params,
                                                    val_ds, cfg, log, cached,
                                                    telemetry)
                _log_id_accuracy(cfg, feats, labels, text_host(), log)

    out_scores = [scores_for(set_ood_loader(ds, cfg.root_dir), ds, False)
                  for ds in out_datasets]
    # every rank holds every score now; rank 0 reports and writes, and the
    # broadcast of its results keeps the others until its files are written
    results = (_report(cfg, log, in_score, out_datasets, out_scores)
               if writer else None)
    log.debug(telemetry.report())
    return multihost.broadcast_object(results)


def _report(cfg: RunConfig, log, in_score: np.ndarray,
            out_datasets: Sequence[str],
            out_scores: Sequence[np.ndarray]) -> Dict[str, Dict[str, float]]:
    """Metrics, plots and the CSV of a run (reference ``main``'s tail)."""
    from scipy import stats

    auroc_list: List[float] = []
    aupr_list: List[float] = []
    fpr_list: List[float] = []
    results: Dict[str, Dict[str, float]] = {}
    for out_dataset, out_score in zip(out_datasets, out_scores):
        log.debug(f"Evaluting OOD dataset {out_dataset}")  # sic (reference)
        log.debug(f"in scores: {stats.describe(in_score)}")
        log.debug(f"out scores: {stats.describe(out_score)}")
        plot_distribution(cfg.log_directory, cfg.score, out_dataset,
                          in_score, out_score)
        get_and_print_results(cfg, log, in_score, out_score,
                              auroc_list, aupr_list, fpr_list)
        results[out_dataset] = {"FPR95": fpr_list[-1],
                                "AUROC": auroc_list[-1],
                                "AUPR": aupr_list[-1]}

    log.debug("\n\nMean Test Results")
    print_measures(log, float(np.mean(auroc_list)), float(np.mean(aupr_list)),
                   float(np.mean(fpr_list)), method_name=cfg.score)
    save_as_dataframe(cfg.log_directory, cfg.name, out_datasets, fpr_list,
                      auroc_list, aupr_list)
    results["AVG"] = {"FPR95": float(np.mean(fpr_list)),
                      "AUROC": float(np.mean(auroc_list)),
                      "AUPR": float(np.mean(aupr_list))}
    return results
