"""End-to-end evaluation runner — the orchestration behind the CLI.

Mirrors the reference's ``eval_ood_detection.py:main`` (``:53-99``) flow:
model → ID loader → labels → ID scores → per-OOD-set scores → metrics →
plots → CSV, on one CUDA device:

* text prompts tokenized + encoded once per ID dataset (the reference
  re-encodes them every batch, ``detection_util.py:228-231``);
* host decode threads prefetch ahead; uint8 batches go up through pinned
  memory without blocking; kernels are queued asynchronously and each
  batch's scores are read back one batch behind, so decode, H2D, compute
  and D2H overlap;
* per-dataset score arrays are written under the same ``results/…``
  layout as the JAX package.

This slice covers ``--model CLIP`` with the five logit scores.  The other
options of the JAX runner raise ``NotImplementedError`` naming their
``ROADMAP.md`` item.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mcm_tpu_torch.config import (CLIP_CONFIGS, CLIP_FEAT_DIMS, resolve_device,
                                  resolve_precision)
from mcm_tpu_torch.data import (DataPipeline, default_out_datasets,
                                get_test_labels, set_ood_loader,
                                set_val_loader, validate_out_datasets)
from mcm_tpu_torch.metrics import get_and_print_results, print_measures
from mcm_tpu_torch.models.convert import (file_identity, resolve_clip_params,
                                          resolve_clip_weight_source)
from mcm_tpu_torch.models.init import init_clip
from mcm_tpu_torch.parallel import EvalStep
from mcm_tpu_torch.scores.clip_scores import l2_normalize
from mcm_tpu_torch.text import CLIPTokenizer, build_prompts
from mcm_tpu_torch.text.prompts import DEFAULT_TEMPLATE, OPENAI_IMAGENET_TEMPLATES
from mcm_tpu_torch.utils import Telemetry, save_scores, setup_log
from mcm_tpu_torch.utils.plotting import plot_distribution
from mcm_tpu_torch.utils.results import save_as_dataframe
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
    """Raise for every option of the JAX runner this slice does not port."""
    todo = []
    if cfg.score == "maha":
        todo.append("--score maha: ROADMAP.md Queue 1, item 10")
    if cfg.score == "odin":
        todo.append("--score odin: ROADMAP.md Queue 1, item 11")
    if cfg.model == "vit-Linear":
        todo.append("--model vit-Linear: ROADMAP.md Queue 1, item 12")
    if cfg.model == "CLIP-Linear":
        todo.append("--model CLIP-Linear: ROADMAP.md Queue 1, item 14")
    if cfg.resume:
        todo.append("--resume: ROADMAP.md Queue 1, item 8")
    if cfg.eval_accuracy:
        todo.append("--eval_accuracy: ROADMAP.md Queue 1, item 8")
    if cfg.fast_decode:
        todo.append("--fast_decode (native decoder): ROADMAP.md Queue 1, "
                    "item 6")
    if cfg.model_parallel > 1 or (cfg.n_devices or 1) > 1:
        todo.append("--model_parallel / --n_devices > 1: ROADMAP.md Queue 1, "
                    "item 15")
    if cfg.trace_dir:
        todo.append("--trace_dir: ROADMAP.md Queue 1, item 7")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))
    if cfg.model != "CLIP":
        raise ValueError(f"unknown --model {cfg.model!r}")


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


def build_model_and_step(cfg: RunConfig, log=None):
    """Resolve weights + tokenizer and build the eval step; returns the
    model on the step's device, the tokenizer and the step."""
    check_ported(cfg)
    clip_cfg = CLIP_CONFIGS[cfg.clip_ckpt]()
    precision = resolve_precision(cfg.precision)

    derived_dim = CLIP_FEAT_DIMS.get(cfg.clip_ckpt)
    if (cfg.feat_dim is not None and derived_dim is not None
            and cfg.feat_dim != derived_dim):
        warnings.warn(
            f"--feat_dim {cfg.feat_dim} contradicts {cfg.clip_ckpt}'s "
            f"feature dim {derived_dim}; the dim is derived from the "
            f"checkpoint and the flag value is ignored")

    params = resolve_clip_params(cfg.clip_ckpt, cfg.ckpt_dir)
    if log is not None and params is not None:
        # record WHICH weight file fed this run: the CSVs key on flags only
        log.debug(f"weights resolved from "
                  f"{file_identity(resolve_clip_weight_source(cfg.clip_ckpt, cfg.ckpt_dir))}")
    if params is None:
        if not cfg.allow_random_weights:
            raise FileNotFoundError(
                f"no pretrained weights for {cfg.clip_ckpt}; set "
                f"MCM_TPU_CKPT_DIR (or --ckpt_dir) to a directory holding "
                f"the converted .npz, or pass --allow_random_weights for "
                f"smoke runs")
        warnings.warn("RANDOM WEIGHTS in use — scores are meaningless; "
                      "this mode is for smoke/throughput tests only")
        params = init_clip(0, clip_cfg)

    tokenizer = CLIPTokenizer.resolve(cfg.ckpt_dir)
    if tokenizer is None:
        if not cfg.allow_random_weights:
            raise FileNotFoundError(
                "no CLIP vocab.json/merges.txt found; set MCM_TPU_CKPT_DIR")
        warnings.warn("hash-fallback tokenizer in use (no CLIP vocab found)")
        tokenizer = _HashTokenizer(clip_cfg.text.vocab_size)

    step = EvalStep(clip_cfg, score=cfg.score, T=cfg.T, precision=precision,
                    device=cfg.device)
    return step.put_params(params), tokenizer, step


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
        text = l2_normalize(text.reshape(n_t, n_c, -1).mean(dim=0))
    return text


class _StreamReadback:
    """One-batch-behind host readback: batch i+1 is queued on the device
    while batch i's result comes back."""

    def __init__(self, telemetry: Optional[Telemetry] = None,
                 depth: int = 1):
        self._tel = telemetry or Telemetry()
        self._depth = depth
        self._pending: List[torch.Tensor] = []
        self.out: List[np.ndarray] = []

    def push(self, device_value: torch.Tensor) -> None:
        self._pending.append(device_value)
        self._drain(self._depth)

    def finish(self) -> List[np.ndarray]:
        self._drain(0)
        return self.out

    def _drain(self, limit: int) -> None:
        while len(self._pending) > limit:
            with self._tel.stage("readback"):
                self.out.append(self._pending.pop(0).cpu().numpy())


def _make_pipe(dataset, cfg: RunConfig,
               drop_remainder: bool = False) -> DataPipeline:
    return DataPipeline(dataset, cfg.batch_size, image_size=cfg.image_size,
                        num_workers=cfg.num_workers, prefetch=cfg.prefetch,
                        drop_remainder=drop_remainder)


def _stream_pass(step, dispatch, dataset, cfg: RunConfig,
                 telemetry: Optional[Telemetry] = None,
                 drop_remainder: bool = False,
                 collect_labels: bool = False):
    """The shared device-streaming loop (decode → H2D → dispatch →
    one-batch-behind readback → dataset-order assembly).
    ``dispatch(images)`` is the per-batch device call."""
    from mcm_tpu_torch.data.pipeline import collect_scores

    tel = telemetry or Telemetry()
    pipe = _make_pipe(dataset, cfg, drop_remainder)
    stream = _StreamReadback(tel)
    valids: List[int] = []
    labels: List[np.ndarray] = []
    for batch in pipe:
        with tel.stage("h2d"):
            images = step.put_batch(batch.images)
        with tel.stage("dispatch"):
            out = dispatch(images)
        stream.push(out)  # drains the previous batch under stage("readback")
        valids.append(batch.valid)
        if collect_labels:
            labels.append(batch.labels)
        tel.add_images(batch.valid)
    total = (len(pipe) * cfg.batch_size if drop_remainder
             else pipe.num_samples)
    total = min(total, sum(valids)) if valids else 0
    outs = collect_scores(stream.finish(), valids, total)
    if collect_labels:
        return outs, collect_scores(labels, valids, total)
    return outs


def score_dataset(step: EvalStep, params, dataset, text_feats,
                  cfg: RunConfig,
                  telemetry: Optional[Telemetry] = None) -> np.ndarray:
    """Stream a dataset through the score step (the reference keeps the
    final partial batch for every CLIP score — ``detection_util.py:249``
    truncates, never drops)."""
    return _stream_pass(step, lambda im: step.score(params, im, text_feats),
                        dataset, cfg, telemetry)


def run_eval(cfg: RunConfig) -> Dict[str, Dict[str, float]]:
    """Full evaluation (reference ``main``, ``eval_ood_detection.py:53-99``).

    Returns {out_dataset: {FPR95, AUROC, AUPR}} plus an "AVG" row."""
    check_ported(cfg)
    resolve_device(cfg.device)   # no card and no --device cpu: fail first
    setup_seed(cfg.seed)
    os.makedirs(cfg.log_directory, exist_ok=True)
    log = setup_log(cfg.log_directory, cfg.name)
    telemetry = Telemetry()

    params, tokenizer, step = build_model_and_step(cfg, log)
    out_datasets = cfg.out_datasets or default_out_datasets(cfg.in_dataset)
    # fail a typo'd --out_datasets before the ID pass
    validate_out_datasets(out_datasets)

    val_ds = set_val_loader(cfg.in_dataset, cfg.root_dir)
    test_labels = get_test_labels(cfg.in_dataset, val_ds)
    text_feats = _encode_prompts(step, params, tokenizer, test_labels,
                                 cfg.template_ensemble)

    def scores_for(dataset, ds_name):
        s = score_dataset(step, params, dataset, text_feats, cfg, telemetry)
        save_scores(cfg.log_directory, ds_name, s)
        return s

    with maybe_profile(cfg.trace_dir):
        in_score = scores_for(val_ds, f"ID_{cfg.in_dataset}")

    auroc_list: List[float] = []
    aupr_list: List[float] = []
    fpr_list: List[float] = []
    results: Dict[str, Dict[str, float]] = {}
    for out_dataset in out_datasets:
        log.debug(f"Evaluting OOD dataset {out_dataset}")  # sic (reference)
        ood_ds = set_ood_loader(out_dataset, cfg.root_dir)
        out_score = scores_for(ood_ds, out_dataset)
        from scipy import stats
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
    log.debug(telemetry.report())
    return results
