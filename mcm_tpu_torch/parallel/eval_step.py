"""The per-batch device program: uint8 batch → normalize → encode → score.

Everything the reference hot loop does on the device per batch
(``utils/detection_util.py:220-248`` minus the per-batch text re-encode,
which is hoisted out and cached): uint8 → float normalize, the ViT
forward, and the fused L2-normalize → class matmul → score reduction.  The
only host↔device traffic per batch is uint8 pixels in (through pinned
memory, asynchronously) and one fp32 score per image out.
:class:`VitLinearStep` is the same for the supervised ViT + linear head
(``--model vit-Linear``).  A step is bound to its process's card (the
mesh's device); under a launched group each process runs these per-batch
programs on its stripe of every batch (:mod:`.multihost`), ODIN included,
as JAX's ``shard_map`` runs it per shard.

On a single-process mesh of several devices (the local form of
:func:`~.mesh.make_mesh`: the eval CLIs without a launcher, serving, the
bench) both step classes hold one replica of the model on each data group
(:class:`Replicated`), split every batch into contiguous equal stripes
(:class:`Striped`, JAX's batch-sharding order), launch the program of
every stripe on its device before any result is read, and :func:`to_host`
joins the stripes' results back in row order.  With one device nothing is
split: the step passes and returns plain tensors.

On a mesh whose model axis is above 1 each data group holds a
:class:`~.tensor.ShardedCLIP` (its first device receives the group's
stripe and returns its result) and the towers run over the shards
(:mod:`.tensor`).  As in JAX (``mcm_tpu/parallel/eval_step.py:84-122``)
such a mesh runs the math paths: ``attn_impl="auto"`` becomes ``"xla"``, a
forced kernel raises, and the score takes its torch path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mcm_tpu_torch.config import (CLIPConfig, Precision, SupervisedViTConfig,
                                  apply_matmul_policy)
from mcm_tpu_torch.data.transforms import (CLIP_MEAN, CLIP_STD, IMAGENET_MEAN,
                                           IMAGENET_STD, normalize_on_device)
from mcm_tpu_torch.models import clip as tclip
from mcm_tpu_torch.models import vit as tvit
from mcm_tpu_torch.models.convert import from_jax_params
from mcm_tpu_torch.ops.mcm_score import fused_mcm_scores
from mcm_tpu_torch.parallel import tensor as ttensor
from mcm_tpu_torch.parallel.mesh import (MODEL_AXIS, Mesh, one_device,
                                         shard_params, validate_tp)
from mcm_tpu_torch.scores.clip_scores import (CLIP_SCORES, _scores_from_logits,
                                              ieee_fp32_matmul, l2_normalize)
from mcm_tpu_torch.scores.mahalanobis import mahalanobis_score
from mcm_tpu_torch.scores.odin import clip_odin_logits_fn, odin_perturb

#: rows of ODIN's gradient pass at a time.  The pass keeps the fp32
#: autograd graph of its rows: 24,686,236,160 bytes at B = 128 on CLIP
#: ViT-B/16 (NVIDIA H100 80GB HBM3), so the CLI's default -b 512 in one pass
#: would not fit on an 80 GB card.  A per-image gradient couples no rows and
#: sign(grad) is invariant under the mean's positive scale, so the
#: sub-batches give the answer JAX's per-shard mean gives.
ODIN_GRAD_ROWS = 128


def _odin_perturb_rows(logits_fn, x: torch.Tensor, noise_magnitude: float,
                       std) -> torch.Tensor:
    """:func:`odin_perturb` over ``x`` in row sub-batches of at most
    :data:`ODIN_GRAD_ROWS`, each its own gradient pass."""
    return torch.cat([odin_perturb(logits_fn, x[i:i + ODIN_GRAD_ROWS],
                                   noise_magnitude, std=std)
                      for i in range(0, x.shape[0], ODIN_GRAD_ROWS)])


def _odin_safe(precision: Precision) -> Precision:
    """Precision policy for ODIN programs: the ε-nudge (~0.005 in
    normalized-pixel space) is AT the bf16 ULP for |x|≥1, so fast-mode
    activations quantize it away; and no hand-written kernel has a
    backward.  fp32 + the math paths match the fp32 reference
    (``detection_util.py:122-146``).  ``softmax_dtype`` is pinned fp32
    too: the gradient flows back through the [B, H, S, S] probabilities,
    and bf16 rounding there flips gradient signs near zero — the one
    place sign(grad) is the entire signal."""
    return dataclasses.replace(precision, activation_dtype=torch.float32,
                               softmax_dtype=torch.float32,
                               attn_impl="xla", mlp_impl="xla")


def _tp_routing(precision: Precision, mesh: Mesh) -> Precision:
    """JAX's routing on a tensor-parallel mesh, where its Pallas kernels
    would be opaque to the partitioner: the towers take the math paths, so
    ``attn_impl="auto"`` becomes ``"xla"`` and a forced kernel raises with
    JAX's message."""
    if mesh.shape[MODEL_AXIS] == 1:
        return precision
    if precision.attn_impl == "auto":
        precision = dataclasses.replace(precision, attn_impl="xla")
    forced = ([f"attn_impl={precision.attn_impl!r}"]
              if precision.attn_impl != "xla" else [])
    if precision.mlp_impl == "pallas":
        forced.append(f"mlp_impl={precision.mlp_impl!r}")
    if forced:
        raise ValueError(
            f"{', '.join(forced)} cannot run on a tensor-parallel mesh "
            f"(model axis = {mesh.shape[MODEL_AXIS]}): pallas_call is opaque "
            f"to the SPMD partitioner, which would all-gather the TP-sharded "
            f"layer weights around it. Use attn_impl/mlp_impl 'auto' or "
            f"'xla', or a pure-DP mesh.")
    return precision


class _PerDevice(tuple):
    """One tensor (or model) per device of a local mesh, in device order."""


class Replicated(_PerDevice):
    """The same value on every device: the model, text features, the
    Mahalanobis templates."""


class Striped(_PerDevice):
    """A batch split into contiguous equal stripes of rows, stripe ``i`` on
    device ``i``: the stripes in order are the batch."""


def to_host(x) -> np.ndarray:
    """A step's result → host numpy, the barrier of a device result: the
    stripes of a :class:`Striped` result joined in row order, the first
    copy of a :class:`Replicated` one."""
    if isinstance(x, Striped):
        return np.concatenate([to_host(s) for s in x])
    if isinstance(x, Replicated):
        return to_host(x[0])
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _over_stripes(fn, *args, **kwargs) -> Striped:
    """``fn`` once per device of a local mesh: a :class:`_PerDevice`
    argument gives call ``i`` its ``i``-th entry, any other argument goes to
    every call.  The calls only launch device work (nothing reads a result
    back), so every stripe is queued on its device before any is read."""
    n = len(next(a for a in args if isinstance(a, _PerDevice)))
    return Striped(fn(*(a[i] if isinstance(a, _PerDevice) else a
                        for a in args), **kwargs) for i in range(n))


def _h2d(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A pinned host tensor → ``device`` without blocking (the CPU keeps
    it)."""
    if device.type == "cuda":
        return t.to(device, non_blocking=True)
    return t


class _Placement:
    """Host → device placement shared by the step classes (requires
    ``self.mesh`` and ``self.device``)."""

    def put_batch(self, images_u8: np.ndarray):
        """uint8 [B, H, W, 3] host batch → device, through pinned memory
        with a non-blocking copy.  ``pin_memory`` copies into a fresh
        pinned buffer, so the caller may reuse ``images_u8`` at once, and
        PyTorch's caching host allocator keeps that buffer until the copy
        completes.  On a local mesh of ``n`` devices: :class:`Striped`, B/n
        rows on each (B must divide)."""
        t = torch.from_numpy(np.ascontiguousarray(images_u8))
        devices = self.mesh.devices
        if any(d.type == "cuda" for d in devices):
            t = t.pin_memory()
        if len(devices) == 1:
            return _h2d(t, self.device)
        n = len(devices)
        if t.shape[0] % n:
            raise ValueError(f"a batch of {t.shape[0]} rows does not split "
                             f"over the {n} devices of the mesh")
        b = t.shape[0] // n
        return Striped(_h2d(t[i * b:(i + 1) * b], d)
                       for i, d in enumerate(devices))

    def put_replicated(self, x):
        """A host array → each device of the mesh (one tensor on one)."""
        arr = np.asarray(x)
        if len(self.mesh.devices) == 1:
            return torch.as_tensor(arr, device=self.device)
        return Replicated(torch.as_tensor(arr, device=d)
                          for d in self.mesh.devices)


class EvalStep(_Placement):
    """Per-batch eval programs bound to this process's card (``mesh.device``;
    without a mesh, :func:`~.mesh.one_device` on ``device``), or to each
    device of a local mesh (``mesh.devices``: the model, templates and text
    features :class:`Replicated`, batches and results :class:`Striped`).

    ``score(params, images_u8, text_feats)``   → [B] fp32 OOD scores
    ``features(params, images_u8)``            → [B, D] image features
    ``maha(features, mean, precision_mat)``    → [B] Mahalanobis scores
    ``encode_text(params, ids, mask)``         → [C, D] normalized prompts

    ``score="odin"`` perturbs each batch against the gradient of its own
    pseudo-label NLL (``noise_magnitude``), in row sub-batches of at most
    :data:`ODIN_GRAD_ROWS`, and scores it with MCM, all under
    :func:`_odin_safe`'s precision.
    """

    def __init__(self, cfg: CLIPConfig, score: str = "MCM", T: float = 1.0,
                 precision: Precision = Precision.fast(), device="cuda",
                 noise_magnitude: float = 0.0014,
                 mesh: Optional[Mesh] = None):
        if score not in CLIP_SCORES + ("odin",):
            raise ValueError(f"unknown score {score!r}")
        self.mesh = mesh if mesh is not None else one_device(device)
        validate_tp(cfg, self.mesh)
        # ODIN's override first: it routes to the math paths anyway, so a
        # forced kernel with score="odin" is overridden on every mesh
        if score == "odin":
            precision = _odin_safe(precision)
        precision = _tp_routing(precision, self.mesh)
        self.tensor_parallel = self.mesh.shape[MODEL_AXIS] > 1
        self.cfg = cfg
        self.score_name = score
        self.T = float(T)
        self.noise_magnitude = float(noise_magnitude)
        self.precision = precision
        self.device = self.mesh.device
        apply_matmul_policy(precision)

    # -- device placement ------------------------------------------------------

    def put_params(self, params):
        """Host parameter tree → the model on this step's device, matrices
        stored in the activation dtype (a :class:`Replicated` copy on each
        device of a local mesh; on a tensor-parallel mesh each data group's
        :class:`~.tensor.ShardedCLIP`)."""
        dtype = self.precision.activation_dtype
        if self.tensor_parallel:
            groups = shard_params(params, self.mesh, dtype)
            return groups[0] if len(groups) == 1 else Replicated(groups)
        if len(self.mesh.devices) == 1:
            return from_jax_params(params, self.device, dtype)
        return Replicated(from_jax_params(params, d, dtype)
                          for d in self.mesh.devices)

    # -- per-batch programs ----------------------------------------------------

    def _encode_image(self, params, x: torch.Tensor) -> torch.Tensor:
        """The vision tower (over the shards of a tensor-parallel model)."""
        return ttensor.encode_image(params, self.cfg.vision, x,
                                    self.precision)

    @torch.inference_mode()
    def features(self, params: tclip.CLIP,
                 images_u8: torch.Tensor) -> torch.Tensor:
        if isinstance(images_u8, Striped):
            return _over_stripes(self.features, params, images_u8)
        x = normalize_on_device(images_u8, CLIP_MEAN, CLIP_STD,
                                dtype=self.precision.activation_dtype)
        return self._encode_image(params, x).float()

    def score(self, params: tclip.CLIP, images_u8: torch.Tensor,
              text_feats: torch.Tensor,
              impl: Optional[str] = None) -> torch.Tensor:
        """[B] fp32 scores; ``impl`` picks the score path as in
        :func:`mcm_tpu_torch.ops.mcm_score.fused_mcm_scores` (on a
        tensor-parallel mesh, unless given, its torch path, as JAX's)."""
        if impl is None and self.tensor_parallel:
            impl = "xla"
        if isinstance(images_u8, Striped):
            return _over_stripes(self.score, params, images_u8, text_feats,
                                 impl=impl)
        if self.score_name == "odin":
            return self._odin_score(params, images_u8, text_feats, impl)
        with torch.inference_mode():
            feats = self.features(params, images_u8)
            return fused_mcm_scores(feats, text_feats, self.score_name,
                                    self.T, impl=impl)

    def _odin_score(self, params: tclip.CLIP, images_u8: torch.Tensor,
                    text_feats: torch.Tensor,
                    impl: Optional[str]) -> torch.Tensor:
        """ODIN input preprocessing (reference ``detection_util.py:122-146``):
        nudge the normalized pixels against the NLL gradient sign (row
        sub-batches), then score the perturbed batch with temperature-scaled
        max-softmax.  :func:`odin_perturb` builds its graph outside inference
        mode; only the final encode and score run in it."""
        x = normalize_on_device(images_u8, CLIP_MEAN, CLIP_STD,
                                dtype=self.precision.activation_dtype)
        logits_fn = clip_odin_logits_fn(
            lambda xi: self._encode_image(params, xi), text_feats, self.T)
        x = _odin_perturb_rows(logits_fn, x, self.noise_magnitude, CLIP_STD)
        with torch.inference_mode():
            feats = self._encode_image(params, x).float()
            return fused_mcm_scores(feats, text_feats, "MCM", self.T,
                                    impl=impl)

    @torch.inference_mode()
    def maha(self, features: torch.Tensor, classwise_mean: torch.Tensor,
             precision_mat: torch.Tensor,
             normalize: bool = False) -> torch.Tensor:
        """[B] Mahalanobis scores of image features against the class
        means and shared precision matrix (lower = more ID)."""
        if isinstance(features, Striped):
            return _over_stripes(self.maha, features, classwise_mean,
                                 precision_mat, normalize=normalize)
        return mahalanobis_score(features, classwise_mean, precision_mat,
                                 normalize=normalize)

    # -- text side (run once per dataset) --------------------------------------

    @torch.inference_mode()
    def encode_text(self, params: tclip.CLIP, input_ids: np.ndarray,
                    attention_mask: np.ndarray,
                    batch_size: int = 1024) -> torch.Tensor:
        """Encode + L2-normalize all class prompts → [C, D] fp32 on the
        device.  The tail batch is padded to the lead batch shape, as in
        the JAX package (padding rows are dropped).  On a local mesh the
        first replica (or data group) encodes them and each group's first
        device gets a copy, so every replica scores against the same
        bits."""
        if isinstance(params, Replicated):
            text = self.encode_text(params[0], input_ids, attention_mask,
                                    batch_size)
            return Replicated(text.to(d) for d in self.mesh.devices)
        outs = []
        n = input_ids.shape[0]
        for lo in range(0, n, batch_size):
            ids = input_ids[lo:lo + batch_size]
            mask = attention_mask[lo:lo + batch_size]
            pad = 0
            if lo > 0 and ids.shape[0] < batch_size:
                pad = batch_size - ids.shape[0]
                ids = np.pad(ids, ((0, pad), (0, 0)))
                mask = np.pad(mask, ((0, pad), (0, 0)))
            f = ttensor.encode_text(
                params, self.cfg.text,
                torch.from_numpy(np.asarray(ids, np.int64)).to(self.device),
                torch.from_numpy(np.asarray(mask, np.int64)).to(self.device),
                self.precision)
            f = l2_normalize(f).float()
            outs.append(f[:f.shape[0] - pad] if pad else f)
        return torch.cat(outs, dim=0)


class VitLinearStep(_Placement):
    """Supervised ViT + linear head through the standard score family.

    The reference's ``vit-Linear`` configuration
    (``utils/detection_util.py:124-133``): image features = CLS token of
    the last hidden state, logits = linear classifier over them, scored by
    the same max-softmax / energy / … family from the logits (no MCM
    kernel: it takes image and text features).  The same interface subset
    as :class:`EvalStep` (``put_*``, ``score``, ``features``), so the
    runner streams batches identically; ``features`` returns the clean
    classifier *logits*, the substrate every score and the accuracy meter
    derive from.  Data-parallel only: ``model_parallel > 1``, or a mesh
    whose model axis is above 1, raises, as in the JAX package.  On a local
    mesh of several devices the model is :class:`Replicated` and batches
    and results :class:`Striped`, as :class:`EvalStep`'s; ODIN's gradient
    pass runs per stripe, in row sub-batches of :data:`ODIN_GRAD_ROWS`.
    """

    def __init__(self, cfg: SupervisedViTConfig, score: str = "MCM",
                 T: float = 1.0, precision: Precision = Precision.fast(),
                 device="cuda", noise_magnitude: float = 0.0014,
                 model_parallel: int = 1, mesh: Optional[Mesh] = None):
        if score not in CLIP_SCORES + ("odin",):
            raise ValueError(f"unknown score {score!r}")
        self.mesh = mesh if mesh is not None else one_device(device)
        if model_parallel != 1 or self.mesh.shape[MODEL_AXIS] != 1:
            raise ValueError("--model vit-Linear runs data-parallel only; "
                             "use --model_parallel 1")
        if score == "odin":
            precision = _odin_safe(precision)
        self.cfg = cfg
        self.score_name = score
        self.T = float(T)
        self.noise_magnitude = float(noise_magnitude)
        self.precision = precision
        self.device = self.mesh.device
        apply_matmul_policy(precision)

    def put_params(self, params) -> tvit.SupervisedViT:
        """Host parameter tree → the model on this step's device, matrices
        stored in the activation dtype (a :class:`Replicated` copy on each
        device of a local mesh)."""
        dtype = self.precision.activation_dtype
        if len(self.mesh.devices) == 1:
            return tvit.from_jax_vit_params(params, self.device, dtype)
        return Replicated(tvit.from_jax_vit_params(params, d, dtype)
                          for d in self.mesh.devices)

    def _normalize(self, images_u8: torch.Tensor) -> torch.Tensor:
        return normalize_on_device(images_u8, IMAGENET_MEAN, IMAGENET_STD,
                                   dtype=self.precision.activation_dtype)

    @torch.inference_mode()
    def features(self, params: tvit.SupervisedViT,
                 images_u8: torch.Tensor) -> torch.Tensor:
        """[B, num_classes] fp32 clean logits (ODIN perturbs scoring only)."""
        if isinstance(images_u8, Striped):
            return _over_stripes(self.features, params, images_u8)
        return tvit.forward_logits(params, self.cfg, self._normalize(images_u8),
                                   self.precision)

    def score(self, params: tvit.SupervisedViT, images_u8: torch.Tensor,
              text_feats=None) -> torch.Tensor:
        """[B] fp32 scores from the logits.  ``score="odin"`` perturbs the
        normalized pixels against the gradient of the pseudo-label NLL of
        ``logits / T`` first (outside inference mode, IEEE fp32 products on
        the math paths, row sub-batches), then scores with max-softmax."""
        if isinstance(images_u8, Striped):
            return _over_stripes(self.score, params, images_u8)
        if self.score_name != "odin":
            with torch.inference_mode():
                return _scores_from_logits(self.features(params, images_u8),
                                           self.T)[self.score_name]
        x = self._normalize(images_u8)

        def logits_fn(xi):
            return tvit.forward_logits(params, self.cfg, xi,
                                       self.precision) / self.T

        # Reference quirk kept: input_preprocessing scales the gradient
        # sign by the CLIP std for EVERY model — the ``std=(0.26862954,
        # ...)`` at ``detection_util.py:141-143`` is hardcoded even on the
        # vit-Linear branch, whose pixels were normalized with 0.5.
        with ieee_fp32_matmul():   # forward and backward: sign(grad)
            x = _odin_perturb_rows(logits_fn, x, self.noise_magnitude,
                                   CLIP_STD)
        with torch.inference_mode(), ieee_fp32_matmul():
            logits = tvit.forward_logits(params, self.cfg, x, self.precision)
            return _scores_from_logits(logits, self.T)["MCM"]
