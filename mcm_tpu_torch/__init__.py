"""mcm_tpu_torch — the PyTorch/CUDA port of mcm_tpu.

Zero-shot OOD detection with frozen CLIP encoders and concept-matching
scores (MCM / energy / max-logit / entropy / variance), exact AUROC / AUPR
/ FPR95 metrics and the same CLI surface, on one NVIDIA H100.  The JAX
package ``mcm_tpu`` is the reference this package is held against; the two
share no code.  Hot-path kernels are hand-written CUDA under ``csrc/``.
"""

__version__ = "0.1.0"
