#!/usr/bin/env python
"""Zero-shot OOD detection evaluation — PyTorch/CUDA CLI.

    python -m mcm_tpu_torch.cli.eval_ood --in_dataset ImageNet \
        --CLIP_ckpt ViT-B/16 --score MCM [--device cpu]

The same argument surface as the JAX package's CLI, which is
argument-compatible with the reference entry point
(``eval_ood_detection.py:15-51``).  Known surface quirks are preserved
deliberately: ``--normalize/--generate/--subset`` use ``type=bool`` (any
non-empty string parses True — the reference's argparse footgun at
``:40-43``).

``--device cuda|cuda:K|cpu`` (default ``cuda``) picks the device; without
a card the CLI raises unless ``--device cpu`` is given.  The reference's ``--gpu``
flag is accepted and ignored; ``--feat_dim`` is accepted for compatibility
but derived from the checkpoint.  Every score runs, ``maha`` (templates
from the ID train split under ``--template_dir``, estimated with
``--generate``, or read from there) and ``odin`` included, as do
``--eval_accuracy``, ``--resume`` and ``--trace_dir`` (a ``torch.profiler``
Chrome trace of the ID pass).  ``--model CLIP-Linear`` runs the CLIP
path on the whole fine-tuned tree in ``--finetune_ckpt``
(``python -m mcm_tpu_torch.tools.finetune_clip`` writes one).  ``--model
vit-Linear`` scores the supervised ViT's classifier logits (weights under
``--ckpt_dir``, a probe head through ``--finetune_ckpt``).  Images decode
through the native libjpeg decoder (``MCM_TPU_DISABLE_NATIVE=1``: PIL);
``--fast_decode`` (its DCT-prescaled mode) raises where the native decoder
is unavailable.

Data parallel, in one process over N of its devices, as the JAX CLI runs
(each batch split into one stripe per device, a model replica on each)::

    python -m mcm_tpu_torch.cli.eval_ood ... --n_devices N

``--device cuda`` takes cards 0 … N-1 (more than are visible raises),
``--device cuda:K`` puts all N replicas on card K, ``--device cpu`` N CPU
devices; ``--n_devices`` unset means every visible card.  Or one process
per card, under the launcher::

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m mcm_tpu_torch.cli.eval_ood ... --n_devices N

Each rank runs on ``cuda:LOCAL_RANK`` (``--device cuda:K`` puts every rank
on card K) and scores its stripe of every batch; rank 0 writes the results.
Under the launcher ``--n_devices`` unset means the world size; any other
value must equal it.

Tensor parallel, ``--model_parallel T``: each data group is ``T`` devices
(one process: consecutive cards, or every shard on ``cuda:K``; under the
launcher, each rank's: ``cuda`` is cards ``LOCAL_RANK·T … LOCAL_RANK·T +
T-1``), so ``--n_devices N --model_parallel T`` runs ``N/T`` data groups
of ``T`` shards in one process, and ``--nproc_per_node`` is ``N / T``
under the launcher.  The towers run over the shards on the math paths, as
JAX routes them (a forced kernel raises).
"""

import argparse
import re


class _RecordExplicit(argparse.Action):
    """Store the value AND the fact it was given on the command line.

    ``--feat_dim`` keeps the reference's default (512) for surface
    compatibility, but the value is derived from the checkpoint unless the
    user passed it explicitly — argparse can't distinguish "default" from
    "typed the default", and scanning ``sys.argv`` misses the abbreviated
    prefixes argparse accepts (``--feat 768``), so the action records it at
    parse time."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)
        setattr(namespace, f"_{self.dest}_explicit", True)


def device_arg(value: str) -> str:
    """``--device``: ``cuda``, ``cuda:K`` or ``cpu``."""
    if not re.fullmatch(r"cpu|cuda(:\d+)?", value):
        raise argparse.ArgumentTypeError(
            f"invalid device {value!r}: cuda, cuda:K or cpu")
    return value


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluates MCM Score for CLIP (PyTorch/CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    # -- reference-compatible surface (eval_ood_detection.py:15-51) ----------
    parser.add_argument("--in_dataset", default="ImageNet", type=str,
                        choices=["ImageNet", "ImageNet10", "ImageNet20",
                                 "ImageNet100", "pet37", "food101", "car196",
                                 "bird200", "flower102"],
                        help="in-distribution dataset")
    parser.add_argument("--root-dir", default="datasets", type=str,
                        help="root dir of datasets")
    parser.add_argument("--name", default="eval_ood", type=str,
                        help="unique ID for the run")
    parser.add_argument("--seed", default=5, type=int, help="random seed")
    parser.add_argument("--gpu", default=0, type=int,
                        help="accepted for compatibility; ignored (see --device)")
    parser.add_argument("-b", "--batch-size", default=512, type=int,
                        help="mini-batch size")
    parser.add_argument("--T", type=int, default=1,
                        help="temperature parameter")
    parser.add_argument("--model", default="CLIP", type=str,
                        help="model architecture")
    parser.add_argument("--CLIP_ckpt", type=str, default="ViT-B/16",
                        choices=["ViT-B/32", "ViT-B/16", "ViT-L/14",
                                 "ViT-bigG/14"],
                        help="which pretrained img encoder to use "
                             "(ViT-bigG/14: OpenCLIP's, erf GELU)")
    parser.add_argument("--score", default="MCM", type=str,
                        choices=["MCM", "energy", "max-logit", "entropy",
                                 "var", "maha", "odin"],
                        help="score options (odin: input-preprocessed MSP — "
                             "vestigial in the reference, invocable here)")
    parser.add_argument("--noiseMagnitude", default=0.0014, type=float,
                        help="ODIN perturbation magnitude (the flag the "
                             "reference reads but never registers)")
    # Mahalanobis flags (quirky type=bool kept for drop-in compatibility)
    parser.add_argument("--feat_dim", type=int, default=512,
                        action=_RecordExplicit,
                        help="compat only; derived from --CLIP_ckpt")
    parser.add_argument("--normalize", type=bool, default=False,
                        help="use normalized features for Maha score")
    parser.add_argument("--generate", type=bool, default=True,
                        help="generate class-wise means or read from files")
    parser.add_argument("--template_dir", type=str, default="img_templates",
                        help="location of stored classwise mean/precision")
    parser.add_argument("--subset", default=False, type=bool,
                        help="use a subset of the training set")
    parser.add_argument("--max_count", default=250, type=int,
                        help="samples per class for mean/precision estimate")
    # -- extensions -----------------------------------------------------------
    parser.add_argument("--device", default="cuda", type=device_arg,
                        help="cuda (cards 0 … n_devices-1; under the "
                             "launcher this rank's card, cuda:LOCAL_RANK), "
                             "cuda:K (every device or rank on card K) or "
                             "cpu (only when asked for)")
    parser.add_argument("--precision", default="fast", type=str,
                        choices=["fast", "parity", "bf16", "fp32"],
                        help="bf16 fast path vs fp32 parity path")
    parser.add_argument("--model_parallel", default=1, type=int,
                        help="tensor-parallel size: the devices each "
                             "data group splits the towers' layers over")
    parser.add_argument("--n_devices", default=None, type=int,
                        help="devices of the run, model_parallel a data "
                             "group: without a launcher, N devices of this "
                             "process (default: every visible card); or "
                             "one process a data group under python -m "
                             "torch.distributed.run --standalone "
                             "--nproc_per_node N/model_parallel -m "
                             "mcm_tpu_torch.cli.eval_ood ... --n_devices N "
                             "(default: the world size × model_parallel)")
    parser.add_argument("--num_workers", default=None, type=int,
                        help="host decode threads")
    parser.add_argument("--prefetch", default=2, type=int,
                        help="prefetched batches")
    parser.add_argument("--resume", action="store_true",
                        help="reuse cached per-dataset score arrays")
    parser.add_argument("--template_ensemble", action="store_true",
                        help="80-template prompt ensembling")
    parser.add_argument("--ckpt_dir", default=None, type=str,
                        help="dir with converted .npz or HF snapshot")
    parser.add_argument("--allow_random_weights", action="store_true",
                        help="smoke/throughput runs without checkpoints")
    parser.add_argument("--trace_dir", default=None, type=str,
                        help="torch.profiler trace of the ID pass")
    parser.add_argument("--eval_accuracy", action="store_true",
                        help="also log ID zero-shot top-1/top-5 accuracy")
    parser.add_argument("--fast_decode", action="store_true",
                        help="DCT-prescaled JPEG decode (throughput mode)")
    parser.add_argument("--finetune_ckpt", default=None, type=str,
                        help="fine-tuned .npz weights for --model "
                             "CLIP-Linear; a probe head {w, b} for "
                             "--model vit-Linear")
    parser.add_argument("--out_datasets", default=None, type=str, nargs="+",
                        help="override the default OOD set list")
    return parser


def process_args(argv=None):
    return build_parser().parse_args(argv)


def main(argv=None):
    args = process_args(argv)
    from mcm_tpu_torch.parallel import multihost
    from mcm_tpu_torch.runner import RunConfig, run_eval

    cfg = RunConfig(
        in_dataset=args.in_dataset,
        root_dir=args.root_dir,
        name=args.name,
        seed=args.seed,
        batch_size=args.batch_size,
        T=float(args.T),
        model=args.model,
        clip_ckpt=args.CLIP_ckpt,
        score=args.score,
        # forward only an EXPLICIT --feat_dim: the argparse default (512,
        # the reference's) would false-positive the contradiction warning
        # on every L/14 run where the dim is correctly derived as 768
        feat_dim=(args.feat_dim
                  if getattr(args, "_feat_dim_explicit", False) else None),
        normalize=bool(args.normalize),
        generate=bool(args.generate),
        template_dir=args.template_dir,
        subset=bool(args.subset),
        max_count=args.max_count,
        precision=args.precision,  # aliases resolved by resolve_precision
        device=args.device,
        model_parallel=args.model_parallel,
        n_devices=args.n_devices,
        num_workers=args.num_workers,
        prefetch=args.prefetch,
        resume=args.resume,
        template_ensemble=args.template_ensemble,
        ckpt_dir=args.ckpt_dir,
        allow_random_weights=args.allow_random_weights,
        out_datasets=args.out_datasets,
        trace_dir=args.trace_dir,
        eval_accuracy=args.eval_accuracy,
        fast_decode=args.fast_decode,
        finetune_ckpt=args.finetune_ckpt,
        noise_magnitude=args.noiseMagnitude,
    )
    with multihost.launched(cfg.device):
        return run_eval(cfg)


if __name__ == "__main__":
    main()
