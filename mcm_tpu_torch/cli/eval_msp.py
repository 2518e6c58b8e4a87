#!/usr/bin/env python
"""Supervised-ViT MSP baseline evaluation — PyTorch/CUDA CLI.

    python -m mcm_tpu_torch.cli.eval_msp --in_dataset ImageNet \
        --ckpt_dir checkpoints [--device cpu]

The pure-visual baseline MCM is compared against (reference README's
google/vit-base-patch16-224 + MSP configuration; logits path as in
``utils/detection_util.py:124-133``).  The same flags, results layout and
CSV as the JAX package's ``mcm_tpu/cli/eval_msp.py``, plus ``--device
cuda|cuda:K|cpu`` (default ``cuda``, which raises without a card).  It
shares the runner's vit-Linear machinery: weight resolution, one upload of
the parameters, the score step and the streaming score pass, and with it
data parallelism.  As the JAX CLI, it has no ``--n_devices`` and runs
over every visible device: one process over every visible card
(``--device cuda``; one device on ``cuda:K`` and on the CPU), each batch
split into one stripe per card; or one process a card under the launcher
(``python -m torch.distributed.run --standalone --nproc_per_node N -m
mcm_tpu_torch.cli.eval_msp ...``), where rank 0 logs and writes.

Weights: an HF ``ViTForImageClassification`` snapshot directory
``<ckpt_dir>/vit-base-patch16-224/`` (``model.safetensors`` or
``pytorch_model.bin``) or its converted ``vit-base-patch16-224.npz``.
``--allow_random_weights`` smoke-runs without weights.
"""

import argparse

import numpy as np

from mcm_tpu_torch.cli.eval_ood import device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="MSP baseline (supervised ViT) OOD evaluation "
                    "(PyTorch/CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--in_dataset", default="ImageNet", type=str,
                   choices=["ImageNet", "ImageNet10", "ImageNet20",
                            "ImageNet100", "pet37", "food101", "car196",
                            "bird200", "flower102"])
    p.add_argument("--root-dir", default="datasets", type=str)
    p.add_argument("--name", default="eval_msp", type=str)
    p.add_argument("--seed", default=5, type=int)
    p.add_argument("-b", "--batch-size", default=512, type=int)
    p.add_argument("--T", type=float, default=1.0)
    p.add_argument("--score", default="MCM", type=str,
                   choices=["MCM", "energy", "max-logit", "entropy", "var"],
                   help="MCM == max-softmax (MSP) over classifier logits")
    p.add_argument("--ckpt_dir", default=None, type=str)
    p.add_argument("--allow_random_weights", action="store_true")
    p.add_argument("--out_datasets", default=None, type=str, nargs="+")
    p.add_argument("--num_workers", default=None, type=int)
    p.add_argument("--device", default="cuda", type=device_arg,
                   help="cuda (every visible card; under the launcher "
                        "this rank's card), cuda:K or cpu (only when asked "
                        "for)")
    return p


def main(argv=None) -> str:
    """Run the evaluation; returns the results directory."""
    args = build_parser().parse_args(argv)
    from mcm_tpu_torch.parallel import multihost
    with multihost.launched(args.device):
        return _evaluate(args)


def _evaluate(args) -> str:
    from mcm_tpu_torch.data import (default_out_datasets, set_ood_loader,
                                    set_val_loader, validate_out_datasets)
    from mcm_tpu_torch.metrics import get_and_print_results, print_measures
    from mcm_tpu_torch.parallel import multihost
    from mcm_tpu_torch.runner import (RunConfig, _rank0_log,
                                      build_model_and_step, score_dataset)
    from mcm_tpu_torch.utils import Telemetry, setup_seed
    from mcm_tpu_torch.utils.results import save_as_dataframe

    setup_seed(args.seed)
    log_directory = (f"results/{args.in_dataset}/MSP_{args.score}/"
                     f"vit_T_{args.T}_ID_{args.name}")
    log = _rank0_log(log_directory, args.name)

    cfg = RunConfig(in_dataset=args.in_dataset, root_dir=args.root_dir,
                    name=args.name, seed=args.seed,
                    batch_size=args.batch_size, T=float(args.T),
                    model="vit-Linear", score=args.score,
                    ckpt_dir=args.ckpt_dir, device=args.device,
                    allow_random_weights=args.allow_random_weights,
                    num_workers=args.num_workers)
    params, _, step = build_model_and_step(cfg, log)
    telemetry = Telemetry()

    out_datasets = args.out_datasets or default_out_datasets(args.in_dataset)
    validate_out_datasets(out_datasets)  # fail typos before scoring

    val_ds = set_val_loader(args.in_dataset, args.root_dir)
    in_score = score_dataset(step, params, val_ds, None, cfg, telemetry)
    out_scores = [score_dataset(step, params,
                                set_ood_loader(ds, args.root_dir), None, cfg,
                                telemetry) for ds in out_datasets]
    if multihost.process_index() == 0:   # every rank holds every score
        auroc_list, aupr_list, fpr_list = [], [], []
        for out_dataset, out_score in zip(out_datasets, out_scores):
            log.debug(f"Evaluting OOD dataset {out_dataset}")  # sic
            # the shared helper owns the lower-is-ID double negation
            get_and_print_results(args, log, in_score, out_score, auroc_list,
                                  aupr_list, fpr_list,
                                  method_name=f"MSP-{args.score}")
        print_measures(log, float(np.mean(auroc_list)),
                       float(np.mean(aupr_list)), float(np.mean(fpr_list)),
                       "MSP-mean")
        save_as_dataframe(log_directory, args.name, out_datasets, fpr_list,
                          auroc_list, aupr_list)
        log.debug(telemetry.report())
    multihost.barrier()   # the CSV is written before any rank returns
    return log_directory


if __name__ == "__main__":
    main()
