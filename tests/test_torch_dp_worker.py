"""One rank of a two-process data-parallel run of the port on the CPU.

Launched by ``tests/test_torch_dp_procs.py`` with the environment a
launcher sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``):

    python test_torch_dp_worker.py <spec.json>

It joins the gloo group (``multihost.initialize``), then for each run of
the spec calls the port's eval CLI (``mcm_tpu_torch.cli.eval_ood.main``,
which leaves the group it did not start up) with:

* ``chunk_bytes``: ``multihost.ASSEMBLE_CHUNK_BYTES`` for the run (1: one
  batch per all-gather);
* ``forbid_device``: ``EvalStep``'s device entry points raise (a fully
  cached ``--resume`` must not reach them);
* ``fail``: this rank raises inside the run instead (the launch must end
  non-zero on every rank, not hang).

It records the local batch sizes each run put on its device and, with
``assemble``, gathers a truncating ``total`` straight through
``assemble_global_outputs`` (one batch per all-gather, so the chunks past
``total`` join the lockstep), then writes ``<out>.rank<r>.json``.
"""

import json
import sys


def _patched(step_cls, forbid: bool, shapes: list):
    """Replace ``step_cls``'s device entry points; returns the originals."""
    names = ("put_batch", "put_params", "put_replicated", "encode_text")
    saved = {n: getattr(step_cls, n) for n in names}

    def forbidden(name):
        def f(*a, **k):
            raise AssertionError(f"EvalStep.{name} reached on a cached resume")
        return f

    def put_batch(self, images_u8):
        shapes.append(int(images_u8.shape[0]))
        return saved["put_batch"](self, images_u8)

    for n in names:
        setattr(step_cls, n, forbidden(n) if forbid else saved[n])
    if not forbid:
        step_cls.put_batch = put_batch
    return saved


def _assemble_check():
    """Three batches of 8 rows (a float column pair and int labels), each
    rank holding its stripe; ``total`` 10 keeps rows of the first two."""
    import numpy as np

    from mcm_tpu_torch.parallel import multihost

    B, n_batches, total = 8, 3, 10
    feats = np.arange(B * n_batches * 2, dtype=np.float32).reshape(-1, 2)
    labels = np.arange(B * n_batches, dtype=np.int32) * 3
    lo, hi = multihost.batch_stripe(B)
    outs = [feats[i * B + lo:i * B + hi] for i in range(n_batches)]
    labs = [labels[i * B + lo:i * B + hi] for i in range(n_batches)]
    valids = [B] * n_batches
    got_f = multihost.assemble_global_outputs(outs, valids, total,
                                              chunk_bytes=1)
    got_l = multihost.assemble_global_outputs(labs, valids, total,
                                              chunk_bytes=1)
    return {"features": got_f.tolist(), "labels": got_l.tolist()}


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)

    from mcm_tpu_torch.cli.eval_ood import main as eval_ood
    from mcm_tpu_torch.parallel import EvalStep, multihost

    started = multihost.initialize("cpu")
    rank = multihost.process_index()
    report = {"rank": rank, "world": multihost.process_count(),
              "runs": []}
    default_chunk = multihost.ASSEMBLE_CHUNK_BYTES
    for run in spec["runs"]:
        if rank in run.get("fail", []):
            raise RuntimeError(f"rank {rank} fails on purpose")
        multihost.ASSEMBLE_CHUNK_BYTES = (run.get("chunk_bytes")
                                          or default_chunk)
        shapes: list = []
        saved = _patched(EvalStep, run.get("forbid_device", False), shapes)
        try:
            results = eval_ood(run["argv"])
        finally:
            for n, fn in saved.items():
                setattr(EvalStep, n, fn)
            multihost.ASSEMBLE_CHUNK_BYTES = default_chunk
        report["runs"].append({"batch_rows": shapes, "results": results})
    if spec.get("assemble"):
        report["assemble"] = _assemble_check()
    with open(f"{spec['out']}.rank{rank}.json", "w") as f:
        json.dump(report, f)
    if started:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
