"""One rank of a two-process data-parallel fine-tune of the port on the CPU.

Started by ``python -m torch.distributed.run --standalone --nproc_per_node
2`` from ``tests/test_torch_dp_train_procs.py``:

    python -m torch.distributed.run ... test_torch_dp_train_worker.py <spec.json>

It joins the gloo group (``multihost.initialize``) and runs, in order:

* ``train_clip`` on the spec's tiny config in parity mode, two epochs of a
  global batch of 8, ``ckpt_path`` set (run ``a``), recording every step's
  loss, the log lines this rank wrote and the checkpoint writes it made;
* the same run in two parts, one epoch then ``resume=True`` to two
  (run ``b``);
* the ``finetune_clip`` CLI with ``--n_devices 2 --device cpu`` on the
  spec's pet37 tree (the tiny ViT-B/16 double).

Each rank writes its final parameters of ``a`` and ``b`` to
``<out>.rank<r>.<run>.npz`` and a report ``<out>.rank<r>.json``.
"""

import json
import sys
import warnings


def _tiny_cfg(spec):
    from mcm_tpu_torch.config import CLIPConfig, TextConfig, VisionConfig
    return CLIPConfig(name="tiny", vision=VisionConfig(**spec["vision"]),
                      text=TextConfig(**spec["text"]))


def _run(spec, **over):
    """``train_clip`` with this rank's losses, log lines and writes kept."""
    import numpy as np

    from mcm_tpu_torch.config import Precision
    from mcm_tpu_torch.data.folder import ImageFolder
    from mcm_tpu_torch.runner import _HashTokenizer
    from mcm_tpu_torch.train import loop

    losses, logs = [], []
    make = loop.make_train_step

    def recording(*args, **kwargs):
        init_state, step = make(*args, **kwargs)

        def recorded(*step_args):
            state, loss = step(*step_args)
            losses.append(float(loss))
            return state, loss

        recorded.comm_s = 0.0
        return init_state, recorded

    loop.make_train_step = recording
    try:
        state = loop.train_clip(
            _tiny_cfg(spec), ImageFolder(spec["tree"]), spec["class_names"],
            _HashTokenizer(512), batch_size=8, seed=3, device="cpu",
            image_size=32, num_workers=1, precision=Precision.parity(),
            label_permutation=np.array(spec["label_permutation"]),
            log=logs.append, **over)
    finally:
        loop.make_train_step = make
    return state, losses, logs


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)

    import numpy as np

    from mcm_tpu_torch.models import convert
    from mcm_tpu_torch.parallel import multihost
    from mcm_tpu_torch.train import loop

    started = multihost.initialize("cpu")
    rank = multihost.process_index()
    writes = {"params": 0, "train_state": 0}
    save_params, save_state = loop.save_params, loop.save_train_state

    def counting(kind, fn):
        def f(*a, **k):
            writes[kind] += 1
            return fn(*a, **k)
        return f

    loop.save_params = counting("params", save_params)
    loop.save_train_state = counting("train_state", save_state)
    report = {"rank": rank, "world": multihost.process_count(), "runs": {}}
    try:
        a, losses, logs = _run(spec, epochs=2, ckpt_path=spec["ckpt_a"])
        report["runs"]["a"] = {"losses": losses, "logs": logs,
                               "step": a.step, "writes": dict(writes)}
        _run(spec, epochs=1, ckpt_path=spec["ckpt_b"])
        b, losses, logs = _run(spec, epochs=2, ckpt_path=spec["ckpt_b"],
                               resume=True)
        report["runs"]["b"] = {"losses": losses, "logs": logs,
                               "step": b.step}
    finally:
        loop.save_params, loop.save_train_state = save_params, save_state
    for name, state in (("a", a), ("b", b)):
        np.savez(f"{spec['out']}.rank{rank}.{name}.npz",
                 **convert._flatten(convert.to_jax_params(state.params)))

    from mcm_tpu_torch.tools import finetune_clip
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        report["finetune_out"] = finetune_clip.main(spec["finetune_argv"])
    with open(f"{spec['out']}.rank{rank}.json", "w") as f:
        json.dump(report, f)
    if started:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
