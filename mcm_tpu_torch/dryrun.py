"""The multi-device dry run: every parallel program family once, at tiny
shapes (the JAX package's ``__graft_entry__.py::dryrun_multichip``).

On a local mesh of ``n`` devices (``model_parallel`` 2 when ``n`` is even):

* the train step over the whole ``n/T × T`` grid: the batch split over
  the data groups, each group's towers split over its devices, the
  gradients summed into the first group's
  (:func:`~mcm_tpu_torch.train.contrastive.make_train_step`);
* eval/MCM with the trained weights on the same grid;
* on the ``n × 1`` grid: eval/MCM, features → Mahalanobis and the ODIN
  gradient pass.

Every output must be finite.  JAX's ahead-of-time lowering of the ViT-B/16
program has no counterpart: ``chip_smoke.py``'s full-width tensor-parallel
run stands in for it.

    python -c "from mcm_tpu_torch.dryrun import dryrun_multichip as d; d(4, 'cpu')"
"""

from __future__ import annotations

import numpy as np

from mcm_tpu_torch.config import CLIPConfig, Precision, TextConfig, VisionConfig
from mcm_tpu_torch.models.init import init_clip
from mcm_tpu_torch.parallel.eval_step import EvalStep, to_host
from mcm_tpu_torch.parallel.mesh import make_local_mesh
from mcm_tpu_torch.parallel.tensor import host_tree
from mcm_tpu_torch.train.contrastive import make_train_step

TINY = CLIPConfig(
    name="tiny",
    vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=2,
                        heads=4, projection_dim=32),
    text=TextConfig(vocab_size=128, context_length=16, width=64, layers=2,
                    heads=4, projection_dim=32),
)


def _finite(name: str, x) -> np.ndarray:
    arr = to_host(x)
    if not np.isfinite(arr).all():
        raise FloatingPointError(f"dryrun: non-finite {name}: {arr}")
    return arr


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """Run the programs on ``n_devices`` devices of ``device`` (``cuda``:
    cards ``0 … n-1``; ``cuda:K``: all on card K; ``cpu``); prints and
    returns one line naming the grids."""
    tp = 2 if n_devices % 2 == 0 else 1
    mesh = make_local_mesh(n_devices, tp, device=device)
    precision = Precision.fast()
    rng = np.random.default_rng(0)
    batch = n_devices * 2
    images = rng.integers(0, 256, size=(batch, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1, 100, size=(batch, 16)).astype(np.int32)
    ids[:, -1] = 127
    mask = np.ones_like(ids)
    text = rng.standard_normal((10, 32)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)

    # the train step over the grid: DP batch split × TP shards
    init_state, train_step = make_train_step(TINY, precision=precision,
                                             mesh=mesh)
    state, loss = train_step(init_state(init_clip(0, TINY)), images, ids,
                             mask)
    loss = float(_finite("train loss", loss))
    trained = host_tree(state.params)

    step = EvalStep(TINY, score="MCM", precision=precision, mesh=mesh)
    _finite("DP×TP scores", step.score(step.put_params(trained),
                                       step.put_batch(images),
                                       step.put_replicated(text)))

    dp_mesh = make_local_mesh(n_devices, 1, device=device)
    dp_step = EvalStep(TINY, score="MCM", precision=precision, mesh=dp_mesh)
    dp_params = dp_step.put_params(trained)
    _finite("DP scores", dp_step.score(dp_params, dp_step.put_batch(images),
                                       dp_step.put_replicated(text)))
    feats = dp_step.features(dp_params, dp_step.put_batch(images))
    mu = rng.standard_normal((10, 32)).astype(np.float32)
    _finite("maha", dp_step.maha(feats, dp_step.put_replicated(mu),
                                 dp_step.put_replicated(
                                     np.eye(32, dtype=np.float32))))
    odin_step = EvalStep(TINY, score="odin", precision=precision,
                         mesh=dp_mesh)
    _finite("odin", odin_step.score(odin_step.put_params(trained),
                                    odin_step.put_batch(images),
                                    odin_step.put_replicated(text)))
    line = (f"dryrun_multichip({n_devices}): grids=({n_devices // tp}x{tp}, "
            f"{n_devices}x1) on {device} programs=(train loss={loss:.4f} "
            f"over the {n_devices // tp}x{tp} grid, eval/MCM, "
            f"features+maha, odin grad) ok")
    print(line)
    return line
