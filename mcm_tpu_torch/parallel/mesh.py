"""The device layout of an evaluation: one process per card.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with a
``data`` axis (batch sharding) and a ``model`` axis (tensor parallelism)
(``mcm_tpu/parallel/mesh.py``).  In the port each process drives one card,
so the mesh a process sees is small: the data axis is the world size of the
``torch.distributed`` group (:mod:`.multihost`), the model axis is 1, and
the device is this rank's card.  Tensor parallelism (``validate_tp``,
``clip_param_specs``, ``shard_params``) is ``ROADMAP.md`` Queue 1, item 9b.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mcm_tpu_torch.parallel import multihost

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape[DATA_AXIS]`` processes (one card each) × ``shape[MODEL_AXIS]``
    = 1; ``device`` is this process's card."""

    data: int
    model: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device="cuda") -> Mesh:
    """This process's mesh.  ``n_devices`` None or 0 means the world size
    (JAX's None: every visible device); any other count must equal it:
    a run never goes on over fewer devices than asked for."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: tensor parallelism is not "
            f"ported yet: ROADMAP.md Queue 1, item 9b")
    world = multihost.process_count()
    n = n_devices or world
    if n != world:
        launch = (f"python -m torch.distributed.run --standalone "
                  f"--nproc_per_node {n} -m mcm_tpu_torch.cli.eval_ood ... "
                  f"--n_devices {n}")
        if world == 1:
            raise ValueError(
                f"--n_devices {n} asks for {n} processes, one per card, but "
                f"no process group is up; launch them with: {launch}")
        raise ValueError(
            f"--n_devices {n} differs from the world size {world} of the "
            f"process group; launch {n} processes with: {launch} (or leave "
            f"--n_devices unset)")
    return Mesh(world, 1, multihost.rank_device(device))
