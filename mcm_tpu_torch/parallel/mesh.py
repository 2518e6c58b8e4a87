"""The device layout of a run: one process per card, or one process over
several devices.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with a
``data`` axis (batch sharding) and a ``model`` axis (tensor parallelism)
(``mcm_tpu/parallel/mesh.py``).  The port has two forms of it:

* :func:`make_mesh`, the eval CLIs' and training's: each process drives one
  card, the data axis is the world size of the ``torch.distributed`` group
  (:mod:`.multihost`), and ``device`` is this rank's card;
* :func:`make_local_mesh`, serving's and the bench's: one process holds a
  replica of the model on each of ``n`` devices (``devices``), the data
  axis is ``n``, and the step splits every batch into ``n`` stripes.

The model axis is 1 in both.  Tensor parallelism (``validate_tp``,
``clip_param_specs``, ``shard_params``) is ``ROADMAP.md`` Queue 1, item 9b.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mcm_tpu_torch.config import resolve_device
from mcm_tpu_torch.parallel import multihost

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape[DATA_AXIS]`` × ``shape[MODEL_AXIS]`` = 1.  ``devices`` are the
    devices this process drives (one per replica; the process form holds
    only its card); ``device`` is the first of them."""

    data: int
    model: int
    device: torch.device
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        if not self.devices:
            object.__setattr__(self, "devices", (self.device,))

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def _refuse_tp(model_parallel: int) -> None:
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: tensor parallelism is not "
            f"ported yet: ROADMAP.md Queue 1, item 9b")


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device="cuda", entry: str = "mcm_tpu_torch.cli.eval_ood"
              ) -> Mesh:
    """This process's mesh.  ``n_devices`` None or 0 means the world size
    (JAX's None: every visible device); any other count must equal it:
    a run never goes on over fewer devices than asked for, and the error
    names the launch line of ``entry``, the module run."""
    _refuse_tp(model_parallel)
    world = multihost.process_count()
    n = n_devices or world
    if n != world:
        launch = (f"python -m torch.distributed.run --standalone "
                  f"--nproc_per_node {n} -m {entry} ... --n_devices {n}")
        if world == 1:
            raise ValueError(
                f"--n_devices {n} asks for {n} processes, one per card, but "
                f"no process group is up; launch them with: {launch}")
        raise ValueError(
            f"--n_devices {n} differs from the world size {world} of the "
            f"process group; launch {n} processes with: {launch} (or leave "
            f"--n_devices unset)")
    return Mesh(world, 1, multihost.rank_device(device))


def make_local_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
                    device="cuda") -> Mesh:
    """One process over ``n_devices`` devices (JAX's single-process mesh of
    serving and the bench).  ``n_devices`` None or 0: every visible card
    (one replica on the CPU).  ``device="cuda"``: cards ``0 … n-1``, and
    more than are visible raises; ``"cuda:K"``: ``n`` replicas on card K;
    ``"cpu"``: ``n`` replicas on the CPU.  Inside a process group of more
    than one rank it raises: this form is one process."""
    _refuse_tp(model_parallel)
    if multihost.process_count() > 1:
        raise ValueError(
            f"a single-process mesh inside a process group of "
            f"{multihost.process_count()} ranks: serving and the bench run "
            f"in one process over its local devices (n_devices); start them "
            f"without torch.distributed.run")
    dev = resolve_device(device)
    n = int(n_devices or (torch.cuda.device_count() if dev.type == "cuda"
                          else 1))
    if n < 1:
        raise ValueError(f"n_devices={n}: no device is visible on {device!r}")
    if dev.type == "cuda" and dev.index is None:
        visible = torch.cuda.device_count()
        if n > visible:
            raise ValueError(
                f"n_devices={n} but {visible} card(s) are visible; pass at "
                f"most {visible}, or device='cuda:K' to put every replica "
                f"on card K")
        devices = tuple(torch.device("cuda", k) for k in range(n))
    else:
        devices = (dev,) * n
    return Mesh(n, 1, devices[0], devices)
