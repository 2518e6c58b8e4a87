"""The device layout of a run: a grid of ``data`` × ``model`` devices.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with a
``data`` axis (batch sharding) and a ``model`` axis (Megatron tensor
parallelism) (``mcm_tpu/parallel/mesh.py``): a row of its ``(n/T, T)``
grid is ``T`` consecutive devices, a *data group*, which together hold one
copy of the model, each device a ``1/T`` shard of its layers.  The port
keeps that layout in two forms, and :func:`make_mesh`, the one function its
callers call, picks between them:

* the *local form* (:func:`make_local_mesh`): one process drives every
  data group of ``n`` of its own devices, and the step splits every batch
  into one stripe per group.  This is JAX's single-process mesh, and the
  form of every run started without a launcher: the eval CLIs, training,
  serving, the bench and the dry run;
* the *process form*, under ``python -m torch.distributed.run``: each
  process drives one data group, and the data axis is the world size of
  the ``torch.distributed`` group (:mod:`.multihost`).

With a model axis of 1 a group is one device holding a whole replica.
Above 1, :func:`shard_params` splits the layers as :func:`clip_param_specs`
says (column-parallel ``wq/wk/wv/w1``, row-parallel ``wo/w2``) and
:mod:`.tensor` runs the forward over the shards.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mcm_tpu_torch.config import resolve_device
from mcm_tpu_torch.parallel import multihost

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape[DATA_AXIS]`` × ``shape[MODEL_AXIS]`` devices.  ``groups`` are
    the data groups this process drives, each the ``model`` devices of one
    copy of the model in shard order (the local form holds ``data`` groups,
    the process form one);
    ``devices`` are the groups' first devices, where each group's stripe of
    a batch and its results live; ``device`` is the first of them."""

    data: int
    model: int
    device: torch.device
    groups: Tuple[Tuple[torch.device, ...], ...] = ()

    def __post_init__(self):
        if not self.groups:
            object.__setattr__(self, "groups", ((self.device,),))

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(g[0] for g in self.groups)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def describe(self) -> str:
        """The grid and this process's devices, group by group, e.g.
        ``data 1 × model 2 on cuda:0, cuda:0``."""
        on = " | ".join(", ".join(str(d) for d in g) for g in self.groups)
        return f"data {self.data} × model {self.model} on {on}"


def _not_divisible(n: int, model_parallel: int) -> ValueError:
    return ValueError(f"{n} devices not divisible by "
                      f"model_parallel={model_parallel}")


def _group_devices(device, model_parallel: int) -> Tuple[torch.device, ...]:
    """This rank's data group: ``cuda`` is cards ``LOCAL_RANK·T …
    LOCAL_RANK·T + T-1``, ``cuda:K`` puts every shard on card K, ``cpu``
    is ``T`` CPU devices."""
    if model_parallel == 1:
        return (multihost.rank_device(device),)
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return (dev,) * model_parallel
    first = int(os.environ.get("LOCAL_RANK", "0")) * model_parallel
    visible = torch.cuda.device_count()
    if first + model_parallel > visible:
        raise RuntimeError(
            f"model_parallel={model_parallel} on local rank "
            f"{first // model_parallel} needs cards {first} … "
            f"{first + model_parallel - 1} but {visible} card(s) are "
            f"visible: launch fewer processes, or pass --device cuda:K to "
            f"put every shard on card K")
    return tuple(torch.device("cuda", first + j)
                 for j in range(model_parallel))


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device="cuda", entry: str = "mcm_tpu_torch.cli.eval_ood"
              ) -> Mesh:
    """The run's mesh, ``n_devices`` devices in data groups of
    ``model_parallel``, as JAX's ``make_mesh`` lays them out.

    With no process group up it is the local form
    (:func:`make_local_mesh`): ``cuda`` is cards ``0 … n-1``, ``cuda:K``
    puts every device of the mesh on card K, ``cpu`` gives ``n`` CPU
    devices; ``n_devices`` None or 0 means every visible card (JAX's None:
    every visible device), or ``model_parallel`` devices on ``cuda:K`` and
    on the CPU.  Under a launched group it is the process form: this rank's
    data group, and ``n_devices`` (None or 0: the world size ×
    ``model_parallel``) must equal the world size × ``model_parallel``.
    Neither form goes on over fewer devices than asked for: the errors name
    ``--device cuda:K``, or the launch line of ``entry``, the module run."""
    world = multihost.process_count()
    if world == 1:
        dev = resolve_device(device)
        every_card = dev.type == "cuda" and dev.index is None
        n = n_devices or (torch.cuda.device_count() if every_card
                          else model_parallel)
        return make_local_mesh(n, model_parallel, device)
    n = n_devices or world * model_parallel
    if n % model_parallel:
        raise _not_divisible(n, model_parallel)
    procs = n // model_parallel
    if procs != world:
        tp = f" --model_parallel {model_parallel}" if model_parallel > 1 else ""
        launch = (f"python -m torch.distributed.run --standalone "
                  f"--nproc_per_node {procs} -m {entry} ... --n_devices {n}"
                  f"{tp}")
        raise ValueError(
            f"--n_devices {n} differs from the world size {world}"
            f"{f' × model_parallel {model_parallel}' if tp else ''} of the "
            f"process group; launch {procs} processes with: {launch} (or "
            f"leave --n_devices unset)")
    group = _group_devices(device, model_parallel)
    return Mesh(world, model_parallel, group[0], groups=(group,))


def one_device(device="cuda") -> Mesh:
    """A mesh of this process's one device (JAX's ``make_mesh(1)``, the step
    classes' default): ``cuda`` is ``cuda:LOCAL_RANK`` (card 0 without a
    launcher), ``cuda:K`` card K."""
    return Mesh(1, 1, multihost.rank_device(device))


def make_local_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
                    device="cuda") -> Mesh:
    """One process over ``n_devices`` devices (JAX's single-process mesh),
    ``model_parallel`` consecutive devices a data group.  ``n_devices``
    None or 0: every visible card (``model_parallel`` devices on the CPU).
    ``device="cuda"``: cards ``0 … n-1``, and more than are visible raises;
    ``"cuda:K"``: all ``n`` on card K; ``"cpu"``: ``n`` devices on the CPU.
    Inside a process group of more than one rank it raises: this form is
    one process."""
    if multihost.process_count() > 1:
        raise ValueError(
            f"a single-process mesh inside a process group of "
            f"{multihost.process_count()} ranks: serving and the bench run "
            f"in one process over its local devices (n_devices); start them "
            f"without torch.distributed.run")
    dev = resolve_device(device)
    n = int(n_devices or (torch.cuda.device_count() if dev.type == "cuda"
                          else model_parallel))
    if n < 1:
        raise ValueError(f"n_devices={n}: no device is visible on {device!r}")
    if dev.type == "cuda" and dev.index is None:
        visible = torch.cuda.device_count()
        if n > visible:
            raise ValueError(
                f"n_devices={n} but {visible} card(s) are visible; pass at "
                f"most {visible}, or --device cuda:K (device='cuda:K') to "
                f"put every replica on card K")
        devices = tuple(torch.device("cuda", k) for k in range(n))
    else:
        devices = (dev,) * n
    if n % model_parallel:
        raise _not_divisible(n, model_parallel)
    groups = tuple(devices[i:i + model_parallel]
                   for i in range(0, n, model_parallel))
    return Mesh(n // model_parallel, model_parallel, devices[0],
                groups=groups)


# -- tensor parallelism ------------------------------------------------------------

def validate_tp(cfg, mesh: Mesh) -> None:
    """Fail fast when the model axis cannot evenly split the towers (JAX's
    check and message): the shards split attention by head and the MLP by
    its hidden dim, so ``model_parallel`` must divide the heads, the width
    and the MLP hidden width of each tower (L/14's 12 text heads refuse
    T = 8 although its 16 vision heads divide)."""
    tp = mesh.shape[MODEL_AXIS]
    if tp == 1:
        return
    for tower_name in ("vision", "text"):
        tower = getattr(cfg, tower_name, None)
        if tower is None:
            continue
        hidden = tower.width * tower.mlp_ratio
        for dim_name, value in (("heads", tower.heads),
                                ("width", tower.width),
                                ("mlp hidden dim", hidden)):
            if value % tp:
                raise ValueError(
                    f"model_parallel={tp} does not divide the {tower_name} "
                    f"tower's {dim_name} ({value}) for config "
                    f"{getattr(cfg, 'name', cfg)}; choose a tp that divides "
                    f"every sharded dim")


def _layer_specs() -> Dict[str, Any]:
    """The split axis of each stacked layer leaf ``[L, ...]``: column-parallel
    ``wq/wk/wv/w1`` split their output features (axis 2, heads × head_dim
    or the MLP hidden dim) and their biases with them (axis 1); row-parallel
    ``wo/w2`` split their input features (axis 1); ``bo``, ``b2`` and the
    LayerNorms are whole (``None``)."""
    return {
        "ln1": {"scale": None, "bias": None},
        "attn": {"wq": 2, "wk": 2, "wv": 2, "wo": 1,
                 "bq": 1, "bk": 1, "bv": 1, "bo": None},
        "ln2": {"scale": None, "bias": None},
        "mlp": {"w1": 2, "b1": 1, "w2": 1, "b2": None},
    }


def clip_param_specs() -> Dict[str, Any]:
    """The split axis of every leaf of ``init_clip``'s tree (the same tree),
    or ``None`` for a leaf every shard group keeps whole: the port's
    counterpart of JAX's ``PartitionSpec`` tree."""
    return {
        "vision": {
            "patch_embed": None, "class_emb": None, "pos_emb": None,
            "pre_ln": {"scale": None, "bias": None},
            "layers": _layer_specs(),
            "post_ln": {"scale": None, "bias": None},
            "proj": None,
        },
        "text": {
            "token_emb": None, "pos_emb": None,
            "layers": _layer_specs(),
            "final_ln": {"scale": None, "bias": None},
            "proj": None,
        },
        "logit_scale": None,
    }


def _shard_tree(tree: Dict[str, Any], specs: Dict[str, Any], j: int,
                tp: int) -> Dict[str, Any]:
    """Shard ``j``'s leaves: slice ``j`` of ``tp`` equal contiguous slices
    of each split leaf; shard 0 also keeps every whole leaf (the residual
    stream, the LayerNorms, the embeddings and the projections run on the
    group's first device), the others hold only their slices."""
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        spec = specs[key]
        if isinstance(value, dict):
            sub = _shard_tree(value, spec, j, tp)
            if sub:
                out[key] = sub
        elif spec is not None:
            out[key] = np.split(np.asarray(value), tp, axis=spec)[j]
        elif j == 0:
            out[key] = value
    return out


def shard_params(params: Dict[str, Any], mesh: Mesh,
                 dtype: torch.dtype = torch.float32,
                 trainable: bool = False) -> List["ShardedCLIP"]:
    """The numpy parameter tree → one :class:`~.tensor.ShardedCLIP` per data
    group of ``mesh``, shard ``j`` on the group's device ``j``.  Splitting
    the columns of ``wq`` contiguously gives shard ``j`` the heads ``j·H/T
    … (j+1)·H/T - 1``, the head split JAX's partitioner makes.  ``dtype``
    and ``trainable`` as in
    :func:`~mcm_tpu_torch.models.convert.from_jax_params`."""
    from mcm_tpu_torch.parallel.tensor import ShardedCLIP
    specs = clip_param_specs()
    return [ShardedCLIP([_shard_tree(params, specs, j, len(group))
                         for j in range(len(group))], group, dtype,
                        trainable) for group in mesh.groups]


def _unshard_tree(trees: Sequence[Dict[str, Any]], specs: Dict[str, Any]):
    out: Dict[str, Any] = {}
    for key, value in trees[0].items():
        spec = specs[key]
        if isinstance(value, dict):
            out[key] = _unshard_tree([t[key] for t in trees if key in t],
                                     spec)
        elif spec is not None:
            out[key] = np.concatenate([t[key] for t in trees], axis=spec)
        else:
            out[key] = value
    return out


def unshard_params(model: "ShardedCLIP") -> Dict[str, Any]:
    """The inverse of :func:`shard_params`: one group's shards → the whole
    numpy tree (fp32, ``init_clip``'s keys and shapes), on the host."""
    from mcm_tpu_torch.models.convert import to_jax_params
    return _unshard_tree([to_jax_params(s) for s in model.shards],
                         clip_param_specs())


def split_axis(name: str) -> Optional[int]:
    """The split axis of the leaf at the dotted ``name`` (``named_parameters``
    form, e.g. ``vision.layers.attn.wq``)."""
    spec: Any = clip_param_specs()
    for part in name.split("."):
        spec = spec[part]
    return spec
