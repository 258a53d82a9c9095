"""The ``(data, model)`` device mesh on ``torch.distributed`` (port of
``ssd_tpu/parallel/mesh.py``).

One process drives one device (``torchrun``: ``python -m
torch.distributed.run --nproc-per-node N -m ssd_tpu_torch.training.train
...``). The mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` of
shape ``(data, model)`` with ``model`` innermost, so the tensor-parallel
ranks of a data group are neighbours (one host, NVLink). The shape follows
the JAX package's ``make_mesh``: ``data`` defaults to ``world // model``,
and the same ``ValueError``\\ s reject what does not divide.

:func:`maybe_initialize_distributed` starts the process group when the
process is one rank of a launch (torchrun's ``RANK`` / ``WORLD_SIZE``, the
JAX package's ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``,
Slurm, Open MPI): NCCL on the card, gloo on the CPU. Unlike the JAX
package, a failed initialization raises — a rank that carried on alone
would train a different model than the one asked for.

:class:`ParallelContext` is what the model, the loader and the trainer
read: the process groups of the two axes, this rank's place on them, the
``sequence`` and ``fsdp`` switches and the rank's device.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: Optional[int] = None, model: int = 1, world: int = 1) -> Tuple[int, int]:
    """The ``(data, model)`` shape over ``world`` devices, with the JAX
    package's errors: ``data`` defaults to ``world // model``."""
    n = int(world)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}×{model} != {n} devices")
    return int(data), int(model)


def mesh_shape_from_config(cfg: Optional[Mapping[str, Any]], world: int) -> Tuple[int, int]:
    """``parallel: {data: auto|int, model: int}`` → the mesh shape."""
    par = (cfg or {}).get("parallel", {}) or {}
    model = int(par.get("model", 1))
    data = par.get("data", "auto")
    data = None if data in (None, "auto") else int(data)
    return make_mesh(data=data, model=model, world=world)


def mesh_from_config(cfg: Optional[Mapping[str, Any]], world: Optional[int] = None,
                     device_type: str = "cuda"):
    """The ``(data, model)`` ``DeviceMesh`` of the running process group, or
    ``None`` in a single process without one (after the same shape checks:
    ``parallel.model: 2`` in one process raises as ``make_mesh`` does with
    one device)."""
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    data, model = mesh_shape_from_config(cfg, world)
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def pad_batch_to_multiple(tree: Dict[str, np.ndarray], multiple: int):
    """Pad every array's leading axis with zeros up to a multiple of
    ``multiple``. Returns ``(padded_tree, real_size)``."""
    if not tree:
        return tree, 0
    b = next(iter(tree.values())).shape[0]
    target = ((b + multiple - 1) // multiple) * multiple
    if target == b:
        return tree, b
    return {k: np.pad(v, [(0, target - b)] + [(0, 0)] * (v.ndim - 1)) for k, v in tree.items()}, b


def _int(env: Mapping[str, str], key: str, default: int = 1) -> int:
    try:
        return int(env.get(key, default))
    except ValueError:
        return default


def torchrun_launch(env: Optional[Mapping[str, str]] = None) -> bool:
    """Whether torchrun (or a launcher with its contract) started this
    process: ``RANK`` and ``WORLD_SIZE`` both set, at any world size."""
    env = os.environ if env is None else env
    return bool(env.get("RANK")) and bool(env.get("WORLD_SIZE"))


def multihost_launch_detected(env: Optional[Mapping[str, str]] = None) -> bool:
    """True when the process looks like one rank of a multi-process launch:
    the JAX package's markers that a CUDA launch can set
    (``COORDINATOR_ADDRESS``, ``JAX_COORDINATOR_ADDRESS``, ``SLURM_NTASKS``
    or ``OMPI_COMM_WORLD_SIZE`` above 1) or torchrun's ``RANK`` /
    ``WORLD_SIZE``. The TPU runtime's markers are not read."""
    env = os.environ if env is None else env
    if torchrun_launch(env):
        return True
    if any(env.get(k) for k in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")):
        return True
    return any(_int(env, k) > 1 for k in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"))


@dataclass(frozen=True)
class LaunchInfo:
    rank: int
    world: int
    local_rank: int
    local_world: int
    init_method: str


def launch_info(env: Optional[Mapping[str, str]] = None) -> LaunchInfo:
    """Rank, world, local rank and rendezvous of a detected launch; raises
    ``RuntimeError`` for markers that do not say enough to join a group."""
    env = os.environ if env is None else env
    if torchrun_launch(env):
        rank, world = _int(env, "RANK", 0), _int(env, "WORLD_SIZE")
        local_rank = _int(env, "LOCAL_RANK", rank)
        local_world = _int(env, "LOCAL_WORLD_SIZE", world)
        return LaunchInfo(rank, world, local_rank, local_world, "env://")
    if env.get("COORDINATOR_ADDRESS") and env.get("NUM_PROCESSES") and env.get("PROCESS_ID"):
        rank, world = _int(env, "PROCESS_ID", 0), _int(env, "NUM_PROCESSES")
        return LaunchInfo(rank, world, _int(env, "LOCAL_RANK", 0), _int(env, "LOCAL_WORLD_SIZE", 1),
                          f"tcp://{env['COORDINATOR_ADDRESS']}")
    for size, rank_key, local_key, local_size in (
        ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID", "SLURM_NTASKS_PER_NODE"),
        ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
         "OMPI_COMM_WORLD_LOCAL_SIZE"),
    ):
        if _int(env, size) > 1 and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            return LaunchInfo(_int(env, rank_key, 0), _int(env, size), _int(env, local_key, 0),
                              _int(env, local_size, 1), "env://")
    raise RuntimeError(
        "a multi-process launch was detected but its rank, world size or rendezvous "
        "is missing: launch with `python -m torch.distributed.run`, or set "
        "COORDINATOR_ADDRESS + NUM_PROCESSES + PROCESS_ID, or MASTER_ADDR / MASTER_PORT "
        "beside the Slurm or Open MPI variables"
    )


def maybe_initialize_distributed(env: Optional[Mapping[str, str]] = None,
                                 device: str | torch.device = "cuda") -> bool:
    """Join the process group of a detected launch; ``True`` when this call
    created it. NCCL when ``device`` is a card, gloo on the CPU. A failure
    raises (``init_process_group``'s own error). ``WORLD_SIZE`` above 1
    without a launcher's ``RANK`` raises too: the other ranks were never
    started."""
    env = os.environ if env is None else env
    if dist.is_initialized():
        return False
    if not multihost_launch_detected(env):
        if _int(env, "WORLD_SIZE") > 1:
            raise RuntimeError(
                f"WORLD_SIZE={env['WORLD_SIZE']} but no launcher set RANK: start the "
                "ranks with `python -m torch.distributed.run --nproc-per-node N ...`"
            )
        return False
    info = launch_info(env)
    cuda = torch.device(device).type == "cuda"
    kwargs = {}
    if info.init_method == "env://":
        for key in ("MASTER_ADDR", "MASTER_PORT"):
            if key in env:
                os.environ.setdefault(key, env[key])
    if cuda:
        torch.cuda.set_device(info.local_rank)
        kwargs["device_id"] = torch.device("cuda", info.local_rank)
    dist.init_process_group(
        backend="nccl" if cuda else "gloo", init_method=info.init_method,
        rank=info.rank, world_size=info.world, **kwargs,
    )
    logger.info("torch.distributed initialized: rank %d/%d (%s)", info.rank, info.world,
                dist.get_backend())
    return True


def rank_device(device: str | torch.device, env: Optional[Mapping[str, str]] = None) -> torch.device:
    """A rank's device: ``cuda:LOCAL_RANK`` for ``cuda``, else ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        env = os.environ if env is None else env
        local = _int(env, "LOCAL_RANK", -1)
        if local < 0:
            local = launch_info(env).local_rank if multihost_launch_detected(env) else 0
        return torch.device("cuda", local)
    return dev


@dataclass
class ParallelContext:
    """The mesh as the model, loader and trainer see it.

    ``data_group`` / ``model_group`` are the process groups of this rank's
    row and column of the mesh; ``sequence`` shards the per-position
    regions of each block on T over ``model`` (only when ``model > 1``);
    ``fsdp`` shards parameters and their optimizer state over ``data``;
    ``pipeline`` (the microbatch count, 0 without) makes the ``model`` ranks
    GPipe stages instead of tensor-parallel ones (only when ``model > 1``).
    """

    mesh: Any
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any
    sequence: bool = False
    fsdp: bool = False
    pipeline: int = 0

    @classmethod
    def from_mesh(cls, mesh, sequence: bool = False, fsdp: bool = False,
                  pipeline: int = 0) -> "ParallelContext":
        data, model = mesh.shape
        return cls(
            mesh=mesh, data=int(data), model=int(model),
            data_rank=mesh.get_local_rank(DATA_AXIS), model_rank=mesh.get_local_rank(MODEL_AXIS),
            data_group=mesh.get_group(DATA_AXIS), model_group=mesh.get_group(MODEL_AXIS),
            sequence=bool(sequence) and model > 1, fsdp=bool(fsdp),
            pipeline=int(pipeline) if model > 1 else 0,
        )

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def is_main(self) -> bool:
        return dist.get_rank() == 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over ``data`` (no gradient)."""
        if self.data > 1:
            dist.all_reduce(t, group=self.data_group)
        return t


@dataclass(frozen=True)
class RowSplit:
    """How a rank finds its rows. The loader shards over nodes (``batch_size``
    is per host, as in the JAX package, where a process drives its host's
    chips); a node's batch is padded to a multiple of its data ranks ×
    ``microbatches`` (the pipeline's M, which must divide each data rank's
    rows; 1 without a pipeline) and split among the data ranks in
    contiguous blocks, the padding rows weighted 0."""

    num_shards: int = 1
    shard_index: int = 0
    local_data: int = 1
    local_index: int = 0
    microbatches: int = 1

    def take(self, arrays: Dict[str, np.ndarray], real_rows: int) -> Dict[str, np.ndarray]:
        """This rank's rows of a node batch whose first ``real_rows`` are real."""
        arrays = dict(arrays)
        arrays["weight"] = arrays["weight"].copy()
        arrays["weight"][real_rows:] = 0.0
        arrays, _ = pad_batch_to_multiple(arrays, self.local_data * max(1, self.microbatches))
        if self.local_data == 1:
            return arrays
        m = next(iter(arrays.values())).shape[0] // self.local_data
        lo = self.local_index * m
        return {k: v[lo:lo + m] for k, v in arrays.items()}


def row_split(ctx: Optional[ParallelContext], env: Optional[Mapping[str, str]] = None,
              microbatches: int = 0) -> RowSplit:
    """The :class:`RowSplit` of this rank: nodes of ``LOCAL_WORLD_SIZE``
    ranks, ``model`` innermost inside a node; ``microbatches`` is the
    encoder's ``pipeline_microbatches`` (each data rank's rows padded to a
    multiple of it, one process too, as the JAX trainer pads)."""
    m = max(1, int(microbatches))
    if ctx is None:
        return RowSplit(microbatches=m)
    env = os.environ if env is None else env
    world, rank = dist.get_world_size(), dist.get_rank()
    local_world = _int(env, "LOCAL_WORLD_SIZE", world)
    if world % local_world or local_world % ctx.model:
        raise ValueError(
            f"{local_world} ranks a node must divide the world ({world}) and be a "
            f"multiple of parallel.model={ctx.model}"
        )
    return RowSplit(num_shards=world // local_world, shard_index=rank // local_world,
                    local_data=local_world // ctx.model,
                    local_index=(rank % local_world) // ctx.model, microbatches=m)
