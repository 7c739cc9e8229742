"""The device mesh: one process per card, named ``data`` and ``model`` axes.

Counterpart of ``modular_audio_pipeline_tpu/parallel/mesh.py``. The JAX
package runs one controller over every device; the port runs one process
per card, launched by ``torchrun`` (``python -m torch.distributed.run``),
and every rank reads the same config:

- ``tpu.mesh_shape`` is the mesh, axes in their config order (``data``
  then ``model``); an empty shape is ``{data: world}``;
- the process group comes from torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), or from
  an explicit ``init_method`` (the tests' ``file://`` stores); without
  either the world is this one process;
- the backend is NCCL for CUDA and gloo for the CPU, unless the caller
  names one (two ranks sharing one card need gloo: NCCL refuses a card
  twice); the group's timeout is explicit;
- rank r runs on ``cuda:LOCAL_RANK``.

The mesh's size must equal the world: a larger mesh raises
:class:`~..exceptions.ShardingError` (as the JAX package does when it has
too few devices), and so does a smaller one (the JAX package trims its
device list, but here the spare ranks would miss the collectives).

``data`` shards window batches (DP: no collective in inference but the
gather of each batch's host results; gradients summed in training);
``model`` shards attention heads and MLP columns (Megatron TP:
``sharding.py``'s collectives).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..exceptions import ShardingError

logger = logging.getLogger(__name__)

__all__ = ["init_distributed", "build_mesh", "mesh_shape", "axis_size", "axis_rank",
           "axis_group", "world_rank", "rank_dir", "data_sharding", "replicated", "shard_batch",
           "check_mesh", "TORCHRUN_HINT"]

TIMEOUT_S = 60.0  # a collective that waits longer than this fails the rank
TORCHRUN_HINT = ("launch one process per card: torchrun --nproc-per-node N "
                 "-m modular_audio_pipeline_tpu_torch --devices N [--tp T] ...")


def init_distributed(device=None, backend: Optional[str] = None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = TIMEOUT_S) -> Tuple[int, int]:
    """Join (or create) the default process group -> ``(rank, world)``.

    ``rank``/``world_size``/``init_method`` default to torchrun's
    environment; without it (and without ``init_method``) the world is
    this process alone, over an in-process store. ``backend`` defaults to
    NCCL for a CUDA ``device`` and gloo otherwise. On CUDA this process's
    card becomes ``cuda:LOCAL_RANK``. A group that already exists is kept.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = torch.device(device if device is not None else "cuda")
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is None and "MASTER_ADDR" not in env:
        if world != 1:
            raise ShardingError(f"WORLD_SIZE={world} without a rendezvous address",
                                details=TORCHRUN_HINT)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world, timeout=timeout)
    logger.info("process group: rank %d of %d over %s", rank, world, backend)
    return rank, world


def build_mesh(cfg=None, device=None, backend: Optional[str] = None, **init_kw):
    """A ``DeviceMesh`` from ``cfg.mesh_shape`` (a ``TPUConfig``; default
    ``{data: world}``) over the process group, which is created first when
    there is none (``init_distributed``'s arguments pass through). A shape
    that is not the world raises before any group is made."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device if device is not None else "cuda")
    # the world this mesh must cover, read before any group is made
    world = (dist.get_world_size() if dist.is_initialized()
             else init_kw.get("world_size") or int(os.environ.get("WORLD_SIZE", 1)))
    data_axis = getattr(cfg, "data_axis", "data")
    shape: Dict[str, int] = {k: int(v) for k, v in dict(getattr(cfg, "mesh_shape", None)
                                                          or {}).items()}
    if not shape:
        shape = {data_axis: world}
    total = int(np.prod(list(shape.values())))
    if total > world:
        raise ShardingError(f"Mesh shape {shape} needs {total} devices, have {world}",
                            details=TORCHRUN_HINT if world == 1 else
                            "start as many ranks as the mesh has devices")
    if total < world:
        raise ShardingError(f"Mesh shape {shape} covers {total} of {world} ranks",
                            details="every rank must belong to the mesh: give the mesh "
                            "as many devices as the world has ranks")
    init_distributed(dev, backend, **init_kw)
    mesh = init_device_mesh(dev.type, tuple(shape.values()), mesh_dim_names=tuple(shape))
    logger.info("Mesh: %s over %d rank(s)", shape, total)
    return mesh


def check_mesh(mesh) -> None:
    """Reject what is not a ``DeviceMesh`` with named axes (``TypeError``)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or not mesh.mesh_dim_names:
        raise TypeError(f"mesh must be a torch DeviceMesh with named axes, got {mesh!r}")


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` in axis order, as a JAX mesh's ``shape``."""
    if mesh is None:
        return {}
    return {name: int(mesh[name].size()) for name in mesh.mesh_dim_names}


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` (1 without a mesh or without that axis)."""
    return mesh_shape(mesh).get(axis, 1)


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh or axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of this rank's ``axis`` (None when the axis is
    absent or of size 1: nothing to communicate)."""
    if axis_size(mesh, axis) <= 1:
        return None
    return mesh.get_group(axis)


def world_rank() -> int:
    """This process's rank in the default group; before the group exists,
    torchrun's ``RANK`` (0 without either)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def rank_dir(path: str) -> str:
    """``path`` on rank 0, ``<path>.rank<r>`` on another rank: scratch that
    each rank writes and clears on its own (stage WAVs, conversions)."""
    r = world_rank()
    return path if r == 0 or not path else f"{path}.rank{r}"


def data_sharding(mesh, axis: str = "data", ndim: int = 2) -> Tuple[Any, ...]:
    """The per-axis placements that shard a batch's leading dim on
    ``axis`` and replicate the rest (the JAX ``P(axis, None, ...)``)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh) -> Tuple[Any, ...]:
    """Placements that replicate over every axis (the JAX ``P()``)."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def shard_batch(mesh, batch, axis: str = "data"):
    """Pad the leading dim to a multiple of the axis size -> (this rank's
    contiguous block of rows, the unpadded row count): the rows that
    ``P(axis)`` places on this rank's device. ``batch`` is a numpy array or
    a tensor; the block is of the same kind."""
    n = axis_size(mesh, axis)
    b = int(batch.shape[0])
    pad = (-b) % n
    if pad:
        if isinstance(batch, torch.Tensor):
            batch = torch.cat([batch, batch.new_zeros((pad,) + tuple(batch.shape[1:]))])
        else:
            batch = np.concatenate([batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)])
    rows = (b + pad) // n
    r = axis_rank(mesh, axis)
    return batch[r * rows : (r + 1) * rows], b
