"""Whisper's Megatron tensor parallelism over the mesh's ``model`` axis.

Counterpart of ``modular_audio_pipeline_tpu/parallel/sharding.py``. The
parameter tree is the same; each leaf's spec names the dim sharded over
``model`` (or None: replicated). Q/K/V and MLP-up are column parallel
(output features split), the attention output and MLP-down row parallel
(input features split), the embeddings split over features. Where GSPMD
inserts the collectives for the JAX package, the port calls them
explicitly (``models/whisper/model.py``), as ``torch.autograd.Function``s
so that training differentiates them:

- :func:`copy_to_model`: identity forward, all-reduce backward (the input
  of a column-parallel block);
- :func:`reduce_from_model`: all-reduce forward, identity backward (the
  partial sums of a row-parallel product);
- :func:`gather_from_model`: concatenation of every rank's slice forward,
  this rank's slice backward.

Every collective runs in f32 (the partial sums are f32; a gathered bf16 or
f16 slice converts exactly). The gather is an all-reduce of a zero-filled
buffer holding this rank's slice: exact (x + 0 = x) and taken by every
backend, including gloo on CUDA tensors.

:func:`shard_params` returns a :class:`ShardedParams`: this rank's
contiguous slices, with the model group the forward reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..exceptions import ShardingError
from .mesh import axis_group, axis_rank, axis_size

__all__ = ["whisper_param_specs", "shard_params", "unshard_params", "batch_spec",
           "ModelGroup", "ShardedParams", "model_group", "copy_to_model",
           "reduce_from_model", "gather_from_model", "all_reduce_count"]


def _attn_specs() -> Dict[str, Optional[int]]:
    # stacked leaves carry a leading L dim: [L, in, out] weights, [L, out] biases
    return {
        "q_w": 2, "q_b": 1, "k_w": 2, "v_w": 2, "v_b": 1,  # column parallel
        "o_w": 1, "o_b": None,  # row parallel: the bias is added once
    }


def _block_specs(cross: bool) -> Dict[str, Any]:
    ln = {"g": None, "b": None}
    specs: Dict[str, Any] = {
        "attn": _attn_specs(), "attn_ln": dict(ln),
        "mlp": {"fc1_w": 2, "fc1_b": 1, "fc2_w": 1, "fc2_b": None},
        "mlp_ln": dict(ln),
    }
    if cross:
        specs["cross"] = _attn_specs()
        specs["cross_ln"] = dict(ln)
    return specs


def whisper_param_specs(model_axis: str = "model") -> Dict[str, Any]:
    """The dim of each leaf sharded over ``model_axis`` (None: replicated),
    in the parameter tree's layout (the JAX function's PartitionSpecs)."""
    del model_axis  # one model axis; kept for the JAX signature
    return {
        "encoder": {
            "conv1": {"w": None, "b": None},
            "conv2": {"w": None, "b": None},
            "blocks": _block_specs(cross=False),
            "ln_post": {"g": None, "b": None},
        },
        "decoder": {
            # over features: the logits contract over the sharded dim, one
            # all-reduce at the end of each step
            "tok_emb": 1,
            "pos_emb": 1,
            "blocks": _block_specs(cross=True),
            "ln": {"g": None, "b": None},
        },
    }


@dataclass(frozen=True)
class ModelGroup:
    """This rank's place on the ``model`` axis: its process group, the
    axis size and its coordinate."""

    group: Any
    size: int
    rank: int


class ShardedParams(dict):
    """A parameter tree of this rank's slices; ``model`` is its group."""

    def __init__(self, tree: Dict[str, Any], model: ModelGroup):
        super().__init__(tree)
        self.model = model


def model_group(params) -> Optional[ModelGroup]:
    """The model group a tree is sharded over (None: a whole tree)."""
    return getattr(params, "model", None)


def _slice(leaf: torch.Tensor, dim: Optional[int], size: int, rank: int) -> torch.Tensor:
    if dim is None:
        return leaf
    n = leaf.shape[dim]
    if n % size:
        raise ShardingError(f"dim {dim} of a {tuple(leaf.shape)} leaf does not split "
                            f"{size} ways")
    w = n // size
    return leaf.narrow(dim, rank * w, w).contiguous()


def _map(tree, specs, fn):
    out = {}
    for k, v in tree.items():
        if k not in specs:
            raise ShardingError(f"no sharding spec for parameter '{k}'")
        out[k] = _map(v, specs[k], fn) if isinstance(v, dict) else fn(v, specs[k])
    return out


def _is_quantised(tree) -> bool:
    return any(_is_quantised(v) if isinstance(v, dict) else k.endswith("_wq")
               for k, v in tree.items())


def shard_params(params: Dict[str, Any], mesh, model_axis: str = "model", dims=None):
    """This rank's contiguous slices of ``params`` (host or device
    tensors) over ``model_axis``. Without that axis, or at size 1, the tree
    is returned as it is (replicated). ``dims`` (a ``WhisperDims``) checks
    that the heads divide; a weight-only int8 tree has no spec and raises
    :class:`ShardingError` (the transcriber replicates it explicitly)."""
    size = axis_size(mesh, model_axis)
    if size <= 1:
        return params
    if dims is not None:
        for n_head in (dims.n_audio_head, dims.n_text_head):
            if n_head % size:
                raise ShardingError(f"{n_head} heads do not split over {model_axis}={size}")
    if _is_quantised(params):
        raise ShardingError("a weight-only int8 tree has no tensor-parallel spec")
    rank = axis_rank(mesh, model_axis)
    tree = _map(params, whisper_param_specs(model_axis),
                lambda leaf, dim: _slice(leaf, dim, size, rank))
    return ShardedParams(tree, ModelGroup(axis_group(mesh, model_axis), size, rank))


def unshard_params(params) -> Dict[str, Any]:
    """The whole tree back from a :class:`ShardedParams` (every rank gets
    it; the inverse of :func:`shard_params`); a whole tree as it is."""
    mg = model_group(params)
    if mg is None:
        return params
    return _map(params, whisper_param_specs(),
                lambda leaf, dim: leaf.detach() if dim is None
                else gather_from_model(leaf.detach(), mg, dim))


def batch_spec(mesh, data_axis: str = "data", ndim: int = 3):
    """The placements of a batch-leading activation: the leading dim on
    ``data_axis`` when the mesh has it, replicated otherwise."""
    from torch.distributed.tensor import Replicate, Shard

    axis = data_axis if data_axis in mesh.mesh_dim_names else None
    del ndim  # a placement names the sharded dim only
    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

# all-reduces issued since import (chip_smoke.py reads it per decode step)
all_reduce_count = [0]


def _all_reduce(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """Sum over the model group in f32; returns a new tensor in x's dtype."""
    y = x.detach().float().clone()
    dist.all_reduce(y, group=mg.group)
    all_reduce_count[0] += 1
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mg), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return _all_reduce(x, mg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, dim):
        ctx.mg, ctx.dim, ctx.n = mg, dim, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= mg.size
        buf = x.new_zeros(shape, dtype=torch.float32)
        buf.narrow(dim, mg.rank * ctx.n, ctx.n).copy_(x)
        dist.all_reduce(buf, group=mg.group)
        all_reduce_count[0] += 1
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mg.rank * ctx.n, ctx.n).contiguous(), None, None


def copy_to_model(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    return _CopyToModel.apply(x, mg)


def reduce_from_model(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mg)


def gather_from_model(x: torch.Tensor, mg: ModelGroup, dim: int = -1) -> torch.Tensor:
    return _GatherFromModel.apply(x, mg, dim % x.dim())
