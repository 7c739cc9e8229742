"""Whisper training step: teacher-forced cross-entropy (PyTorch).

Counterpart of ``modular_audio_pipeline_tpu/training/whisper_train.py``.
Shapes are static: mel ``[B, n_mels, 3000]``, tokens ``[B, S]`` with
``IGNORE_INDEX`` (-100) on ignored targets (prompt + pad). The parameters
are the port's tree of leaf tensors (``models/whisper/model.py``'s
layout); :func:`make_train_step`'s ``init_state`` makes every leaf require
a gradient and binds the optimizer to them, and ``train_step`` updates
them in place. On the card the encoder's self-attention is the flash
kernel, differentiated through its recompute backward
(``ops/attention.py``). The f32 convolutions run with TF32 off, as the
JAX package's f32 arithmetic.

Under a mesh (``make_train_step(dims, mesh=...)``, one process per card)
each rank feeds its block of the global batch's rows (``data`` axis) to
a tree of its slices (``parallel/sharding.shard_params``, ``model`` axis).
The loss is the global batch's masked mean: each rank's summed NLL over
the unmasked token count summed over ``data``, so rows that ``pad_batch``
filled with ``IGNORE_INDEX`` count nowhere; the gradients are summed over
``data``. A sharded leaf keeps its local gradient; a replicated one gets
the same gradient on every model rank through the Megatron collectives'
backward. Adam runs on the local slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..models.vad_net import no_tf32
from ..models.whisper.config import WhisperDims
from ..models.whisper.model import (
    KVCache,
    cross_kv,
    decoder_forward,
    encoder_forward,
    local_heads,
)
from ..parallel.mesh import axis_group
from .optim import Adam, AdamState, adamw

__all__ = ["TrainState", "make_train_step", "cross_entropy_loss", "IGNORE_INDEX",
           "tree_leaves"]

IGNORE_INDEX = -100


class TrainState(NamedTuple):
    params: Dict[str, Any]
    opt_state: AdamState
    step: int


def tree_leaves(tree: Dict[str, Any]) -> List[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    out: List[torch.Tensor] = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, S, V] f32
    targets: torch.Tensor,  # [B, S] int, IGNORE_INDEX = masked
    data_group=None,
) -> torch.Tensor:
    """Mean NLL over the unmasked targets; with ``data_group`` the count is
    summed over that group first (each rank's share of the global mean)."""
    mask = targets != IGNORE_INDEX
    safe_targets = torch.where(mask, targets, 0).long()
    logprobs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logprobs, -1, safe_targets[..., None])[..., 0]
    total = torch.where(mask, nll, 0.0).sum()
    count = mask.sum()
    if data_group is not None:
        torch.distributed.all_reduce(count, group=data_group)
    return total / torch.clamp(count, min=1)


def _forward_loss(params, dims: WhisperDims, mel, tokens, targets,
                  data_group=None) -> torch.Tensor:
    xa = encoder_forward(params, dims, mel)
    xa_k, xa_v = cross_kv(params, dims, xa)
    cache = KVCache.zeros(dims, tokens.shape[0], dtype=params["decoder"]["tok_emb"].dtype,
                          ctx=tokens.shape[1], device=tokens.device,
                          heads=local_heads(dims.n_text_head, params))
    logits, _ = decoder_forward(params, dims, tokens, xa_k, xa_v, cache)
    return cross_entropy_loss(logits.float(), targets, data_group)


def make_train_step(dims: WhisperDims, optimizer: Optional[Adam] = None, mesh=None):
    """Returns ``(init_state, train_step)``.

    ``init_state(params) -> TrainState`` makes every leaf of ``params``
    require a gradient and binds the optimizer (default: AdamW, lr 1e-5,
    weight decay 0.01) to them. ``train_step(state, mel, tokens, targets)
    -> (state, loss)`` runs one step: the parameters change in place, the
    returned state carries the next step number, and the loss is a detached
    0-d tensor on the parameters' device. Under ``mesh`` the batch is this
    rank's rows and the loss is the global batch's.
    """
    opt = optimizer or adamw(1e-5, weight_decay=0.01)
    data_group = axis_group(mesh, "data")

    def init_state(params) -> TrainState:
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return TrainState(params=params, opt_state=opt.init(leaves), step=0)

    def train_step(state: TrainState, mel, tokens, targets) -> Tuple[TrainState, torch.Tensor]:
        state.opt_state.zero_grad()
        with no_tf32():
            loss = _forward_loss(state.params, dims, mel, tokens, targets, data_group)
            loss.backward()
        loss = loss.detach()
        if data_group is not None:
            for p in tree_leaves(state.params):
                if p.grad is None:  # every rank sums the same leaves
                    p.grad = torch.zeros_like(p)
                torch.distributed.all_reduce(p.grad, group=data_group)
            torch.distributed.all_reduce(loss, group=data_group)
        state.opt_state.step()
        return TrainState(state.params, state.opt_state, state.step + 1), loss

    return init_state, train_step
