"""The optimizers, schedules and losses the trainers use (PyTorch).

The port's copy of the optax pieces the JAX trainers call, with optax's
formulas (optax 0.2):

- :func:`adam` and :func:`adamw`: ``mu = (1 - b1) g + b1 mu``, ``nu =
  (1 - b2) g^2 + b2 nu``, the bias corrections at the incremented count,
  ``eps`` added outside the square root; :func:`adamw` adds ``weight_decay
  * p`` for every leaf (biases and norms included) before the learning
  rate scales the update. A schedule is read at the update count BEFORE it
  is incremented, so a warm-up from 0.0 makes the first update zero.
- :func:`cosine_decay_schedule` and :func:`warmup_cosine_decay_schedule`
  (a linear warm-up joined to a cosine decay).
- :func:`softmax_cross_entropy` and :func:`sigmoid_binary_cross_entropy`.

An optimizer is a description (``adamw(1e-5, weight_decay=0.01)``) that
``init(params)`` binds to a list of tensors: the bound state reads each
tensor's ``.grad`` in :meth:`AdamState.step` and updates it in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, List, Union

import torch
import torch.nn.functional as F

__all__ = [
    "Adam", "AdamState", "adam", "adamw", "cosine_decay_schedule",
    "warmup_cosine_decay_schedule", "softmax_cross_entropy", "sigmoid_binary_cross_entropy",
]

Schedule = Callable[[int], float]


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    """``init_value * ((1 - alpha) * (0.5 (1 + cos(pi min(t, T) / T)))^p + alpha)``."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(float(count), float(decay_steps))
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


def _linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """A linear warm-up from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine decay to ``end_value`` at ``decay_steps``
    (the warm-up included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = _linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)


@dataclass(frozen=True)
class Adam:
    """optax's adam (``weight_decay`` 0) or adamw, before it meets parameters."""

    learning_rate: Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: Iterable[torch.Tensor]) -> "AdamState":
        return AdamState(self, list(params))

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)


class AdamState:
    """Moments and update count of :class:`Adam` bound to ``params``."""

    def __init__(self, opt: Adam, params: List[torch.Tensor]):
        self.opt = opt
        self.params = params
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from each parameter's ``.grad`` (a missing gradient
        counts as zeros, as an unused leaf's gradient is in JAX)."""
        o = self.opt
        lr = o.lr(self.count)  # the schedule at the count before the increment
        self.count += 1
        # optax's bias corrections, in f32
        bc1 = 1.0 - torch.tensor(o.b1, dtype=torch.float32) ** self.count
        bc2 = 1.0 - torch.tensor(o.b2, dtype=torch.float32) ** self.count
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu.copy_((1.0 - o.b1) * g + o.b1 * mu)
            nu.copy_((1.0 - o.b2) * (g * g) + o.b2 * nu)
            update = (mu / bc1.to(mu.device)) / (torch.sqrt(nu / bc2.to(nu.device)) + o.eps)
            if o.weight_decay:
                update += o.weight_decay * p
            p += -lr * update


def adam(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    return Adam(learning_rate, b1, b2, eps)


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Adam:
    return Adam(learning_rate, b1, b2, eps, weight_decay)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``-sum(labels * log_softmax(logits), -1)`` per row."""
    return -(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Element-wise ``-labels log sigmoid(x) - (1 - labels) log sigmoid(-x)``."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
