"""Plain reference of Whisper fine-tuning steps: teacher-forced
cross-entropy (``whisper.train_loss``), its gradients by autograd, and
AdamW as optax defines it (``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu +
(1 - b2) g^2``, bias corrections at the incremented count, ``eps``
outside the square root, ``weight_decay * p`` added to every leaf's
update before the learning rate scales it). It imports nothing of the
program."""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from . import whisper


def run_steps(tree: Dict[str, Any], cfg: Dict[str, Any], batches: List[Dict[str, torch.Tensor]],
              opt: Dict[str, float], prec: str = "f32") -> Dict[str, Any]:
    """Runs ``len(batches)`` AdamW steps from ``tree`` (changed in place).
    Returns the loss of each step, each leaf's gradient norm at the first
    step, and each leaf's norm of its change over all the steps."""
    from ..weights import leaves

    named = leaves(tree)
    start = {n: p.detach().clone() for n, p in named}
    params = [p.detach().requires_grad_(True) for _, p in named]
    node_of = {}
    for (n, _), p in zip(named, params):
        node_of[n] = p
    live = _rebuild(tree, node_of)
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    b1, b2, eps, lr, wd = opt["b1"], opt["b2"], opt["eps"], opt["lr"], opt["weight_decay"]
    losses, grad_norms = [], {}
    for count, b in enumerate(batches, start=1):
        loss = whisper.train_loss(live, cfg, b["mel"], b["tokens"], b["targets"], prec)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        if count == 1:
            grad_norms = {n: float(g.double().norm()) for (n, _), g in zip(named, grads)}
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(b1).add_((1.0 - b1) * g)
                v.mul_(b2).add_((1.0 - b2) * g * g)
                upd = (m / bc1.to(m.device)) / (torch.sqrt(v / bc2.to(v.device)) + eps)
                p.add_(-lr * (upd + wd * p))
        del grads, loss
    change = {n: float((p.detach() - start[n]).double().norm()) for (n, _), p in zip(named, params)}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def _rebuild(tree, node_of, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out[k] = _rebuild(v, node_of, name) if isinstance(v, dict) else node_of[name]
    return out
