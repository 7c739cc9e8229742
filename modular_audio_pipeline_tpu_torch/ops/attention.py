"""Flash attention for the Whisper encoder: CUDA kernel and plain version.

Counterpart of ``modular_audio_pipeline_tpu/ops/attention.py``. The
kernel (``csrc/flash_attention.cu``) replaces the Pallas ``_flash_kernel``;
``attention_reference`` is its plain PyTorch version, used for tensors on
the CPU and as the oracle the kernel is held against on the card.

The gradient. On the card, when autograd records (a training step),
``flash_attention`` goes through :class:`_FlashAttention`: the forward is
the kernel's launch, and the backward recomputes the attention through
``attention_reference`` and returns that function's vector-Jacobian
product for q, k and v. That is the JAX package's ``custom_vjp``
(``_flash_attention_bwd``), whose backward is XLA einsums outside any
Pallas kernel: there is no TPU kernel of the backward to port, so the
plain backward here is the port of that design, not a fallback. The
recompute holds ``[B, H, S, S]`` f32 logits and probabilities while it
runs. Under ``no_grad``, or when no input needs a gradient, the kernel
is launched directly and nothing is saved.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["flash_attention", "attention_reference", "flash_arithmetic_emulation"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Whisper attention ``[B, H, S, D] -> [B, H, S, D]``, plain PyTorch.

    q and k are scaled by D^-0.25 in their own type, the products and the
    softmax run in f32, the probabilities are rounded to q's type before
    the f32-accumulated product with v (the JAX reference's rounding).
    """
    scale = q.shape[-1] ** -0.25
    logits = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def flash_arithmetic_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               tile: int = 128) -> torch.Tensor:
    """The kernel's arithmetic, step by step, in plain PyTorch.

    q and k scaled by D^-0.25 and rounded to their type first; key tiles
    of ``tile`` rows (the ragged tail is a shorter tile, which is what
    masking its missing keys to -inf amounts to); a running max and sum in
    f32 with the exponential as exp2 of the score times log2(e); the
    UNNORMALISED probabilities rounded to the input type before the
    f32-accumulated product with v; the sum taken from the f32
    probabilities; one division at the end (the kernel multiplies by the
    reciprocal). Both of the kernel's routes take tiles of 64 keys
    (``kTileN``, ``kFmaKeys``). Nothing on the main path calls this: it
    states what the kernel commits to, for the CPU tests that hold it
    against the JAX package and for explaining a mismatch on the card.
    """
    dt = q.dtype
    scale = q.shape[-1] ** -0.25
    log2e = 1.4426950408889634
    qs, ks, vf = (q * scale).float(), (k * scale).float(), v.float()
    m = torch.full(q.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32)
    m, l, acc = m.to(q.device), l.to(q.device), acc.to(q.device)
    for k0 in range(0, k.shape[-2], tile):
        s = torch.matmul(qs, ks[..., k0:k0 + tile, :].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2((m - m_new) * log2e)
        p = torch.exp2(s * log2e - m_new * log2e)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(dt).float(), vf[..., k0:k0 + tile, :])
        m = m_new
    return (acc / l).to(dt)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class _FlashAttention(torch.autograd.Function):
    """The kernel forward with the JAX package's recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _flash_launch(q, k, v)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_o):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(attention_reference(*inputs), wanted, grad_o))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Whisper encoder self-attention ``[B, H, S, D] -> [B, H, S, D]``.

    On a CUDA tensor this launches the hand-written kernel on the current
    stream (contiguous bf16 or f32, D of 32 or 64) and raises on anything
    it does not take or on a failed launch; on a CPU tensor it runs
    :func:`attention_reference`, which autograd differentiates. On the card
    the result is differentiable when autograd records: the backward
    recomputes through :func:`attention_reference` (module docstring).

    bf16 at D = 64 (the encoder of every model wider than test-tiny) runs on
    the tensor cores: a pre-pass writes ``k * D^-0.25`` rounded to bf16 into
    scratch allocated here, and q, k, v must start on 16-byte boundaries
    (any fresh tensor does). f32 inputs, and bf16 at D = 32, take the
    CUDA-core route (``flash_fwd_fma``: 128 queries a block in register
    tiles of 8 queries, ``cp.async`` copies of the next K/V tile during
    this one's f32 FMAs); it copies 16 bytes at a time, so there too q, k
    and v must start on 16-byte boundaries.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return _flash_launch(q, k, v)


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on the current stream; counts it."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q/k/v must share one [B, H, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: bf16 or f32 q/k/v of one type, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q/k/v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q/k/v must be contiguous")
    b, h, s, d = q.shape
    if d not in (32, 64):
        raise ValueError(f"flash_attention: head dim {d} not built (32 or 64)")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q/k/v must start on 16-byte boundaries")
    o = torch.empty_like(q)
    scratch = None
    if q.dtype == torch.bfloat16 and d == 64:
        scratch = torch.empty_like(k)  # k * D^-0.25, written by the kernel's pre-pass
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       None if scratch is None else scratch.data_ptr(),
                       b * h, s, d, _DTYPE_CODES[q.dtype], d ** -0.25, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed (cudaError {rc})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0  # kernel launches since the last reset
