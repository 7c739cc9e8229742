"""Flash attention for the Whisper encoder: CUDA kernel and plain version.

Counterpart of ``modular_audio_pipeline_tpu/ops/attention.py``. The
kernel (``csrc/flash_attention.cu``) replaces the Pallas ``_flash_kernel``;
``attention_reference`` is its plain PyTorch version, used for tensors on
the CPU and as the oracle the kernel is held against on the card.

The gradient. On the card, when autograd records (a training step),
``flash_attention`` goes through :class:`_FlashAttention`. In f32 (every
trainer of the port) the forward is the kernel's training variant, which
also writes each query row's log-sum-exp and lays the output out as the
heads are merged, ``[B, S, H, D]`` (returned as a ``[B, H, S, D]`` view),
and the backward is one launch of the flash backward kernel
(``flash_bwd_fma``): it recomputes each tile of probabilities from q, k and
that log-sum-exp and never holds a ``[B, H, S, S]`` tensor. The JAX
package's ``custom_vjp`` (``_flash_attention_bwd``) recomputes through XLA
einsums, and it has no Pallas kernel of the backward; its design stays here
for bf16, where the backward differentiates ``attention_reference`` again
(``[B, H, S, S]`` f32 logits and probabilities while it runs). Under
``no_grad``, or when no input needs a gradient, the plain forward is
launched directly and nothing is saved.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["flash_attention", "attention_reference", "flash_arithmetic_emulation",
           "flash_lse_emulation", "flash_backward_emulation"]

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
    return _online_softmax(q, k, v, tile)[0]


def flash_lse_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The training forward's arithmetic (f32): ``(o, lse)``, the output of
    :func:`flash_arithmetic_emulation` and each row's log-sum-exp in base 2,
    ``m log2(e) + log2(l)``, as ``[B, H, S]``. What ``_flash_lse_launch``
    returns, for the CPU tests that bind the launch to it."""
    if q.dtype != torch.float32:
        raise ValueError(f"flash_attention: the log-sum-exp forward is f32, got {q.dtype}")
    out, m, l = _online_softmax(q, k, v, 128)
    return out, (m * 1.4426950408889634 + torch.log2(l)).squeeze(-1)


def _online_softmax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tile: int):
    """(output, running max, running sum) of the forward's arithmetic."""
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
    return (acc / l).to(dt), m, l


def flash_backward_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, grad_o: torch.Tensor, key_tile: int = 128,
                             query_tile: int = 64):
    """The backward kernel's arithmetic (f32), step by step, in plain PyTorch.

    ``lse`` is the forward's log-sum-exp in base 2, ``[B, H, S']`` with
    S' >= S (the kernel pads it). delta = rowsum(grad_o * o); q and k scaled
    by D^-0.25; for each tile of ``key_tile`` keys, over tiles of
    ``query_tile`` queries: S = (q s)(k s)^T, P = exp2(S log2(e) - lse),
    dV += P^T dO, dP = dO V^T, dS = P (dP - delta), dK += dS^T (q s), and
    D^-0.25 dS (k s) added into dQ; dK times D^-0.25 at the end. The kernel's
    tiles are 128 keys and 64 queries (``flash_bwd_fma``); its additions into
    dQ come in whatever order the key tiles finish. Returns (dq, dk, dv).
    Nothing on the main path calls this: it states what the kernel commits
    to, for the CPU tests that hold it against the JAX package.
    """
    scale = q.shape[-1] ** -0.25
    log2e = 1.4426950408889634
    s = q.shape[-2]
    qs, ks, vf, go = (q * scale).float(), (k * scale).float(), v.float(), grad_o.float()
    lse = lse[..., :s, None].float()
    delta = (go * o.float()).sum(dim=-1, keepdim=True)
    dq, dk, dv = torch.zeros_like(qs), torch.zeros_like(ks), torch.zeros_like(vf)
    for k0 in range(0, s, key_tile):
        keys = slice(k0, k0 + key_tile)
        kt, vt = ks[..., keys, :], vf[..., keys, :]
        dkt, dvt = torch.zeros_like(kt), torch.zeros_like(vt)
        for q0 in range(0, s, query_tile):
            rows = slice(q0, q0 + query_tile)
            qt, gt = qs[..., rows, :], go[..., rows, :]
            p = torch.exp2(torch.matmul(qt, kt.transpose(-1, -2)) * log2e - lse[..., rows, :])
            ds = p * (torch.matmul(gt, vt.transpose(-1, -2)) - delta[..., rows, :])
            dvt += torch.matmul(p.transpose(-1, -2), gt)
            dkt += torch.matmul(ds.transpose(-1, -2), qt)
            dq[..., rows, :] += torch.matmul(ds, kt) * scale
        dk[..., keys, :] = dkt * scale
        dv[..., keys, :] = dvt
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_fwd_lse.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                            + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    for fn in (lib.flash_attention_fwd, lib.flash_attention_fwd_lse, lib.flash_attention_bwd):
        fn.restype = ctypes.c_int
    return lib


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; in f32 the flash backward kernel, in bf16 the JAX
    package's recompute backward (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.dtype != torch.float32:
            ctx.save_for_backward(q, k, v)
            return _flash_launch(q, k, v)
        o, lse = _flash_lse_launch(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_o):
        saved = ctx.saved_tensors
        if saved[0].dtype == torch.float32:  # q, k, v, o and the log-sum-exp
            grads = _flash_backward(*saved, grad_o)
            return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))
        inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, ctx.needs_input_grad)]
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
    the result is differentiable when autograd records: in f32 through the
    flash backward kernel, in bf16 by recomputing through
    :func:`attention_reference` (module docstring). The f32 result that
    records a gradient is a view of ``[B, S, H, D]`` storage, so merging its
    heads copies nothing.

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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raises on q, k, v the kernel does not take."""
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
    if q.shape[-1] not in (32, 64):
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} not built (32 or 64)")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q/k/v must start on 16-byte boundaries")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"flash_attention: {what} launch failed (cudaError {rc})")


def _flash_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on the current stream; counts it."""
    _check(q, k, v)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    scratch = None
    if q.dtype == torch.bfloat16 and d == 64:
        scratch = torch.empty_like(k)  # k * D^-0.25, written by the kernel's pre-pass
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                        None if scratch is None else scratch.data_ptr(),
                                        b * h, s, d, _DTYPE_CODES[q.dtype], d ** -0.25, stream)
    _raise_on(rc, "kernel")
    flash_attention.launches += 1
    return o


def _flash_lse_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The training forward (f32): one launch that returns o, a ``[B, H, S,
    D]`` view of ``[B, S, H, D]`` storage, and each row's log-sum-exp in
    base 2, ``[B, H, S4]`` (S rounded up to 4; the rows past S are unset).
    Counts as a launch of the forward."""
    _check(q, k, v)
    if q.dtype != torch.float32:
        raise ValueError(f"flash_attention: the log-sum-exp forward is f32, got {q.dtype}")
    b, h, s, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, (s + 3) // 4 * 4), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().flash_attention_fwd_lse(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                            o.data_ptr(), lse.data_ptr(), b * h, h, s, d,
                                            d ** -0.25, stream)
    _raise_on(rc, "kernel")
    flash_attention.launches += 1
    return o.transpose(1, 2), lse


def _flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                    lse: torch.Tensor, grad_o: torch.Tensor):
    """One launch of the backward kernel (with its pre-pass) on the current
    stream: (dq, dk, dv) of the f32 forward that gave ``o`` and ``lse``.
    o and grad_o may have any strides whose rows are whole 16-byte units;
    any other grad_o is copied first. Counts ``backward_launches``."""
    if (grad_o.stride(-1) != 1 or any(st % 4 for st in grad_o.stride()[:3])
            or grad_o.data_ptr() % 16):
        grad_o = grad_o.contiguous()
    b, h, s, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)  # rowsum(grad_o * o), written by the pre-pass
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *o.stride()[:3],
            grad_o.data_ptr(), *grad_o.stride()[:3], lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, h, s, d, d ** -0.25, stream)
    _raise_on(rc, "backward")
    flash_attention.backward_launches += 1
    return dq, dk, dv


flash_attention.launches = 0  # kernel launches of the forward since the last reset
flash_attention.backward_launches = 0  # launches of the backward kernel since the last reset
