"""Flash attention for the Whisper encoder: CUDA kernel and plain version.

Counterpart of ``modular_audio_pipeline_tpu/ops/attention.py``. The
kernel (``csrc/flash_attention.cu``) replaces the Pallas ``_flash_kernel``;
``attention_reference`` is its plain PyTorch version, used for tensors on
the CPU and as the oracle the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["flash_attention", "attention_reference"]

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


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Whisper encoder self-attention ``[B, H, S, D] -> [B, H, S, D]``.

    On a CUDA tensor this launches the hand-written kernel on the current
    stream (contiguous bf16 or f32, D of 32 or 64) and raises on anything
    it does not take or on a failed launch; on a CPU tensor it runs
    :func:`attention_reference`. Forward only.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
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
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       b * h, s, d, _DTYPE_CODES[q.dtype], d ** -0.25, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed (cudaError {rc})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0  # kernel launches since the last reset
