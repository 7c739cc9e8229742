"""Weight-only int8 quantisation and its matrix product.

Counterpart of ``modular_audio_pipeline_tpu/ops/quant.py``. Autoregressive
decoding re-reads every decoder weight at every step and reuses it for a
few rows only (windows x beams), so it is bound by the bytes of the
weights; stored as int8 codes with one f32 scale per output column they
are half the bytes of bf16. ``compute_type="int8"`` quantises the decoder's
projections and adds a quantised copy of the embedding for the logits.

The kernel (``csrc/int8_matmul.cu``) replaces the Pallas
``_int8_matmul_kernel``: the codes cross device memory as int8 and are
converted next to the multiplier. ``int8_matmul_reference`` is its plain
PyTorch version, used for tensors on the CPU and as the oracle the kernel
is held against on the card. Both follow the Pallas kernel's arithmetic
(x rounded to bf16, f32 sum, the scale applied to the finished sum), not
the JAX package's other branch, which rounds ``code * scale`` to bf16
first and which the TPU takes for shapes its kernel's tiling rejects; the
CUDA kernel takes every shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Tuple

import torch

from . import _build

__all__ = ["quantize_weight", "int8_matmul", "int8_matmul_reference", "quantize_decoder"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: ``w [..., K, N] ~ wq * ws`` with
    one f32 scale per column (and per leading index). ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-2)


def int8_matmul_reference(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``x [..., K] @ dequant(wq [K, N]) -> [..., N]`` f32:
    x rounded to bf16, codes exact, f32 sum, then the per-column scale."""
    return (x.to(torch.bfloat16).float() @ wq.float()) * ws


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("int8_matmul").int8_matmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=4096)
def _splits(m: int, k: int, n: int) -> int:
    """How many blocks along K the kernel takes at this shape (few rows and
    a narrow output leave too few tiles to fill the card): above 1 it needs
    a workspace of that many partial sums."""
    fn = _build.load("int8_matmul").int8_matmul_splits
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(m, k, n)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ dequant(wq [K, N], ws [N]) -> [..., N]`` in f32.

    On a CUDA tensor this launches the hand-written kernel on the current
    stream, at any M, K and N (x bf16 or f32, rounded to bf16 on load),
    and raises on anything it does not take or on a failed launch; on a
    CPU tensor it runs :func:`int8_matmul_reference`.
    """
    if x.device.type == "cpu":
        return int8_matmul_reference(x, wq, ws)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if wq.dim() != 2 or x.dim() < 1 or x.shape[-1] != wq.shape[0] or ws.shape != wq.shape[1:]:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
                         f"ws {tuple(ws.shape)} do not fit [..., K] @ [K, N] * [N]")
    if x.dtype not in _DTYPE_CODES or wq.dtype != torch.int8 or ws.dtype != torch.float32:
        raise ValueError(f"int8_matmul: bf16 or f32 x, int8 codes and f32 scales, got "
                         f"{x.dtype}, {wq.dtype}, {ws.dtype}")
    if wq.device != x.device or ws.device != x.device:
        raise ValueError("int8_matmul: tensors on different devices")
    if not (wq.is_contiguous() and ws.is_contiguous()):
        raise ValueError("int8_matmul: codes and scales must be contiguous")
    k, n = wq.shape
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m > 0:
        with torch.cuda.device(x.device):
            splits = _splits(m, k, n)
            # freed on return while the kernels may still run: the caching
            # allocator hands the block only to later work on this stream
            work = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
                    if splits > 1 else None)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = _kernel()(x2.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
                           None if work is None else work.data_ptr(),
                           m, k, n, _DTYPE_CODES[x.dtype], stream)
        if rc != 0:
            raise RuntimeError(f"int8_matmul: kernel launch failed (cudaError {rc})")
        int8_matmul.launches += 1
    return out.reshape(x.shape[:-1] + (n,))


int8_matmul.launches = 0  # kernel launches since the last reset


def quantize_decoder(params: Dict[str, Any]) -> Dict[str, Any]:
    """A new tree with the decoder's projection weights quantised.

    Every ``*_w`` leaf of the decoder blocks' ``attn``, ``cross`` and
    ``mlp`` becomes ``*_wq`` (int8) + ``*_ws`` (f32 scales), per (layer,
    column) of the stacked ``[L, K, N]`` leaves; ``logits_wq [D, V]`` and
    ``logits_ws [V]`` are a quantised copy of the embedding for the logits
    (the table itself stays for the embedding gather). The encoder is
    shared with the input tree, not copied.
    """
    dec = dict(params["decoder"])
    blocks = {}
    for name, mod in dec["blocks"].items():
        if name not in ("attn", "cross", "mlp"):
            blocks[name] = mod
            continue
        new = {}
        for key, leaf in mod.items():
            if key.endswith("_w"):
                new[key + "q"], new[key + "s"] = quantize_weight(leaf)
            else:
                new[key] = leaf
        blocks[name] = new
    dec["blocks"] = blocks
    # [V, D] table: the logits contract over D, one scale per vocabulary entry
    dec["logits_wq"], dec["logits_ws"] = quantize_weight(dec["tok_emb"].t())
    dec["logits_wq"] = dec["logits_wq"].contiguous()
    return {"encoder": params["encoder"], "decoder": dec}
