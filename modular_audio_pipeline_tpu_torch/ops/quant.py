"""Weight-only int8 quantisation and its matrix product.

Counterpart of ``modular_audio_pipeline_tpu/ops/quant.py``. Autoregressive
decoding re-reads every decoder weight at every step and reuses it for a
few rows only (windows x beams), so it is bound by the bytes of the
weights; stored as int8 codes with one f32 scale per output column they
are half the bytes of bf16. ``compute_type="int8"`` quantises the decoder's
projections and adds a quantised copy of the embedding for the logits.

The kernel (``csrc/int8_matmul.cu``) replaces the Pallas
``_int8_matmul_kernel`` and, in the same launch, the bias add and the cast
that the JAX ``_proj`` applies to its result: the codes cross device
memory as int8 and are converted next to the multiplier, and the output
is stored once, in its final type. ``int8_matmul_reference`` is its plain
PyTorch version, used for tensors on the CPU and as the oracle the kernel
is held against on the card; ``int8_matmul_split_emulation`` writes out the
order in which the kernel adds when it splits K over a cluster. All follow
the Pallas kernel's arithmetic (x rounded to bf16, f32 sum, the scale
applied to the finished sum, then the bias in f32 and one rounding), not
the JAX package's other branch, which rounds ``code * scale`` to bf16
first and which the TPU takes for shapes its kernel's tiling rejects; the
CUDA kernel takes every shape. Codes stay in the JAX layout ``[K, N]``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["quantize_weight", "int8_matmul", "int8_matmul_reference",
           "int8_matmul_split_emulation", "quantize_decoder"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NO_BIAS = -1


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: ``w [..., K, N] ~ wq * ws`` with
    one f32 scale per column (and per leading index). ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-2)


def _finish(acc: torch.Tensor, ws: torch.Tensor, bias: Optional[torch.Tensor],
            out_dtype: torch.dtype) -> torch.Tensor:
    """The epilogue: scale the finished f32 sum, add the bias in f32, round
    once to ``out_dtype``."""
    out = acc * ws
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def int8_matmul_reference(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch ``x [..., K] @ dequant(wq [K, N]) (+ bias) -> [..., N]``:
    x rounded to bf16, codes exact, f32 sum, then the per-column scale, then
    the bias in f32, then one rounding to ``out_dtype``."""
    return _finish(x.to(torch.bfloat16).float() @ wq.float(), ws, bias, out_dtype)


def int8_matmul_split_emulation(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                                bias: Optional[torch.Tensor] = None,
                                out_dtype: torch.dtype = torch.float32,
                                k_slice: Optional[int] = None) -> torch.Tensor:
    """The kernel's order of arithmetic when it splits K over a cluster, in
    plain PyTorch: one f32 partial sum per slice of ``k_slice`` rows of K
    (the last takes what is left; on the card ``plan(m, k, n)["k_slice"]``),
    the partial sums added in rank order, then scale, bias and one
    rounding. (Inside a slice the tensor cores add in their own order, as
    any f32 product does.)"""
    k = wq.shape[0]
    xb = x.to(torch.bfloat16).float()
    step = k if k_slice is None else k_slice
    acc = None
    for k0 in range(0, k, step):
        part = xb[..., k0:k0 + step] @ wq[k0:k0 + step].float()
        acc = part if acc is None else acc + part
    return _finish(acc, ws, bias, out_dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("int8_matmul").int8_matmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """The kernel's plan for a shape: ``route`` (0: generic; 1: decode,
    ``cols`` columns per CTA, K split over a cluster of ``cluster`` CTAs of
    ``k_slice`` rows each; 2: wide, for more than 128 rows) and ``rows``
    (decode: x rows padded to the ``wgmma`` width). Needs the built library
    (the card's SM count enters the plan)."""
    fn = _build.load("int8_matmul").int8_matmul_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_int * 5)()
    if fn(m, k, n, _DTYPE_CODES[dtype], buf) != 0:
        raise ValueError(f"int8_matmul: no plan for M {m}, K {k}, N {n}")
    return dict(zip(("route", "rows", "cols", "cluster", "k_slice"), buf))


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``round_to(out_dtype, x [..., K] @ dequant(wq [K, N], ws [N]) + bias)``
    -> ``[..., N]``; ``bias`` ([N], f32 or bf16) is added in f32 after the
    scale, before the one rounding.

    On a CUDA tensor this makes one launch of the hand-written kernel on
    the current stream, at any M, K and N (x bf16 or f32, rounded to bf16
    on load), and raises on anything it does not take or on a failed
    launch; on a CPU tensor it runs :func:`int8_matmul_reference`.
    """
    if x.device.type == "cpu":
        return int8_matmul_reference(x, wq, ws, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if wq.dim() != 2 or x.dim() < 1 or x.shape[-1] != wq.shape[0] or ws.shape != wq.shape[1:]:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
                         f"ws {tuple(ws.shape)} do not fit [..., K] @ [K, N] * [N]")
    if x.dtype not in _DTYPE_CODES or wq.dtype != torch.int8 or ws.dtype != torch.float32:
        raise ValueError(f"int8_matmul: bf16 or f32 x, int8 codes and f32 scales, got "
                         f"{x.dtype}, {wq.dtype}, {ws.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_matmul: out_dtype must be f32 or bf16, got {out_dtype}")
    if bias is not None and (bias.shape != ws.shape or bias.dtype not in _DTYPE_CODES
                             or bias.device != x.device or not bias.is_contiguous()):
        raise ValueError(f"int8_matmul: bias must be a contiguous [N] f32 or bf16 tensor on "
                         f"{x.device}, got {tuple(bias.shape)} {bias.dtype} on {bias.device}")
    if wq.device != x.device or ws.device != x.device:
        raise ValueError("int8_matmul: tensors on different devices")
    if not (wq.is_contiguous() and ws.is_contiguous()):
        raise ValueError("int8_matmul: codes and scales must be contiguous")
    k, n = wq.shape
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m > 0:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = _kernel()(x2.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                           None if bias is None else bias.data_ptr(), out.data_ptr(),
                           m, k, n, _DTYPE_CODES[x.dtype],
                           _NO_BIAS if bias is None else _DTYPE_CODES[bias.dtype],
                           _DTYPE_CODES[out_dtype], stream)
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
