"""Absorbed MLA decode attention for DeepSeek-V2: the CUDA kernel's launcher.

The kernel (``csrc/mla_decode.cu``) replaces no TPU kernel: the JAX package
has no DeepSeek-V2. It is the decode step's attention on the card
(``models/lm/deepseek_v2.decode_step``); the CPU keeps the plain version,
``_absorbed_attention``, which is also the oracle the kernel is held to,
and ``mla_decode_emulation`` beside it writes out the kernel's arithmetic.
The context is cut into splits of whole tiles (:func:`plan`), about one
block an SM.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import _build

__all__ = ["mla_decode", "plan", "TILE", "SHAPES", "LAUNCHES"]

TILE = 32  # positions a tile (``kTile``)
LAUNCHES = 3  # kernel launches a call: absorb, split attention, combine
SM_COUNT = 132  # an H100 SXM's SMs: the split the CPU's emulation assumes
# (heads, kv_lora_rank, rope, nope, v) the kernel is built for:
# deepseek-v2-lite and test-small
SHAPES = {(16, 512, 64, 128, 128), (4, 32, 16, 16, 16)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def plan(ctx: int, batch: int, sms: int = SM_COUNT) -> Tuple[int, int]:
    """(positions a split, splits) for a cache of ``ctx`` positions at
    ``batch`` sequences: the fewest whole tiles a split that give at most
    ``sms // batch`` splits (at least one), so that the blocks fill the SMs
    once."""
    tiles = math.ceil(ctx / TILE)
    chunk = TILE * math.ceil(tiles / max(1, sms // batch))
    return chunk, math.ceil(ctx / chunk)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("mla_decode")
    lib.mla_decode.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    lib.mla_decode.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q_nope, q_pe, c_kv, k_pe, w_kvb, pos) -> None:
    """Raises on inputs the kernel does not take. ``pos`` is not read on
    the host, so that the call can be captured: the caller keeps it in
    ``[0, T)`` (``forward`` and ``DecodeGraph`` check the position on the
    host before a step), and the kernel clamps a position outside it."""
    ts = (q_nope, q_pe, c_kv, k_pe, w_kvb, pos)
    if any(t.device != q_nope.device for t in ts) or q_nope.device.type != "cuda":
        raise ValueError(f"mla_decode: every input on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if q_nope.dtype not in _DTYPE_CODES or any(t.dtype != q_nope.dtype for t in ts[1:5]):
        raise ValueError(f"mla_decode: bf16 or f32 inputs of one type, got "
                         f"{[t.dtype for t in ts[:5]]}")
    if pos.dim() != 0 or pos.dtype != torch.int64:
        raise ValueError(f"mla_decode: pos must be a 0-d int64 tensor, got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if q_nope.dim() != 3 or q_pe.dim() != 3 or c_kv.dim() != 3 or k_pe.dim() != 3:
        raise ValueError("mla_decode: q_nope/q_pe [B, H, d], c_kv/k_pe [B, T, d]")
    b, h, nope = q_nope.shape
    t, r = c_kv.shape[1:]
    rope = q_pe.shape[-1]
    if (q_pe.shape[:2] != (b, h) or c_kv.shape[0] != b or k_pe.shape != (b, t, rope)
            or w_kvb.dim() != 2 or w_kvb.shape[0] != r or w_kvb.shape[1] % h):
        raise ValueError(f"mla_decode: shapes do not agree: q_nope {tuple(q_nope.shape)}, q_pe "
                         f"{tuple(q_pe.shape)}, c_kv {tuple(c_kv.shape)}, k_pe "
                         f"{tuple(k_pe.shape)}, w_kvb {tuple(w_kvb.shape)}")
    dv = w_kvb.shape[1] // h - nope
    if (h, r, rope, nope, dv) not in SHAPES:
        raise ValueError(f"mla_decode: (heads, rank, rope, nope, v) = {(h, r, rope, nope, dv)} "
                         f"not built; built: {sorted(SHAPES)}")
    if q_nope.stride(-1) != 1 or q_pe.stride(-1) != 1:
        raise ValueError("mla_decode: q_nope and q_pe need a contiguous last dim")
    if not (c_kv.is_contiguous() and k_pe.is_contiguous() and w_kvb.is_contiguous()):
        raise ValueError("mla_decode: c_kv, k_pe and w_kvb must be contiguous")
    if any(x.data_ptr() % 16 for x in (c_kv, k_pe, w_kvb)):
        raise ValueError("mla_decode: c_kv, k_pe and w_kvb must start on 16-byte boundaries")
    if b > 65535:
        raise ValueError(f"mla_decode: batch {b} over 65535")


def mla_decode(q_nope: torch.Tensor, q_pe: torch.Tensor, c_kv: torch.Tensor, k_pe: torch.Tensor,
               w_kvb: torch.Tensor, pos: torch.Tensor, scale: float) -> torch.Tensor:
    """One query a sequence over the latent cache on the card: q_nope ``[B, H,
    nope]``, q_pe ``[B, H, rope]`` (any strides with a contiguous last dim),
    c_kv ``[B, T, R]``, k_pe ``[B, T, rope]``, w_kvb ``[R, H (nope + v)]``,
    ``pos`` a 0-d int64 device tensor (positions up to it are attended) ->
    ``[B, H, v]`` in q's type; f32 arithmetic throughout, one rounding at
    the end. Three launches on the current stream (absorb, split attention,
    combine and un-absorb), which read ``pos`` on the device, so they can
    be captured in a CUDA graph. Raises on inputs the kernel does not take
    and on a failed launch; counts its launches in
    :attr:`mla_decode.launches`."""
    _check(q_nope, q_pe, c_kv, k_pe, w_kvb, pos)
    b, h, nope = q_nope.shape
    t, r = c_kv.shape[1:]
    rope = q_pe.shape[-1]
    dv = w_kvb.shape[1] // h - nope
    dev = q_nope.device
    chunk, n_split = plan(t, b, _sms(dev.index if dev.index is not None
                                     else torch.cuda.current_device()))
    qf = torch.empty((b, h, r + rope), dtype=torch.float32, device=dev)
    part_o = torch.empty((b, n_split, h, r), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, n_split, h, 2), dtype=torch.float32, device=dev)
    out = torch.empty((b, h, dv), dtype=q_nope.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().mla_decode(
            q_nope.data_ptr(), q_nope.stride(0), q_nope.stride(1), q_pe.data_ptr(),
            q_pe.stride(0), q_pe.stride(1), c_kv.data_ptr(), k_pe.data_ptr(), w_kvb.data_ptr(),
            pos.data_ptr(), qf.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
            b, t, h, r, rope, nope, dv, chunk, n_split, _DTYPE_CODES[q_nope.dtype], scale, stream)
    if rc != 0:
        raise RuntimeError(f"mla_decode: launch failed (cudaError {rc})")
    mla_decode.launches += LAUNCHES
    return out


mla_decode.launches = 0  # kernel launches since the last reset, ``LAUNCHES`` a layer
