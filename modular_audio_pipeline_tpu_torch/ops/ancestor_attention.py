"""Ancestry-indexed beam self-attention for the decode loop.

Counterpart of ``modular_audio_pipeline_tpu/ops/ancestor_attention.py``.
Beam search never permutes the KV cache: each beam row writes its own K/V
at ``pos``, and a small table ``anc[b, k, p]`` records which beam row of
window ``b`` holds hypothesis ``k``'s token at position ``p``. Attention
then reads, for every hypothesis, position ``p`` from row ``anc[b, k, p]``.

The kernel (``csrc/ancestor_attention.cu``) replaces the Pallas ``_kernel``;
``ancestor_attention_reference`` is its plain PyTorch version, used for
tensors on the CPU and as the oracle on the card. Unlike the JAX
functions, both write this step's rows into the cache IN PLACE and return
only ``y``: the cache is a tensor the decode loop owns, and updating it in
place saves a copy of it per step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

__all__ = ["ancestor_attention", "ancestor_attention_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _store_rows(ck_all, cv_all, ks_all, vs_all, layer, new_k, new_v, new_ks, new_vs, pos):
    """Write this step's rows ``[BK, H, 1, hd]`` (and ``[BK, H, 1]``
    scales) at position ``pos`` of layer ``layer``, in place."""
    ck_all[layer, :, :, pos] = new_k[:, :, 0]
    cv_all[layer, :, :, pos] = new_v[:, :, 0]
    if ks_all is not None:
        ks_all[layer, :, :, pos] = new_ks[:, :, 0]
        vs_all[layer, :, :, pos] = new_vs[:, :, 0]


def ancestor_attention_reference(
    q_scaled: torch.Tensor,  # [BK, H, 1, hd], already carries the full qk scale
    ck_all: torch.Tensor,  # [L, BK, H, ctx, hd] stacked cache (bf16/f32 or int8 codes)
    cv_all: torch.Tensor,
    ks_all: Optional[torch.Tensor],  # [L, BK, H, ctx] f32 int8 dequant scales
    vs_all: Optional[torch.Tensor],
    layer: int,
    anc: torch.Tensor,  # [BW, K, ctx] int32 ancestor table
    mask_row: torch.Tensor,  # [ctx] f32 additive position mask
    new_k: Optional[torch.Tensor] = None,  # [BK, H, 1, hd] this step's rows
    new_v: Optional[torch.Tensor] = None,
    new_ks: Optional[torch.Tensor] = None,  # [BK, H, 1] their scales
    new_vs: Optional[torch.Tensor] = None,
    pos: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch ancestry attention -> ``y [BK, H, 1, hd]``.

    Stores the new rows (if given) at ``pos`` first, then gathers each
    hypothesis's selected K/V rows and attends: scores are f32 sums of the
    operands in q's type, times the K scales, plus the mask; the softmax is
    f32; probabilities times the V scales are rounded to q's type before
    the f32-accumulated product, and y is rounded to q's type.
    """
    if new_k is not None:
        _store_rows(ck_all, cv_all, ks_all, vs_all, layer, new_k, new_v, new_ks, new_vs, pos)
    bw, kq, ctx = anc.shape
    bk, h, _, hd = q_scaled.shape
    dt = q_scaled.dtype
    # flat beam row holding hypothesis r's position p
    rows = (anc.long() + torch.arange(bw, device=anc.device)[:, None, None] * kq).reshape(bk, ctx)
    sidx = rows[:, None, :].expand(bk, h, ctx)
    idx = sidx[..., None].expand(bk, h, ctx, hd)
    k_sel = torch.gather(ck_all[layer], 0, idx).to(dt).float()
    v_sel = torch.gather(cv_all[layer], 0, idx).to(dt).float()
    scores = torch.einsum("rhd,rhpd->rhp", q_scaled[:, :, 0].float(), k_sel)
    if ks_all is not None:
        scores = scores * torch.gather(ks_all[layer], 0, sidx)
    probs = torch.softmax(scores + mask_row, dim=-1)
    if vs_all is not None:
        probs = probs * torch.gather(vs_all[layer], 0, sidx)
    y = torch.einsum("rhp,rhpd->rhd", probs.to(dt).float(), v_sel).to(dt)
    return y[:, :, None]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("ancestor_attention").ancestor_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, ck_all, cv_all, ks_all, vs_all, layer, anc, mask_row):
    dev = q.device
    tensors = [q, ck_all, cv_all, anc, mask_row] + (
        [ks_all, vs_all] if ks_all is not None else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("ancestor_attention: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ancestor_attention: tensors must be contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ancestor_attention: q must be bf16 or f32, got {q.dtype}")
    if ck_all.dtype != cv_all.dtype:
        raise ValueError("ancestor_attention: K and V caches differ in type")
    if ck_all.dtype == torch.int8:
        if ks_all is None or vs_all is None:
            raise ValueError("ancestor_attention: an int8 cache needs its scales")
        if ks_all.dtype != torch.float32 or vs_all.dtype != torch.float32:
            raise ValueError("ancestor_attention: scales must be f32")
    elif ck_all.dtype != q.dtype or ks_all is not None:
        raise ValueError("ancestor_attention: an unquantised cache has q's type and no scales")
    if anc.dtype != torch.int32 or mask_row.dtype != torch.float32:
        raise ValueError("ancestor_attention: anc must be int32 and mask_row f32")
    bw, kq, ctx = anc.shape
    bk, h, one, hd = q.shape
    n_layers = ck_all.shape[0]
    if one != 1 or bk != bw * kq or hd not in (32, 64):
        raise ValueError(f"ancestor_attention: q {tuple(q.shape)} vs anc {tuple(anc.shape)}")
    if ck_all.shape != (n_layers, bk, h, ctx, hd) or cv_all.shape != ck_all.shape:
        raise ValueError(f"ancestor_attention: cache {tuple(ck_all.shape)} does not match")
    if ks_all is not None and (ks_all.shape != ck_all.shape[:-1] or vs_all.shape != ks_all.shape):
        raise ValueError("ancestor_attention: scales do not match the cache")
    if mask_row.shape != (ctx,) or not 0 <= layer < n_layers:
        raise ValueError("ancestor_attention: bad mask_row shape or layer index")


def ancestor_attention(
    q_scaled: torch.Tensor,
    ck_all: torch.Tensor,
    cv_all: torch.Tensor,
    ks_all: Optional[torch.Tensor],
    vs_all: Optional[torch.Tensor],
    layer: int,
    anc: torch.Tensor,
    mask_row: torch.Tensor,
    new_k: Optional[torch.Tensor] = None,
    new_v: Optional[torch.Tensor] = None,
    new_ks: Optional[torch.Tensor] = None,
    new_vs: Optional[torch.Tensor] = None,
    pos: Optional[int] = None,
) -> torch.Tensor:
    """Beam self-attention over an un-permuted stacked KV cache.

    Returns ``y [BK, H, 1, hd]`` and MUTATES the cache: with
    ``new_k``/``new_v`` (and the int8 scales) this step's rows are stored
    at ``pos`` of layer ``layer`` in place, then attention reads them with
    the rest. On CUDA tensors the row store is one small copy per tensor
    immediately before the kernel launch, on the current stream; the
    kernel raises on anything it does not take or on a failed launch. On
    CPU tensors this is :func:`ancestor_attention_reference`.
    """
    if q_scaled.device.type == "cpu":
        return ancestor_attention_reference(
            q_scaled, ck_all, cv_all, ks_all, vs_all, layer, anc, mask_row,
            new_k, new_v, new_ks, new_vs, pos,
        )
    if q_scaled.device.type != "cuda":
        raise ValueError(f"ancestor_attention: unsupported device {q_scaled.device}")
    _check(q_scaled, ck_all, cv_all, ks_all, vs_all, layer, anc, mask_row)
    if new_k is not None:
        _store_rows(ck_all, cv_all, ks_all, vs_all, layer, new_k, new_v, new_ks, new_vs, pos)
    bw, kq, ctx = anc.shape
    _, h, _, hd = q_scaled.shape
    y = torch.empty_like(q_scaled)
    scales = (ks_all[layer].data_ptr(), vs_all[layer].data_ptr()) if ks_all is not None else (None, None)
    with torch.cuda.device(q_scaled.device):
        stream = torch.cuda.current_stream(q_scaled.device).cuda_stream
        rc = _kernel()(
            q_scaled.data_ptr(), ck_all[layer].data_ptr(), cv_all[layer].data_ptr(),
            *scales, anc.data_ptr(), mask_row.data_ptr(), y.data_ptr(),
            bw, kq, h, ctx, hd, _DTYPE_CODES[q_scaled.dtype], _DTYPE_CODES[ck_all.dtype],
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"ancestor_attention: kernel launch failed (cudaError {rc})")
    ancestor_attention.launches += 1
    return y


ancestor_attention.launches = 0  # kernel launches since the last reset
