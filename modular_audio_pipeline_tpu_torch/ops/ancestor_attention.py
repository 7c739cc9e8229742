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

__all__ = ["ancestor_attention", "ancestor_attention_reference",
           "ancestor_attention_split_emulation"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _store_rows(ck_all, cv_all, ks_all, vs_all, layer, new_k, new_v, new_ks, new_vs, pos):
    """Write this step's rows ``[BK, H, 1, hd]`` (and ``[BK, H, 1]``
    scales) at position ``pos`` of layer ``layer``, in place. A ``pos``
    past the cache's end writes the last position: the JAX package's
    ``dynamic_update_slice`` clamps its start so."""
    pos = min(pos, ck_all.shape[3] - 1)
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


def ancestor_attention_split_emulation(
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
    split: int = 2,
) -> torch.Tensor:
    """The kernel's arithmetic when ``split`` blocks share the positions,
    in plain PyTorch: scores per chunk of positions, the max over the
    chunks' maxima, the chunks' sums of exp added in chunk order, every
    weight normalised by that global sum, scaled and rounded to q's type
    once, then the chunks' f32 PV sums added in chunk order. The order of
    rounding is :func:`ancestor_attention_reference`'s; only the order of
    the f32 sums differs. Nothing on the main path calls this: the CPU
    tests hold it against the JAX package.
    """
    if new_k is not None:
        _store_rows(ck_all, cv_all, ks_all, vs_all, layer, new_k, new_v, new_ks, new_vs, pos)
    bw, kq, ctx = anc.shape
    bk, h, _, hd = q_scaled.shape
    dt = q_scaled.dtype
    rows = (anc.long() + torch.arange(bw, device=anc.device)[:, None, None] * kq).reshape(bk, ctx)
    sidx = rows[:, None, :].expand(bk, h, ctx)
    idx = sidx[..., None].expand(bk, h, ctx, hd)
    k_sel = torch.gather(ck_all[layer], 0, idx).to(dt).float()
    v_sel = torch.gather(cv_all[layer], 0, idx).to(dt).float()
    chunk = -(-ctx // split)
    bounds = [(c0, min(ctx, c0 + chunk)) for c0 in range(0, ctx, chunk)]
    scores = torch.cat([
        torch.einsum("rhd,rhpd->rhp", q_scaled[:, :, 0].float(), k_sel[:, :, c0:c1])
        for c0, c1 in bounds], dim=-1)
    if ks_all is not None:
        scores = scores * torch.gather(ks_all[layer], 0, sidx)
    scores = scores + mask_row
    mx = torch.stack([scores[..., c0:c1].amax(dim=-1) for c0, c1 in bounds]).amax(dim=0)
    ex = torch.exp(scores - mx[..., None])
    total = torch.zeros_like(mx)
    for c0, c1 in bounds:
        total = total + ex[..., c0:c1].sum(dim=-1)
    probs = ex / total[..., None]
    if vs_all is not None:
        probs = probs * torch.gather(vs_all[layer], 0, sidx)
    w = probs.to(dt).float()
    y = torch.zeros((bk, h, hd), dtype=torch.float32, device=q_scaled.device)
    for c0, c1 in bounds:
        y = y + torch.einsum("rhp,rhpd->rhd", w[..., c0:c1], v_sel[:, :, c0:c1])
    return y.to(dt)[:, :, None]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("ancestor_attention").ancestor_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
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
    if one != 1 or bk != bw * kq or hd not in (32, 64) or kq > 32:
        raise ValueError(f"ancestor_attention: q {tuple(q.shape)} vs anc {tuple(anc.shape)} "
                         f"(head dim 32 or 64, at most 32 beams)")
    if ck_all.shape != (n_layers, bk, h, ctx, hd) or cv_all.shape != ck_all.shape:
        raise ValueError(f"ancestor_attention: cache {tuple(ck_all.shape)} does not match")
    if ks_all is not None and (ks_all.shape != ck_all.shape[:-1] or vs_all.shape != ks_all.shape):
        raise ValueError("ancestor_attention: scales do not match the cache")
    if mask_row.shape != (ctx,) or not 0 <= layer < n_layers:
        raise ValueError("ancestor_attention: bad mask_row shape or layer index")


def _rows_fit_kernel(q, ck_all, new_k, new_v, new_ks, new_vs) -> bool:
    """Whether the kernel can take this step's rows as they are: the
    cache's type, ``[BK, H, 1, hd]`` (scales ``[BK, H, 1]`` f32 with an
    int8 cache), contiguous, on 16-byte boundaries, on q's device."""
    quant = ck_all.dtype == torch.int8
    if quant != (new_ks is not None) or quant != (new_vs is not None):
        return False
    for t in (new_k, new_v):
        if (t.dtype != ck_all.dtype or t.shape != q.shape or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            return False
    if quant:
        for t in (new_ks, new_vs):
            if (t.dtype != torch.float32 or t.shape != q.shape[:3] or t.device != q.device
                    or not t.is_contiguous()):
                return False
    return True


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
    split: int = 0,
) -> torch.Tensor:
    """Beam self-attention over an un-permuted stacked KV cache.

    Returns ``y [BK, H, 1, hd]`` and MUTATES the cache: with
    ``new_k``/``new_v`` (and the int8 scales) this step's rows are stored
    at ``pos`` of layer ``layer`` in place (at the last position when
    ``pos`` is at or past the context, as the JAX package clamps it), and
    attention reads them with the rest. On CUDA tensors the kernel itself reads the new rows at
    ``pos`` and stores them (contiguous rows of the cache's type; anything
    else is stored by one small copy per tensor right before the launch);
    it runs on the current stream and raises on anything it does not take
    or on a failed launch. On CPU tensors this is
    :func:`ancestor_attention_reference`.

    ``split`` (CUDA only) is the number of blocks that share the positions
    of one (window, head), 1 to 8; 0 lets the kernel's launcher choose from
    the shape. It changes the order of the f32 sums and nothing else.
    """
    if q_scaled.device.type == "cpu":
        return ancestor_attention_reference(
            q_scaled, ck_all, cv_all, ks_all, vs_all, layer, anc, mask_row,
            new_k, new_v, new_ks, new_vs, pos,
        )
    if q_scaled.device.type != "cuda":
        raise ValueError(f"ancestor_attention: unsupported device {q_scaled.device}")
    _check(q_scaled, ck_all, cv_all, ks_all, vs_all, layer, anc, mask_row)
    bw, kq, ctx = anc.shape
    rows = (None, None, None, None, -1)
    if new_k is not None:
        if pos < 0:
            raise ValueError(f"ancestor_attention: negative pos {pos}")
        if _rows_fit_kernel(q_scaled, ck_all, new_k, new_v, new_ks, new_vs):
            rows = (new_k.data_ptr(), new_v.data_ptr(),
                    None if new_ks is None else new_ks.data_ptr(),
                    None if new_vs is None else new_vs.data_ptr(), pos)
        else:
            _store_rows(ck_all, cv_all, ks_all, vs_all, layer, new_k, new_v, new_ks, new_vs, pos)
    _, h, _, hd = q_scaled.shape
    y = torch.empty_like(q_scaled)
    # layer `layer` of the stacked tensors by address: no slice objects on a
    # path that runs once per decoder layer per step
    ck, cv = (t.data_ptr() + layer * t.stride(0) * t.element_size() for t in (ck_all, cv_all))
    ks = vs = None
    if ks_all is not None:
        ks, vs = (t.data_ptr() + layer * t.stride(0) * 4 for t in (ks_all, vs_all))
    if (ck | cv) % 16:
        raise ValueError("ancestor_attention: the cache must start on a 16-byte boundary")
    args = (q_scaled.data_ptr(), ck, cv, ks, vs, anc.data_ptr(), mask_row.data_ptr(),
            y.data_ptr(), *rows, bw, kq, h, ctx, hd, _DTYPE_CODES[q_scaled.dtype],
            _DTYPE_CODES[ck_all.dtype], split)
    dev = q_scaled.device
    if dev.index == torch.cuda.current_device():  # the usual case, without the guard's cost
        rc = _kernel()(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = _kernel()(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ancestor_attention: kernel launch failed (cudaError {rc})")
    ancestor_attention.launches += 1
    return y


ancestor_attention.launches = 0  # kernel launches since the last reset
