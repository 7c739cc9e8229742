"""Whisper encoder/decoder as plain functions on tensors (PyTorch).

Counterpart of ``modular_audio_pipeline_tpu/models/whisper/model.py``. The
parameter tree and the KV cache keep the JAX package's stacked ``[L, ...]``
layout (projections stored ``[in, out]``), so ``params.npz`` bundles load
unchanged; ``lax.scan`` over layers becomes a Python loop over the layer
index. Layer norms, attention scores and softmaxes run in f32; projections
run in the parameters' type, as the JAX path rounds them.

The encoder's self-attention is the flash-attention kernel
(``ops/attention.py``); the beam decode step's self-attention is the
ancestry-attention kernel (``ops/ancestor_attention.py``), which writes
this step's rows into the cache in place. With a quantised tree
(``ops/quant.quantize_decoder``) the decoder's projections, the cross K/V
and the logits run through the weight-only int8 kernel (``ops/quant.py``).
All three take their plain versions for tensors on the CPU.

A tree from ``parallel/sharding.shard_params`` holds this rank's slices
over the mesh's ``model`` axis (Megatron tensor parallelism): each rank
runs ``n_head / tp`` heads, Q/K/V and MLP-up are column parallel,
the attention output and MLP-down are row parallel (each rank's partial
product in f32, one f32 all-reduce over the model group, the replicated
bias added once, one rounding to the activations' type), the embedding
rows are a feature slice gathered before the first LayerNorm, and the f32
logits are all-reduced partial products over the sharded features. With
a whole tree (or a model group of 1) every line computes what it
computes without a mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.ancestor_attention import ancestor_attention
from ...ops.attention import flash_attention
from ...exceptions import ShardingError
from ...ops.quant import int8_matmul
from ...parallel.sharding import (
    ModelGroup,
    copy_to_model,
    gather_from_model,
    model_group,
    reduce_from_model,
)
from .config import WhisperDims

__all__ = [
    "KVCache", "padded_vocab", "sinusoids", "encoder_forward", "cross_kv",
    "decoder_forward", "init_params", "local_heads",
]

Params = Dict[str, Any]


def padded_vocab(n_vocab: int) -> int:
    """Vocab rounded up to a multiple of 128: the JAX package pads the
    embedding table with zero rows (its TPU tiling); the port keeps the
    pad so ``params.npz`` loads unchanged, and slices logits to n_vocab."""
    return ((n_vocab + 127) // 128) * 128


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper's fixed sinusoidal positions for the audio encoder."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (y * g.float() + b.float()).to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ w (+ b)`` in x's type; w is ``[in, out]``. With a bias this is
    one addmm, so the bias joins the product before the single rounding."""
    x2 = x.reshape(-1, x.shape[-1])
    y = torch.addmm(b, x2, w) if b is not None else x2 @ w
    return y.reshape(x.shape[:-1] + (w.shape[1],))


def _row_linear(y: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                mg: Optional[ModelGroup]) -> torch.Tensor:
    """A row-parallel ``y @ w (+ b)``: ``y``'s features and ``w``'s rows are
    this rank's slice. The partial product is f32, the model group sums it
    in f32, the bias joins once and the result is rounded once to y's type
    (:func:`_linear` without a model group)."""
    if mg is None:
        return _linear(y, w, b)
    part = torch.matmul(y.reshape(-1, y.shape[-1]).float(), w.float())
    part = reduce_from_model(part, mg)
    if b is not None:
        part = part + b.float()
    return part.to(y.dtype).reshape(y.shape[:-1] + (w.shape[1],))


def _col_in(y: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """The replicated input of column-parallel projections (its gradient
    is summed over the model group)."""
    return y if mg is None else copy_to_model(y, mg)


def local_heads(n_head: int, params) -> int:
    """Heads this rank runs: ``n_head / tp`` for a sharded tree."""
    mg = model_group(params)
    if mg is None:
        return n_head
    if n_head % mg.size:
        raise ShardingError(f"{n_head} heads do not split over a model axis of {mg.size}")
    return n_head // mg.size


def _proj(y: torch.Tensor, mod: Dict[str, Any], name: str,
          mg: Optional[ModelGroup] = None) -> torch.Tensor:
    """Projection that dispatches on quantisation: ``name_w`` (the
    parameters' type; row parallel when a row-parallel projection, ``o`` or
    ``fc2``, passes its model group ``mg``) or ``name_wq``/``name_ws``
    (weight-only int8, never sharded: one kernel launch that scales the f32
    sum, adds the bias in f32 and rounds once to y's type, as the JAX
    ``_proj`` does in three operations)."""
    wq = mod.get(f"{name}_wq")
    bias = mod.get(f"{name}_b")
    if wq is None:
        return _row_linear(y, mod[f"{name}_w"], bias, mg)
    return int8_matmul(y, wq, mod[f"{name}_ws"], bias, y.dtype)


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, hd]"""
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, hd] -> [B, T, D]"""
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _attention(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Scaled dot-product attention; Whisper scales q and k by hd^-0.25."""
    scale = q.shape[-1] ** -0.25
    logits = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def _layer(tree: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer ``l`` of a stacked ``[L, ...]`` parameter subtree (views)."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l] for k, v in tree.items()}


@dataclass
class KVCache:
    """Pre-allocated decoder self-attention cache, updated in place.

    ``k``/``v``: [L, B, H, ctx, hd]; ``pos``: next write index (host int).
    In int8 mode ``k``/``v`` hold symmetric per-position int8 codes and
    ``k_scale``/``v_scale`` ([L, B, H, ctx] f32) the dequantisation scales,
    which fold exactly into attention (K scales multiply scores after QK,
    V scales multiply probabilities before PV).
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(dims: WhisperDims, batch: int, dtype: torch.dtype, ctx: Optional[int] = None,
              quant: bool = False, device="cpu", heads: Optional[int] = None) -> "KVCache":
        """``heads``: this rank's heads under tensor parallelism
        (:func:`local_heads`; default all of ``dims.n_text_head``)."""
        shape = (
            dims.n_text_layer, batch, heads if heads is not None else dims.n_text_head,
            ctx if ctx is not None else dims.n_text_ctx,
            dims.n_text_state // dims.n_text_head,
        )
        if quant:
            return KVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            )
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )


def _quantize_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-position int8 quantisation over the head dim.

    ``rows [..., hd]`` -> (int8 codes, f32 scales ``[...]``); dequantisation
    is ``codes * scales[..., None]``. ``torch.round`` rounds half to even,
    as ``jnp.round`` does.
    """
    f32 = rows.float()
    scale = torch.clamp(f32.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    q = torch.round(f32 / scale).to(torch.int8)
    return q, scale[..., 0]


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encoder_forward(params: Params, dims: WhisperDims, mel: torch.Tensor) -> torch.Tensor:
    """``mel [B, n_mels, T]`` -> audio states ``[B, T//2, d]``."""
    enc = params["encoder"]
    dtype = enc["conv1"]["w"].dtype
    x = mel.to(dtype)
    # torch.conv1d's [out, in, k] weight layout is JAX's NCT/OIT layout.
    x = F.conv1d(x, enc["conv1"]["w"], padding=1) + enc["conv1"]["b"][None, :, None]
    x = F.gelu(x)  # exact erf GELU (approximate=False), as the JAX path
    x = F.conv1d(x, enc["conv2"]["w"], stride=2, padding=1) + enc["conv2"]["b"][None, :, None]
    x = F.gelu(x)

    x = x.transpose(1, 2)  # [B, T', d]
    x = x + torch.from_numpy(sinusoids(x.shape[1], dims.n_audio_state)).to(x.device, dtype)

    mg = model_group(params)
    h = local_heads(dims.n_audio_head, params)
    for l in range(dims.n_audio_layer):
        p = _layer(enc["blocks"], l)
        resid = x
        y = _col_in(_layer_norm(x, p["attn_ln"]["g"], p["attn_ln"]["b"]), mg)
        q = _split_heads(_linear(y, p["attn"]["q_w"], p["attn"]["q_b"]), h).contiguous()
        k = _split_heads(_linear(y, p["attn"]["k_w"], None), h).contiguous()
        v = _split_heads(_linear(y, p["attn"]["v_w"], p["attn"]["v_b"]), h).contiguous()
        y = _merge_heads(flash_attention(q, k, v))
        x = resid + _row_linear(y, p["attn"]["o_w"], p["attn"]["o_b"], mg)

        resid = x
        y = _col_in(_layer_norm(x, p["mlp_ln"]["g"], p["mlp_ln"]["b"]), mg)
        y = F.gelu(_linear(y, p["mlp"]["fc1_w"], p["mlp"]["fc1_b"]))
        x = resid + _row_linear(y, p["mlp"]["fc2_w"], p["mlp"]["fc2_b"], mg)
    return _layer_norm(x, enc["ln_post"]["g"], enc["ln_post"]["b"])


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def cross_kv(params: Params, dims: WhisperDims, xa: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer cross-attention K/V from the encoder output, each
    ``[L, B, H, T_audio, hd]``: computed once per window batch."""
    blocks = params["decoder"]["blocks"]
    h = local_heads(dims.n_text_head, params)
    xa = _col_in(xa, model_group(params))
    ks, vs = [], []
    for l in range(dims.n_text_layer):
        p = _layer(blocks, l)["cross"]
        ks.append(_split_heads(_proj(xa, p, "k"), h))
        vs.append(_split_heads(_proj(xa, p, "v"), h))
    return torch.stack(ks), torch.stack(vs)


def _cross_attention(qx: torch.Tensor, xk, xv, dtype, return_probs: bool = False):
    """Attention of the decoder queries over one layer's audio K/V ->
    ``(y, probs)``.

    With a beam-expanded token batch (B*K rows against B windows) the
    audio K/V is shared across each window's beams by a grouped product
    instead of being repeated. ``xk``/``xv`` are either tensors or int8
    ``(codes, scales)`` pairs, whose scales fold into the scores after QK
    and into the probabilities before PV. ``return_probs`` (unquantised
    K/V, one query row per window row) also returns the f32 softmax rounded
    to float16, ``[B, H, S, T]``, for the word alignment: post-softmax
    values in [0, 1] that are standardised per head downstream, where
    bf16's 8 mantissa bits moved DTW paths; otherwise ``probs`` is None.
    """
    quant = isinstance(xk, tuple)
    kb = (xk[0] if quant else xk).shape[0]
    groups = qx.shape[0] // kb
    bq, h, s, hd = qx.shape
    if return_probs and (quant or groups != 1):
        raise ValueError("cross-attention probabilities need unquantised audio K/V "
                         "and one token row per window")
    # [kb*G, H, S, hd] -> [kb, H, G*S, hd]: each window's beams become rows
    # of one product with that window's K/V (no broadcast copy of K/V).
    qx = qx.reshape(kb, groups, h, s, hd).transpose(1, 2).reshape(kb, h, groups * s, hd)
    out_probs = None
    if quant:
        (xk_q, xk_s), (xv_q, xv_s) = xk, xv
        qxs = (qx * hd ** -0.5).to(dtype)
        logits = torch.matmul(qxs.float(), xk_q.float().transpose(-1, -2))  # codes exact in f32
        probs = torch.softmax(logits * xk_s[:, :, None, :], dim=-1) * xv_s[:, :, None, :]
        y = torch.matmul(probs.to(dtype).float(), xv_q.float())
    else:
        scale = hd ** -0.25
        logits = torch.matmul((qx * scale).float(), (xk * scale).float().transpose(-1, -2))
        probs = torch.softmax(logits, dim=-1)
        y = torch.matmul(probs.to(dtype).float(), xv.float())
        if return_probs:
            out_probs = probs.to(torch.float16)
    y = y.to(dtype).reshape(kb, h, groups, s, hd).transpose(1, 2)
    return y.reshape(bq, h, s, hd), out_probs


def _pos_rows(pos_emb: torch.Tensor, pos0: int, s: int) -> torch.Tensor:
    """Positional rows of positions ``pos0 .. pos0 + s - 1``: a position
    past the table (the seek loop's long prompt runs past ``n_text_ctx``)
    gets a zero row, as the JAX package's one-hot product over the table
    gives it."""
    n = pos_emb.shape[0]
    if pos0 + s <= n:
        return pos_emb[pos0 : pos0 + s]
    rows = pos_emb.new_zeros((s, pos_emb.shape[1]))
    if pos0 < n:
        rows[: n - pos0] = pos_emb[pos0:]
    return rows


def decoder_forward(
    params: Params,
    dims: WhisperDims,
    tokens: torch.Tensor,  # [B, S] int
    xa_k,
    xa_v,
    cache: KVCache,
    anc: Optional[torch.Tensor] = None,
    return_cross_probs: bool = False,
    skip_logits: bool = False,
):
    """Run ``S`` decoder positions starting at ``cache.pos``.

    Writes the new self-attention K/V into ``cache`` in place, advances
    ``cache.pos`` and returns ``(logits [B, S, n_vocab] f32, cache[,
    cross_probs [L, B, H, S, T_audio] f16])``. Used with S>1 for the prompt
    and teacher forcing and S=1 for decode steps. ``xa_k``/``xa_v`` are
    ``[L, B_audio, H, T, hd]`` tensors or int8 ``(codes, scales)`` pairs.
    ``skip_logits`` skips the vocabulary product and returns ``None``
    logits (the alignment pass reads only the cross-attention
    probabilities, which ``return_cross_probs`` adds to the result).

    ``anc`` (decode steps only, S == 1) enables ancestry-indexed beam
    attention: an int32 ``[BW, K, ctx]`` table where ``anc[b, k, p] == j``
    means hypothesis ``k``'s token at position ``p`` lives in beam row
    ``j``, so the beam search never permutes the cache.
    """
    dec = params["decoder"]
    dtype = dec["tok_emb"].dtype
    b, s = tokens.shape
    mg = model_group(params)
    h = local_heads(dims.n_text_head, params)
    ctx = cache.k.shape[-2]
    pos0 = cache.pos
    dev = tokens.device

    x = dec["tok_emb"][tokens] + _pos_rows(dec["pos_emb"], pos0, s)
    if mg is not None:  # a feature slice: the whole rows on every rank
        x = gather_from_model(x, mg, -1)

    # query i (absolute pos0+i) attends to cache positions <= pos0+i
    q_pos = pos0 + torch.arange(s, device=dev)[:, None]
    k_pos = torch.arange(ctx, device=dev)[None, :]
    self_mask = torch.where(k_pos <= q_pos, 0.0, float("-inf")).float()  # [S, ctx]
    # where this step's rows go: past the cache's end the JAX package's
    # dynamic_update_slice clamps the start, so they overwrite the last rows
    wpos = max(0, min(pos0, ctx - s))

    quant = cache.k.dtype == torch.int8
    cross_probs = []
    for l in range(dims.n_text_layer):
        p = _layer(dec["blocks"], l)
        resid = x
        y = _col_in(_layer_norm(x, p["attn_ln"]["g"], p["attn_ln"]["b"]), mg)
        q = _split_heads(_proj(y, p["attn"], "q"), h)
        k_new = _split_heads(_proj(y, p["attn"], "k"), h)
        v_new = _split_heads(_proj(y, p["attn"], "v"), h)
        hd = q.shape[-1]

        if anc is not None:
            # 64^-0.5 = 1/8 folds exactly into q (the split hd^-0.25 scaling
            # would round on both operands).
            qs = (q * hd ** -0.5).to(dtype).contiguous()
            if quant:
                k_q, k_s = _quantize_rows(k_new)
                v_q, v_s = _quantize_rows(v_new)
                y = ancestor_attention(
                    qs, cache.k, cache.v, cache.k_scale, cache.v_scale, l, anc,
                    self_mask[0], new_k=k_q, new_v=v_q, new_ks=k_s, new_vs=v_s, pos=wpos,
                )
            else:
                y = ancestor_attention(
                    qs, cache.k, cache.v, None, None, l, anc, self_mask[0],
                    new_k=k_new, new_v=v_new, pos=wpos,
                )
        elif quant:
            k_q, k_s = _quantize_rows(k_new)
            v_q, v_s = _quantize_rows(v_new)
            cache.k[l, :, :, wpos : wpos + s] = k_q
            cache.v[l, :, :, wpos : wpos + s] = v_q
            cache.k_scale[l, :, :, wpos : wpos + s] = k_s
            cache.v_scale[l, :, :, wpos : wpos + s] = v_s
            qs = (q * hd ** -0.5).to(dtype)
            logits = torch.matmul(qs.float(), cache.k[l].float().transpose(-1, -2))
            logits = logits * cache.k_scale[l][:, :, None, :] + self_mask
            probs = torch.softmax(logits, dim=-1) * cache.v_scale[l][:, :, None, :]
            y = torch.matmul(probs.to(dtype).float(), cache.v[l].float()).to(dtype)
        else:
            cache.k[l, :, :, wpos : wpos + s] = k_new
            cache.v[l, :, :, wpos : wpos + s] = v_new
            k_l, v_l = cache.k[l], cache.v[l]
            if k_new.requires_grad:
                # a training step: attend to copies, since the next layer's
                # write into the shared cache would modify the views that the
                # backward saved (inference keeps reading the cache itself)
                k_l, v_l = k_l.clone(), v_l.clone()
            y = _attention(q, k_l, v_l, self_mask)
        x = resid + _proj(_merge_heads(y), p["attn"], "o", mg)

        resid = x
        y = _col_in(_layer_norm(x, p["cross_ln"]["g"], p["cross_ln"]["b"]), mg)
        qx = _split_heads(_proj(y, p["cross"], "q"), h)
        if isinstance(xa_k, tuple):
            xk, xv = (xa_k[0][l], xa_k[1][l]), (xa_v[0][l], xa_v[1][l])
        else:
            xk, xv = xa_k[l], xa_v[l]
        y, probs = _cross_attention(qx, xk, xv, dtype, return_cross_probs)
        cross_probs.append(probs)
        x = resid + _proj(_merge_heads(y), p["cross"], "o", mg)

        resid = x
        y = _col_in(_layer_norm(x, p["mlp_ln"]["g"], p["mlp_ln"]["b"]), mg)
        y = F.gelu(_proj(y, p["mlp"], "fc1"))
        x = resid + _proj(y, p["mlp"], "fc2", mg)
    x = _layer_norm(x, dec["ln"]["g"], dec["ln"]["b"])

    if skip_logits:
        logits = None
    elif "logits_wq" in dec:  # weight-only int8 head over the padded vocab
        logits = int8_matmul(x, dec["logits_wq"], dec["logits_ws"])[..., : dims.n_vocab]
    elif mg is not None:
        # this rank's features of x against its slice of the table: partial
        # f32 logits, summed over the model group
        w = dec["tok_emb"][: dims.n_vocab]
        xs = copy_to_model(x, mg).narrow(-1, mg.rank * w.shape[1], w.shape[1])
        logits = reduce_from_model(torch.matmul(xs.float(), w.float().t()), mg)
    else:
        # f32 logits, as the JAX path's f32-accumulated product (bf16 values
        # are exact in f32); the 128-row vocab pad is never multiplied.
        logits = torch.matmul(x.float(), dec["tok_emb"][: dims.n_vocab].float().t())
    cache.pos = pos0 + s
    if return_cross_probs:
        return logits, cache, torch.stack(cross_probs)
    return logits, cache


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def _init_block(d: int, n_layer: int, cross: bool, gen, dtype, device) -> Params:
    s = d**-0.5

    def lin(din, dout):
        w = torch.randn((n_layer, din, dout), generator=gen, device=device) * s
        return w.to(dtype)

    def zeros(dout):
        return torch.zeros((n_layer, dout), dtype=dtype, device=device)

    def ln():
        return {"g": torch.ones((n_layer, d), dtype=dtype, device=device), "b": zeros(d)}

    def attn():
        return {
            "q_w": lin(d, d), "q_b": zeros(d),
            "k_w": lin(d, d),
            "v_w": lin(d, d), "v_b": zeros(d),
            "o_w": lin(d, d), "o_b": zeros(d),
        }

    p = {
        "attn": attn(), "attn_ln": ln(),
        "mlp": {
            "fc1_w": lin(d, 4 * d), "fc1_b": zeros(4 * d),
            "fc2_w": lin(4 * d, d), "fc2_b": zeros(d),
        },
        "mlp_ln": ln(),
    }
    if cross:
        p["cross"] = attn()
        p["cross_ln"] = ln()
    return p


def init_params(dims: WhisperDims, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.bfloat16, device="cpu") -> Params:
    """Seeded random parameters with the checkpoint tree layout.

    ``generator`` must live on ``device``. The distributions follow the
    JAX package's ``init_params``; the numbers differ (another generator).
    """
    d = dims.n_audio_state
    s = d**-0.5

    def randn(*shape, std):
        return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    dt = dims.n_text_state
    return {
        "encoder": {
            "conv1": {"w": randn(d, dims.n_mels, 3, std=s), "b": zeros(d)},
            "conv2": {"w": randn(d, d, 3, std=s), "b": zeros(d)},
            "blocks": _init_block(d, dims.n_audio_layer, False, generator, dtype, device),
            "ln_post": {"g": torch.ones((d,), dtype=dtype, device=device), "b": zeros(d)},
        },
        "decoder": {
            "tok_emb": randn(padded_vocab(dims.n_vocab), dt, std=s),
            "pos_emb": randn(dims.n_text_ctx, dt, std=0.01),
            "blocks": _init_block(dt, dims.n_text_layer, True, generator, dtype, device),
            "ln": {"g": torch.ones((dt,), dtype=dtype, device=device), "b": zeros(dt)},
        },
    }
