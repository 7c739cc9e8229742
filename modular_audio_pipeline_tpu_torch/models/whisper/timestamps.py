"""Word-level timestamps: cross-attention alignment + DTW (PyTorch).

Counterpart of ``modular_audio_pipeline_tpu/models/whisper/timestamps.py``.
OpenAI Whisper's technique aligns decoded tokens to audio frames by
dynamic-time-warping the decoder's cross-attention:

1. a teacher-forced decoder pass over the final token sequence returns the
   cross-attention probabilities (one extra batched forward),
2. per-head standardisation over time + a width-7 median filter,
3. head-averaged attention -> cost matrix -> monotonic DTW path,
4. token boundary = the DTW path's column (audio frame, 20 ms each) at
   each token row transition; words are grouped from tokens.

Steps 1-3 run on the tensors' device for all windows of a batch at once.
The DTW's forward pass is an anti-diagonal wavefront (every cell of a
diagonal updates in parallel across batch and rows, S + T vector steps
instead of S * T scalar ones). Its backtrace depends on the data at every
step, so the table of moves is brought to the host once and all windows
walk it there in lockstep; on the device each step would cost a host
synchronisation. :func:`dtw_path_python` is the scalar oracle.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .config import WhisperDims
from ...parallel.sharding import gather_from_model, model_group
from ...runtime import tracing
from .model import KVCache, decoder_forward, local_heads
from .tokenizer import WhisperTokenizer

__all__ = ["dtw_path", "dtw_path_python", "dtw_cols_batched", "align_words",
           "align_words_batched"]

_FRAME_S = 0.02  # one encoder position = 20 ms of audio
_BIG = 1e30  # "unreachable" cost: finite, so padded cells never make NaNs


def dtw_path_python(cost: np.ndarray) -> np.ndarray:
    """Pure-NumPy DTW (diag/up/left moves), O(S*T); returns the column
    index at which the path enters each row."""
    s_len, t_len = cost.shape
    acc = np.full((s_len + 1, t_len + 1), np.inf, dtype=np.float64)
    acc[0, 0] = 0.0
    trace = np.zeros((s_len + 1, t_len + 1), dtype=np.int8)

    for i in range(1, s_len + 1):
        row_cost = cost[i - 1]
        prev = acc[i - 1]
        cur = acc[i]
        for j in range(1, t_len + 1):
            c0 = prev[j - 1]  # diagonal
            c1 = prev[j]      # up (advance token, hold frame)
            c2 = cur[j - 1]   # left (advance frame, hold token)
            best = c0
            move = 0
            if c1 < best:
                best, move = c1, 1
            if c2 < best:
                best, move = c2, 2
            cur[j] = row_cost[j - 1] + best
            trace[i, j] = move

    # backtrack
    i, j = s_len, t_len
    cols = np.zeros(s_len, dtype=np.int64)
    while i > 0 and j > 0:
        cols[i - 1] = j - 1
        move = trace[i, j]
        if move == 0:
            i, j = i - 1, j - 1
        elif move == 1:
            i -= 1
        else:
            j -= 1
    return cols


# The JAX package's dtw_path prefers its C++ runtime and falls back to this
# loop; the port has no native runtime yet, so the oracle is the path.
dtw_path = dtw_path_python


def _median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis (whisper uses width 7)."""
    if width <= 1 or x.shape[-1] < width:
        return x
    pad = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1)


# Batcher odd-even mergesort network for 8 inputs (19 compare-exchanges):
# a width-7 running median as elementwise minima and maxima over the 7
# shifted views plus one +inf pad, with no stacked-and-sorted buffer.
_SORT8 = [
    (0, 1), (2, 3), (4, 5), (6, 7),
    (0, 2), (1, 3), (4, 6), (5, 7),
    (1, 2), (5, 6),
    (0, 4), (1, 5), (2, 6), (3, 7),
    (2, 4), (3, 5),
    (1, 2), (3, 4), (5, 6),
]


def _median7(slices: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise median of 7 equal-shape tensors (sorting network)."""
    v = list(slices) + [torch.full_like(slices[0], float("inf"))]
    for i, j in _SORT8:
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[3]  # median of the 7 reals = rank 3 of the padded 8


@tracing.spanned("words.matrix")
def _alignment_matrix_impl(params, seq: torch.Tensor, xa_k, xa_v, dims: WhisperDims
                           ) -> torch.Tensor:
    """Teacher-forced cross-attention of ``seq [B, S]`` -> alignment matrix
    ``[B, S, T]`` f32.

    Alignment heads: openai-whisper's default when a checkpoint ships no
    per-model mask, every head of the top half of the text layers. Each
    head is standardised over time with f32 accumulators over the f16
    probabilities, rounded to f16 again, median-filtered over 7 frames
    with edge padding, and the heads are averaged in f32. Under tensor
    parallelism the heads of every rank are gathered before the
    standardisation, so the mean covers every head as without a mesh.
    """
    b = seq.shape[0]
    cache = KVCache.zeros(dims, b, params["decoder"]["tok_emb"].dtype, ctx=seq.shape[1],
                          device=seq.device, heads=local_heads(dims.n_text_head, params))
    _, _, cross = decoder_forward(params, dims, seq, xa_k, xa_v, cache,
                                  return_cross_probs=True, skip_logits=True)  # f16 [L,B,H,S,T]
    cross = cross[dims.n_text_layer // 2:]
    mg = model_group(params)
    if mg is not None:
        cross = gather_from_model(cross, mg, 2)
    ls, _, h, s, t = cross.shape
    w = cross.reshape(ls * b * h, s, t)

    w32 = w.float()
    mean = w32.mean(dim=-1, keepdim=True)
    meansq = torch.square(w32).mean(dim=-1, keepdim=True)
    inv_std = 1.0 / (torch.sqrt(torch.clamp(meansq - mean * mean, min=0.0)) + 1e-9)
    w = ((w32 - mean) * inv_std).to(torch.float16)
    del w32

    padded = torch.cat([w[..., :1].expand(-1, -1, 3), w, w[..., -1:].expand(-1, -1, 3)], dim=-1)
    med = _median7([padded[:, :, i : i + t] for i in range(7)])
    return med.reshape(ls, b, h, s, t).float().mean(dim=(0, 2))


def dtw_cols_batched(cost: torch.Tensor, lens) -> np.ndarray:
    """Batched monotonic DTW: ``cost [B, S, T]`` -> per-row entry columns
    ``[B, S]`` int32 on the host (same semantics as
    :func:`dtw_path_python`, ties broken diagonal > up > left).

    Rows >= ``lens[b]`` are ignored: the backtrace starts at
    ``(lens[b], T)``, and forward values at row i depend only on rows
    <= i, so padding rows cannot corrupt real ones. Rows the path never
    enters keep column 0.
    """
    b, s, t = cost.shape
    dev = cost.device
    cost = cost.float()
    n_diag = s + t - 1

    with tracing.span("words.dtw"):  # the forward pass, then the moves to the host
        # skew: sk[d, b, 1 + i] = cost[b, i, d - i] (anti-diagonal layout), with
        # a wall in column 0 (accumulator row 0) and wherever d - i leaves [0, T)
        j_idx = (torch.arange(n_diag, device=dev)[None, :]
                 - torch.arange(s, device=dev)[:, None])
        valid = (j_idx >= 0) & (j_idx < t)  # [S, S+T-1]
        sk = torch.gather(cost, 2, j_idx.clamp(0, t - 1)[None].expand(b, -1, -1))
        sk = torch.where(valid[None], sk, torch.full((), _BIG, device=dev))
        steps = torch.full((n_diag, b, s + 1), _BIG, device=dev)
        steps[:, :, 1:] = sk.permute(2, 0, 1)
        del sk

        # Diagonal buffers carry one more wall in front, so "the row above" is a
        # view shifted by one: buf[:, 1 + i'] is the accumulator at row i'.
        pp = torch.full((b, s + 2), _BIG, device=dev)
        pp[:, 1] = 0.0  # acc[0, 0] = 0
        p = torch.full((b, s + 2), _BIG, device=dev)  # diagonal 1: walls only
        big = torch.full((), _BIG, device=dev)
        # up_lt[da]: "up" beats "diagonal"; left_lt[da]: "left" beats both.
        # Strict comparisons keep the order diagonal > up > left on ties.
        up_lt = torch.zeros((s + t + 1, b, s + 1), dtype=torch.bool, device=dev)
        left_lt = torch.zeros_like(up_lt)
        new = torch.full_like(p, _BIG)  # three buffers rotate; column 0 stays a wall
        for d in range(n_diag):
            da = d + 2
            c0, c1, c2 = pp[:, : s + 1], p[:, : s + 1], p[:, 1:]
            torch.lt(c1, c0, out=up_lt[da])
            best = torch.minimum(c0, c1)
            torch.lt(c2, best, out=left_lt[da])
            best = torch.minimum(best, c2)
            # cells outside the matrix carry a wall in `steps`: wall + best
            # rounds back to the wall, and the cap keeps every cell finite
            torch.minimum(steps[d] + best, big, out=new[:, 1:])
            pp, p, new = p, new, pp
        moves = torch.where(left_lt, 2, up_lt.to(torch.int8)).to(torch.int8).cpu().numpy()

    # backtrace on the host: all windows walk in lockstep, frozen when done
    with tracing.span("words.backtrace"):
        bi = np.arange(b)
        ii = np.asarray(torch.as_tensor(lens).cpu(), dtype=np.int64).copy()
        jj = np.full((b,), t, np.int64)
        cols = np.zeros((b, s), np.int32)
        while True:
            active = (ii > 0) & (jj > 0)
            if not active.any():
                return cols
            move = moves[ii + jj, bi, ii]
            cols[bi[active], ii[active] - 1] = jj[active] - 1
            ii = np.where(active & (move != 2), ii - 1, ii)
            jj = np.where(active & (move != 1), jj - 1, jj)


def _align_dtw(params, dims: WhisperDims, seq, xa_k, xa_v, lens, prefix_len: int,
               n_audio_frames: int) -> np.ndarray:
    """Alignment matrix of the generated rows + DTW -> columns ``[B, S']``."""
    mat = _alignment_matrix_impl(params, seq, xa_k, xa_v, dims)
    return dtw_cols_batched(-mat[:, prefix_len:, :n_audio_frames], lens)


def align_words_batched(
    params,
    dims: WhisperDims,
    tokenizer: WhisperTokenizer,
    xa_k: torch.Tensor,
    xa_v: torch.Tensor,
    items: Sequence[Tuple[int, Sequence[int], Sequence[int]]],
    n_audio_frames: int = 1500,
    chunk: int = 16,
    longest: int = 0,
) -> List[List[Dict[str, float]]]:
    """Align many windows' decoded tokens to audio time in one (or a few)
    batched passes.

    ``items``: ``(window_index, generated_tokens, prompt_prefix)`` per
    window; ``xa_k``/``xa_v`` are the full batch's unquantised audio K/V,
    window rows are selected here. Returns one word list per item, in
    order. Sequences are EOT-padded to a shared 64-multiple bucket (the
    JAX package's shapes) over the longest of them, or over ``longest``
    when that is longer (ranks that align their own windows of one batch
    share the batch's bucket); the decoder is causal, so padded rows cannot
    affect real ones and are ignored.
    """
    if not items:
        return []

    fulls = []
    for _, tokens, prefix in items:
        fulls.append(list(prefix) + [int(t) for t in tokens if int(t) != tokenizer.eot])
    s_bucket = ((max([longest] + [len(f) for f in fulls]) + 63) // 64) * 64

    # The teacher-forced pass materialises every layer-head's attention,
    # [L, chunk, H, S, T] f16, plus the standardised top-half copy and its
    # median. Cap the window chunk so that stays within about 2 GB.
    bytes_per_window = dims.n_text_layer * dims.n_text_head * s_bucket * n_audio_frames * 2
    chunk = max(1, min(chunk, int(2e9 // max(bytes_per_window, 1))))

    prefix_len = len(items[0][2])  # shared across a batch (same options)
    dev = xa_k.device
    out: List[List[Dict[str, float]]] = []
    for c0 in range(0, len(items), chunk):
        part = items[c0 : c0 + chunk]
        part_fulls = fulls[c0 : c0 + chunk]
        idxs = [it[0] for it in part]
        if idxs == list(range(idxs[0], idxs[0] + len(idxs))):
            xk = xa_k[:, idxs[0] : idxs[0] + len(idxs)]
            xv = xa_v[:, idxs[0] : idxs[0] + len(idxs)]
        else:
            sel = torch.tensor(idxs, dtype=torch.int64, device=dev)
            xk, xv = xa_k.index_select(1, sel), xa_v.index_select(1, sel)
        seq = torch.tensor([f + [tokenizer.eot] * (s_bucket - len(f)) for f in part_fulls],
                           dtype=torch.int64, device=dev)
        lens = [max(0, len(f) - prefix_len) for f in part_fulls]
        cols = _align_dtw(params, dims, seq, xk, xv, lens, prefix_len, n_audio_frames)
        for j, (_, tokens, prefix) in enumerate(part):
            out.append(_words_from_cols(cols[j], list(tokens), list(prefix), tokenizer))
    return out


def align_words(
    params,
    dims: WhisperDims,
    tokenizer: WhisperTokenizer,
    xa_k: torch.Tensor,
    xa_v: torch.Tensor,
    tokens: Sequence[int],
    prefix: Sequence[int],
    n_audio_frames: int = 1500,
) -> List[Dict[str, float]]:
    """Single-window convenience wrapper over :func:`align_words_batched`."""
    text_tokens = [int(t) for t in tokens if int(t) < tokenizer.eot]
    if not text_tokens:
        return []
    return align_words_batched(
        params, dims, tokenizer, xa_k[:, :1], xa_v[:, :1],
        [(0, tokens, prefix)], n_audio_frames,
    )[0]


def _words_from_cols(
    cols: np.ndarray,  # [S'] DTW entry columns of the generated rows
    tokens: List[int],
    prefix: List[int],
    tokenizer: WhisperTokenizer,
) -> List[Dict[str, float]]:
    text_tokens = [int(t) for t in tokens if int(t) < tokenizer.eot]
    if not text_tokens:
        return []
    n_gen = len([t for t in tokens if int(t) != tokenizer.eot])
    del prefix  # cols already cover generated rows only
    if n_gen == 0:
        return []
    return _group_words(cols[:n_gen], tokens, tokenizer)


def _group_words(
    cols: np.ndarray, tokens: List[int], tokenizer: WhisperTokenizer
) -> List[Dict[str, float]]:
    gen_tokens = [int(t) for t in tokens if int(t) != tokenizer.eot]

    # token start time = DTW column at its row; end = next row's column
    starts = cols * _FRAME_S
    ends = np.append(cols[1:], cols[-1] + 1) * _FRAME_S

    # group text tokens into words (specials/timestamps break words)
    words: List[Dict[str, float]] = []
    cur_ids: List[int] = []
    cur_start = None
    cur_end = None

    def flush():
        nonlocal cur_ids, cur_start, cur_end
        if cur_ids:
            text = tokenizer.decode(cur_ids).strip()
            if text:
                words.append(
                    {"word": text, "start": round(float(cur_start), 3),
                     "end": round(float(cur_end), 3)}
                )
        cur_ids, cur_start, cur_end = [], None, None

    for idx, tok in enumerate(gen_tokens):
        if idx >= len(starts):
            break
        if tok >= tokenizer.eot:  # special/timestamp token
            flush()
            continue
        piece = tokenizer.decode([tok])
        if piece.startswith(" ") or piece.startswith(" w"):
            flush()
        if cur_start is None:
            cur_start = starts[idx]
        cur_end = ends[idx]
        cur_ids.append(tok)
    flush()
    return words
