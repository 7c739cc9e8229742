"""Plain word times of one window, as OpenAI Whisper's ``timing.py`` finds
them: the cross-attention of the alignment heads (with no per-checkpoint
mask, every head of the top half of the text layers) over the served
tokens, each head standardised over time, median-filtered over 7 frames
(the edges repeated), averaged over heads and layers; a monotonic DTW of
its negative from the first token and frame to the last; each token
starts at the frame where the path enters its row and ends where the next
token starts. Tokens are grouped into words as the program's byte
tokenizer spells them (ids under 256 are bytes, other text ids the words
" w<id>", ids from EOT on break words). Float64 on the host; it imports
nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

FRAME_S = 0.02  # one encoder position: 20 ms of audio


def alignment_matrix(cross: torch.Tensor) -> np.ndarray:
    """``cross [L, H, S, T]`` attention probabilities -> ``[S, T]`` f64."""
    w = cross.double()
    mean = w.mean(dim=-1, keepdim=True)
    std = w.std(dim=-1, unbiased=False, keepdim=True)
    w = (w - mean) / (std + 1e-9)
    t = w.shape[-1]
    padded = torch.cat([w[..., :1].expand(*w.shape[:-1], 3), w,
                        w[..., -1:].expand(*w.shape[:-1], 3)], dim=-1)
    med = padded.unfold(-1, 7, 1).median(dim=-1).values[..., :t]
    return med.mean(dim=(0, 1)).cpu().numpy()


def dtw_cols(cost: np.ndarray) -> np.ndarray:
    """Entry column of each row on the cheapest monotonic path through
    ``cost [S, T]`` from (0, 0) to (S - 1, T - 1), steps right, down or
    diagonal, ties going diagonal, then down, then right."""
    s, t = cost.shape
    acc = np.full((s + 1, t + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, s + 1):
        # acc[i, j] = cost + min(acc[i-1, j-1], acc[i-1, j], acc[i, j-1]):
        # unrolled along the row, the left steps are a prefix sum
        m = np.minimum(acc[i - 1, :-1], acc[i - 1, 1:])
        csum = np.concatenate([[0.0], np.cumsum(cost[i - 1])])
        acc[i, 1:] = csum[1:] + np.minimum.accumulate(m - csum[:-1])
    cols = np.zeros(s, dtype=np.int64)
    i, j = s, t
    while i > 0 and j > 0:
        cols[i - 1] = j - 1
        diag, up, left = acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1]
        if left < min(diag, up):
            j -= 1
        elif up < diag:
            i -= 1
        else:
            i, j = i - 1, j - 1
    return cols


def _piece(tokens: List[int], eot: int) -> str:
    parts, buf = [], bytearray()
    for t in tokens:
        if t < 256:
            buf.append(t)
            continue
        if buf:
            parts.append(buf.decode("utf-8", errors="replace"))
            buf = bytearray()
        if t < eot:
            parts.append(f" w{t}")
    if buf:
        parts.append(buf.decode("utf-8", errors="replace"))
    return "".join(parts)


def group_words(cols: np.ndarray, tokens: List[int], eot: int) -> List[Dict[str, float]]:
    starts = cols * FRAME_S
    ends = np.append(cols[1:], cols[-1] + 1) * FRAME_S
    words: List[Dict[str, float]] = []
    cur: List[int] = []
    t0 = t1 = 0.0

    def flush():
        text = _piece(cur, eot).strip()
        if cur and text:
            words.append({"word": text, "start": round(float(t0), 3), "end": round(float(t1), 3)})
        cur.clear()

    for k, tok in enumerate(tokens):
        if tok >= eot:
            flush()
            continue
        if _piece([tok], eot).startswith(" "):
            flush()
        if not cur:
            t0 = starts[k]
        t1 = ends[k]
        cur.append(tok)
    flush()
    return words


def path_cost(cost: np.ndarray, cols: np.ndarray) -> float:
    """The cost of the monotonic path that enters row ``i`` at column
    ``cols[i]`` and leaves it for the next row's entry (the last row runs
    to the last column)."""
    s, t = cost.shape
    ends = np.append(np.maximum(cols[1:] - 1, cols[:-1]), t - 1)
    csum = np.concatenate([np.zeros((s, 1)), np.cumsum(cost, axis=1)], axis=1)
    return float((csum[np.arange(s), ends + 1] - csum[np.arange(s), cols]).sum())


def window_alignment(cross: torch.Tensor, tokens: List[int], frames: int = 1500):
    """One window's alignment: ``cross [L, H, S, T]`` over its served
    ``tokens`` (S of them, EOT left out) -> (the DTW's cost matrix
    ``[S, frames]`` f64, each token's entry column)."""
    cost = -alignment_matrix(cross[:, :, : len(tokens), :frames])
    return cost, dtw_cols(cost)
