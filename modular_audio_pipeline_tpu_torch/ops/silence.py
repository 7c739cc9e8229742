"""Silence detection over per-millisecond block energies (host numpy).

Copied from ``modular_audio_pipeline_tpu/ops/silence.py``
(``detect_nonsilent_from_block_sums``): pydub's ``detect_nonsilent``
reproduced from one f32 sum of squares per 1 ms block, which is all the
device sends back; the threshold is relative to the clip's level, so the
absolute scale cancels.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["detect_nonsilent_from_block_sums"]


def detect_nonsilent_from_block_sums(
    block_sq: np.ndarray,
    n_valid_ms: int,
    min_silence_len: int = 250,
    silence_offset_db: float = 40.0,
    spms: int = 16,
) -> List[Tuple[int, int]]:
    """Non-silent ``(start_ms, end_ms)`` ranges: a window of
    ``min_silence_len`` ms is silent when its mean square is at most the
    clip's mean square less ``silence_offset_db``; ``spms`` samples per
    block."""
    cs = np.concatenate([[0.0], np.cumsum(block_sq[:n_valid_ms], dtype=np.float64)])
    total_ms2 = cs[-1] / max(n_valid_ms * spms, 1)
    thresh_ms2 = total_ms2 * 10.0 ** (-silence_offset_db / 10.0)

    if n_valid_ms < min_silence_len:
        return [(0, n_valid_ms)] if n_valid_ms else []
    win_sums = cs[min_silence_len:] - cs[: n_valid_ms - min_silence_len + 1]
    win_ms2 = win_sums / (min_silence_len * spms)
    silent = np.flatnonzero(win_ms2 <= thresh_ms2)

    if silent.size == 0:
        return [(0, n_valid_ms)]
    breaks = np.flatnonzero(
        (np.diff(silent) != 1) & (np.diff(silent) > min_silence_len)
    )
    range_starts = np.concatenate([[0], breaks + 1])
    range_ends = np.concatenate([breaks, [silent.size - 1]])
    silent_ranges = [
        (int(silent[s]), int(silent[e]) + min_silence_len)
        for s, e in zip(range_starts, range_ends)
    ]

    out = []
    prev = 0
    for s, e in silent_ranges:
        if s > prev:
            out.append((prev, s))
        prev = e
    if prev < n_valid_ms:
        out.append((prev, n_valid_ms))
    return [(s, e) for s, e in out if e > s]
