"""Silence detection and removal with timestamp mappings.

Counterpart of ``modular_audio_pipeline_tpu/ops/silence.py``, pydub's
semantics exactly:

- threshold = clip dBFS - ``silence_offset_db``; sliding
  ``min_silence_len`` windows on a 1 ms grid compared against it (pydub's
  ``detect_silence``, by a cumulative sum), the non-silent ranges as its
  complement (host numpy, copied);
- each kept range widened by ``silence_margin`` ms and joined with a
  <= 20 ms linear crossfade, one :class:`TimestampMapping` per chunk with
  the crossfade position compensation (:func:`remove_silence`, host);
- the same on a device tensor: one f32 sum of squares per 1 ms block
  (:func:`block_sums_device`, all that crosses to the host), the same
  detection from those sums (:func:`detect_nonsilent_from_block_sums`),
  the cut as a per-block gather plan (:func:`build_cut_plan`) applied on
  the device (:func:`gather_cut_device`). Every cut point is 1 ms
  aligned, so the plan is sample-exact, crossfades included.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..protocols import TimestampMapping

__all__ = [
    "detect_silence_ranges",
    "detect_nonsilent_ranges",
    "detect_nonsilent_from_block_sums",
    "remove_silence",
    "build_cut_plan",
    "gather_cut_device",
    "block_sums_device",
]

_FULL_SCALE = 32768.0


def _window_mean_square(x: np.ndarray, sr: int, window_ms: int) -> np.ndarray:
    """Mean-square level of every sliding ``window_ms`` window on a 1 ms grid."""
    spms = sr // 1000  # samples per millisecond (sr is validated to be multiple)
    n_ms = len(x) // spms
    if n_ms < window_ms:
        return np.empty(0, dtype=np.float64)
    sq = np.square(x[: n_ms * spms].astype(np.float64) * _FULL_SCALE)
    cs = np.concatenate([[0.0], np.cumsum(sq)])
    win = window_ms * spms
    starts = np.arange(0, (n_ms - window_ms) + 1) * spms
    sums = cs[starts + win] - cs[starts]
    return sums / win


def detect_silence_ranges(
    x: np.ndarray,
    sr: int,
    min_silence_len: int = 250,
    silence_thresh_db: float = -56.0,
) -> List[Tuple[int, int]]:
    """pydub ``detect_silence``: [start_ms, end_ms) silent ranges."""
    spms = sr // 1000
    seg_len_ms = len(x) // spms
    if seg_len_ms < min_silence_len:
        return []

    # pydub compares linear RMS <= db_to_float(thresh) * full_scale, so a
    # -inf threshold still marks digitally-silent windows (rms == 0).
    ms2 = _window_mean_square(x, sr, min_silence_len)
    thresh_ms2 = (
        0.0
        if np.isneginf(silence_thresh_db)
        else (10.0 ** (silence_thresh_db / 10.0)) * _FULL_SCALE**2
    )
    silent = np.flatnonzero(ms2 <= thresh_ms2)  # window start times (ms)
    if silent.size == 0:
        return []

    # Group starts: a break happens when starts are non-contiguous AND the
    # gap exceeds the window length (pydub's combine rule).
    breaks = np.flatnonzero(
        (np.diff(silent) != 1) & (np.diff(silent) > min_silence_len)
    )
    range_starts = np.concatenate([[0], breaks + 1])
    range_ends = np.concatenate([breaks, [silent.size - 1]])
    return [
        (int(silent[s]), int(silent[e]) + min_silence_len)
        for s, e in zip(range_starts, range_ends)
    ]


def detect_nonsilent_ranges(
    x: np.ndarray,
    sr: int,
    min_silence_len: int = 250,
    silence_thresh_db: float = -56.0,
) -> List[Tuple[int, int]]:
    """pydub ``detect_nonsilent``: complement of the silent ranges (ms)."""
    spms = sr // 1000
    seg_len_ms = len(x) // spms
    silent = detect_silence_ranges(x, sr, min_silence_len, silence_thresh_db)
    if not silent:
        return [(0, seg_len_ms)] if seg_len_ms > 0 else []
    if len(silent) == 1 and silent[0] == (0, seg_len_ms):
        return []

    out = []
    prev_end = 0
    for s, e in silent:
        if s > prev_end:
            out.append((prev_end, s))
        prev_end = e
    if prev_end < seg_len_ms:
        out.append((prev_end, seg_len_ms))
    # pydub keeps a zero-length leading range out; guard against degenerates
    return [(s, e) for s, e in out if e > s]


def _crossfade_concat(
    chunks: List[np.ndarray], crossfades_ms: List[int], sr: int
) -> np.ndarray:
    """Concatenate with linear crossfades: out_len = sum(len) - sum(xf).

    Writes into one preallocated buffer (a naive repeated ``concatenate``
    is quadratic — seconds of pure memcpy for an hour of audio)."""
    spms = sr // 1000
    if not chunks:
        return np.empty(0, dtype=np.float32)

    from ..runtime.native_lib import native_crossfade_concat

    native = native_crossfade_concat(chunks, crossfades_ms, sr)
    if native is not None:
        return native

    total = sum(len(c) for c in chunks)
    out = np.empty(total, dtype=np.float32)
    pos = len(chunks[0])
    out[:pos] = chunks[0]

    for chunk, xf_ms in zip(chunks[1:], crossfades_ms):
        xf = xf_ms * spms
        n = len(chunk)
        if xf <= 0 or xf > min(pos, n):
            out[pos : pos + n] = chunk
            pos += n
            continue
        ramp = np.linspace(0.0, 1.0, xf, dtype=np.float32)
        out[pos - xf : pos] = out[pos - xf : pos] * (1.0 - ramp) + chunk[:xf] * ramp
        out[pos : pos + n - xf] = chunk[xf:]
        pos += n - xf
    return out[:pos]




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


def block_sums_device(x: torch.Tensor, spms: int) -> torch.Tensor:
    """Per-1-ms block sums of squares of a padded device waveform (one f32
    per ``spms`` samples)."""
    blocks = x.reshape(-1, spms)
    return torch.sum(blocks * blocks, dim=-1)


def build_cut_plan(
    ranges: List[Tuple[int, int]],
    seg_len_ms: int,
    spms: int,
    silence_margin_ms: int = 100,
    preserve_timestamps: bool = True,
    crossfade: bool = True,
):
    """Index-space :func:`remove_silence`: the same chunk construction,
    crossfade schedule, and mapping bookkeeping, but emitting a per-ms
    block gather plan instead of slicing samples.

    Returns ``(ids1, ids2, rstart, rstep, mappings, out_ms)`` where the
    cut output block ``b`` is ``x_blocks[ids1[b]] * (1-r) +
    x_blocks[ids2[b]] * r`` with ``r_j = rstart[b] + j*rstep[b]`` over the
    block's ``spms`` samples — exactly pydub's ``linspace(0, 1, xf)``
    crossfade since every cut point is 1 ms-aligned. ``crossfade=False``
    (the VAD concat, which joins voiced islands hard) leaves ids2/ramps
    zero.
    """
    chunks: List[Tuple[int, int]] = []
    mappings: List[TimestampMapping] = []
    crossfades: List[int] = []
    processed_ms = 0
    for i, (start_ms, end_ms) in enumerate(ranges):
        s = max(0, start_ms - silence_margin_ms)
        e = min(seg_len_ms, end_ms + silence_margin_ms)
        chunk_ms = e - s
        if preserve_timestamps:
            mappings.append(
                TimestampMapping(
                    processed_start=processed_ms / 1000.0,
                    processed_end=(processed_ms + chunk_ms) / 1000.0,
                    original_start=s / 1000.0,
                    original_end=e / 1000.0,
                )
            )
        if i > 0 and crossfade:
            xf = min(20, chunk_ms // 4)
            crossfades.append(xf)
            processed_ms -= xf
        elif i > 0:
            crossfades.append(0)
        chunks.append((s, e))
        processed_ms += chunk_ms

    total_ms = sum(e - s for s, e in chunks)
    ids1 = np.zeros(total_ms, np.int32)
    ids2 = np.zeros(total_ms, np.int32)
    rstart = np.zeros(total_ms, np.float32)
    rstep = np.zeros(total_ms, np.float32)

    s0, e0 = chunks[0]
    pos = e0 - s0
    ids1[:pos] = np.arange(s0, e0)
    for (s, e), xf in zip(chunks[1:], crossfades):
        n = e - s
        if xf <= 0 or xf > min(pos, n):
            ids1[pos : pos + n] = np.arange(s, e)
            pos += n
            continue
        xfs = xf * spms  # crossfade length in samples
        blend = slice(pos - xf, pos)
        ids2[blend] = np.arange(s, s + xf)
        denom = float(max(xfs - 1, 1))
        rstart[blend] = (np.arange(xf, dtype=np.float32) * spms) / denom
        rstep[blend] = 1.0 / denom
        ids1[pos : pos + n - xf] = np.arange(s + xf, e)
        pos += n - xf
    return ids1[:pos], ids2[:pos], rstart[:pos], rstep[:pos], mappings, pos


def gather_cut_device(x: torch.Tensor, sr: int, ids1, ids2, rstart, rstep, out_ms: int):
    """Apply a :func:`build_cut_plan` to a padded device waveform; returns
    ``(padded_out, n_valid_samples)``, the output zero past its valid
    samples and padded to its own bucket."""
    from .bucketing import bucket_length

    spms = sr // 1000
    n_valid = out_ms * spms
    out_blocks = bucket_length(n_valid, sr) // spms
    dev = x.device

    def column(values, dtype):
        full = np.zeros(out_blocks, dtype=dtype)
        full[:out_ms] = values
        return torch.from_numpy(full).to(dev)

    i1, i2 = column(ids1, np.int64), column(ids2, np.int64)
    r0, dr = column(rstart, np.float32), column(rstep, np.float32)
    mask = column(np.ones(out_ms, np.float32), np.float32)
    blocks = x.reshape(-1, spms)
    j = torch.arange(spms, dtype=torch.float32, device=dev)[None, :]
    r = r0[:, None] + dr[:, None] * j
    out = blocks[i1] * (1.0 - r) + blocks[i2] * r
    return (out * mask[:, None]).reshape(-1), n_valid


def remove_silence(
    x: np.ndarray,
    sr: int,
    min_silence_len: int = 250,
    silence_offset_db: float = 40.0,
    silence_margin_ms: int = 100,
    preserve_timestamps: bool = True,
) -> Tuple[np.ndarray, List[TimestampMapping], bool]:
    """Strip silence; return (audio, mappings, changed).

    ``changed`` is False when no non-silent ranges were found, in which case
    the caller should pass the input through untouched.
    """
    spms = sr // 1000
    seg_len_ms = len(x) // spms

    # Threshold relative to the clip's average level.
    sq = np.square(x.astype(np.float64) * _FULL_SCALE)
    mean_sq = sq.mean() if len(sq) else 0.0
    clip_dbfs = (
        10.0 * np.log10(mean_sq / _FULL_SCALE**2) if mean_sq > 0 else -float("inf")
    )
    thresh = clip_dbfs - silence_offset_db

    ranges = detect_nonsilent_ranges(x, sr, min_silence_len, thresh)
    if not ranges:
        return x, [], False

    chunks: List[np.ndarray] = []
    mappings: List[TimestampMapping] = []
    crossfades: List[int] = []
    processed_ms = 0

    for i, (start_ms, end_ms) in enumerate(ranges):
        s = max(0, start_ms - silence_margin_ms)
        e = min(seg_len_ms, end_ms + silence_margin_ms)
        chunk = x[s * spms : e * spms]
        chunk_ms = e - s

        # Mapping is recorded *before* this chunk's own crossfade shift.
        if preserve_timestamps:
            mappings.append(
                TimestampMapping(
                    processed_start=processed_ms / 1000.0,
                    processed_end=(processed_ms + chunk_ms) / 1000.0,
                    original_start=s / 1000.0,
                    original_end=e / 1000.0,
                )
            )

        if i > 0:
            xf = min(20, chunk_ms // 4)
            crossfades.append(xf)
            processed_ms -= xf  # crossfade position compensation
        chunks.append(chunk)
        processed_ms += chunk_ms

    out = _crossfade_concat(chunks, crossfades, sr)
    return out, mappings, True
