"""Shape bucketing: pad variable-length audio onto a fixed ladder.

Copied from ``modular_audio_pipeline_tpu/ops/bucketing.py``. The serving
path pads every file to the next rung (30 s, 1 min, 5 min, 10 min, 30 min,
1 h) so its device work sees a handful of shapes and its decisions (VAD
windows, DSP sections, window counts) fall exactly as in the JAX package.
Reductions over padded arrays exclude the padding: per-frame statistics
are sliced back to the valid frames on the host. REPET's input is tiled
(:func:`tile_to_length`), not zero-padded, so its repetition statistics
stay unbiased.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["bucket_length", "pad_to_bucket", "tile_to_length", "DEFAULT_LADDER_S"]

DEFAULT_LADDER_S: Tuple[float, ...] = (30.0, 60.0, 300.0, 600.0, 1800.0, 3600.0)


def bucket_length(n: int, sr: int, ladder_s: Optional[Sequence[float]] = None) -> int:
    """Smallest ladder length (in samples) >= n; beyond the ladder, the
    next multiple of the largest rung."""
    ladder = sorted(ladder_s or DEFAULT_LADDER_S)
    for sec in ladder:
        cap = int(round(sec * sr))
        if n <= cap:
            return cap
    top = int(round(ladder[-1] * sr))
    return ((n + top - 1) // top) * top


def pad_to_bucket(
    audio: np.ndarray, sr: int, ladder_s: Optional[Sequence[float]] = None
) -> Tuple[np.ndarray, int]:
    """Zero-pad 1-D audio to its bucket; returns (padded, n_valid)."""
    n = int(audio.shape[-1])
    target = bucket_length(n, sr, ladder_s)
    if target == n:
        return audio, n
    out = np.zeros(audio.shape[:-1] + (target,), dtype=audio.dtype)
    out[..., :n] = audio
    return out, n


def tile_to_length(clip: np.ndarray, target: int) -> np.ndarray:
    """Repeat a clip up to ``target`` samples (where zero padding would
    corrupt spectral or repetition statistics)."""
    n = len(clip)
    if n == 0:
        return np.zeros(target, dtype=np.float32)
    if n >= target:
        return clip[:target]
    reps = (target + n - 1) // n
    return np.tile(clip, reps)[:target]
