"""Noise-profile auto-detection: frame energy + zero-crossing rate (torch).

Counterpart of ``modular_audio_pipeline_tpu/ops/noise_detect.py`` with its
decision rule: 25 ms frames at a 10 ms hop; noise frames have an energy
below the 20th percentile AND a zero-crossing rate above half the median;
contiguous runs of at least 100 ms become noise segments. The features
are computed on the device (:func:`frame_features`), the percentiles and
runs on the host (:func:`noise_segments_from_features`, copied).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .framing import frame_signal

__all__ = ["frame_features", "noise_segments_from_features", "longest_noise_run"]


def frame_features(audio: torch.Tensor, sr: int) -> torch.Tensor:
    """Stacked ``[2, n_frames]``: per-frame RMS energy and zero-crossing rate."""
    frame_length = int(sr * 0.025)
    hop = int(sr * 0.010)
    frames = frame_signal(audio, frame_length, hop)  # [nf, frame_length]
    energies = torch.sqrt(torch.mean(frames * frames, dim=-1))
    signs = torch.signbit(frames).to(torch.int32)
    crossings = torch.diff(signs, dim=-1).abs().sum(dim=-1)
    zcrs = (crossings / frame_length).float()
    return torch.stack([energies, zcrs])


def noise_segments_from_features(
    energies: np.ndarray, zcrs: np.ndarray, sr: int
) -> List[Tuple[int, int]]:
    """(start_sample, end_sample) runs likely to be pure noise, from host
    features of the valid frames. A trailing open run is dropped, as the
    reference loop never closes a run at the end of the file."""
    hop = int(sr * 0.010)
    if len(energies) == 0:
        return []

    energy_threshold = np.percentile(energies, 20)
    zcr_threshold = np.percentile(zcrs, 50)
    noise_frames = (energies < energy_threshold) & (zcrs > zcr_threshold * 0.5)

    flags = np.concatenate([[False], noise_frames])
    edges = np.diff(flags.astype(np.int8))
    starts = np.flatnonzero(edges == 1)
    ends = np.flatnonzero(edges == -1)
    n_pairs = len(ends)  # pairs only; the open tail is excluded
    return [
        (int(s) * hop, int(e) * hop)
        for s, e in zip(starts[:n_pairs], ends)
        if (e - s) * hop / sr >= 0.1
    ]


def longest_noise_run(x: torch.Tensor, n_valid: int, sr: int):
    """``(start, end)`` samples of the longest noise run of a padded device
    waveform, from the features of its valid frames; None when none."""
    frame_len, hop = int(sr * 0.025), int(sr * 0.010)
    nvf = max(0, (n_valid - frame_len) // hop + 1)
    ez = frame_features(x, sr).cpu().numpy()
    segs = noise_segments_from_features(ez[0, :nvf], ez[1, :nvf], sr)
    return max(segs, key=lambda s: s[1] - s[0]) if segs else None
