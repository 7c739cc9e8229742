"""Music/background detection: short-window energy coefficient of variation.

Counterpart of ``modular_audio_pipeline_tpu/ops/music.py`` with its
decision rule: RMS energies of non-overlapping 50 ms windows; music has
*consistent* energy, so a coefficient of variation (population std /
mean) below 0.6 flags music, with confidence ``clip((0.8 - cv) / 0.4)``.
The energies are computed on the device; :func:`analyze_device` also
reduces them there and fetches one scalar, :func:`analyze_audio_content`
reduces them on the host (numpy, as the JAX package does).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["analyze_audio_content", "analyze_device", "energy_cv", "window_energies"]


def window_energies(audio: torch.Tensor, sr: int) -> torch.Tensor:
    """RMS energy per non-overlapping 50 ms window."""
    window = int(sr * 0.05)
    n = (audio.shape[-1] // window) * window
    windows = audio[:n].reshape(-1, window)
    return torch.sqrt(torch.mean(windows * windows, dim=-1))


def _energy_cv_device(audio: torch.Tensor, n_valid_windows: int, sr: int) -> torch.Tensor:
    """Energy CV over the first ``n_valid_windows`` 50 ms windows, reduced
    on the device (one scalar crosses to the host)."""
    e = window_energies(audio, sr)
    valid = (torch.arange(e.shape[0], device=e.device) < n_valid_windows).float()
    n = max(float(n_valid_windows), 1.0)
    mean = torch.sum(e * valid) / n
    var = torch.sum((e - mean) ** 2 * valid) / n
    return torch.sqrt(var) / (mean + 1e-10)


def _decision(cv: float) -> Dict:
    has_music = cv < 0.6
    return {
        "has_music": has_music,
        "confidence": max(0.0, min(1.0, (0.8 - cv) / 0.4)),
        "energy_cv": cv,
        "reason": (
            "Low energy variance suggests background music"
            if has_music
            else "High energy variance suggests speech only"
        ),
    }


_TOO_SHORT = {"has_music": False, "confidence": 0.0, "reason": "Audio too short"}


def analyze_device(device_audio: torch.Tensor, n_valid: int, sr: int) -> Dict:
    """:func:`analyze_audio_content` over a padded device waveform whose
    first ``n_valid`` samples are the audio."""
    num_windows = n_valid // int(sr * 0.05)
    if num_windows < 10:
        return dict(_TOO_SHORT)
    return _decision(float(_energy_cv_device(device_audio, num_windows, sr)))


def energy_cv(audio: np.ndarray, sr: int, device=None) -> float:
    """Coefficient of variation of 50 ms window RMS energies: energies of
    the bucket-padded audio on ``device`` (None: CUDA), the population
    statistics of the valid windows on the host."""
    from ..utils import resolve_device
    from .bucketing import pad_to_bucket

    n_valid = len(audio) // int(sr * 0.05)
    padded, _ = pad_to_bucket(np.asarray(audio, dtype=np.float32), sr)
    x = torch.from_numpy(np.ascontiguousarray(padded)).to(resolve_device(device))
    energies = window_energies(x, sr).cpu().numpy()[:n_valid]
    return float(np.std(energies) / (np.mean(energies) + 1e-10))


def analyze_audio_content(audio: np.ndarray, sr: int, device=None) -> Dict:
    """``{"has_music", "confidence", "energy_cv", "reason"}`` of a host
    waveform, with the energies computed on ``device`` (None: CUDA)."""
    if len(audio) // int(sr * 0.05) < 10:
        return dict(_TOO_SHORT)
    return _decision(energy_cv(audio, sr, device))
