"""Level measurement and peak normalisation (torch).

Counterpart of ``modular_audio_pipeline_tpu/ops/dynamics.py``: pydub's
``dBFS``, ``max_dBFS`` and ``effects.normalize`` on float32 waveforms
scaled by the 16-bit full-scale constant, so thresholds carry over.
"""

from __future__ import annotations

import torch

__all__ = ["dbfs", "peak_dbfs", "peak_normalize"]

_FULL_SCALE = 32768.0  # 16-bit reference amplitude (pydub max_possible_amplitude)


def dbfs(x: torch.Tensor) -> torch.Tensor:
    """RMS level in dB relative to 16-bit full scale (pydub ``dBFS``);
    ``-inf`` for digital silence."""
    rms2 = torch.mean(torch.square(x * _FULL_SCALE), dim=-1)
    db = 10.0 * torch.log10(torch.clamp(rms2, min=1e-30) / (_FULL_SCALE ** 2))
    return torch.where(rms2 > 0, db, torch.full_like(db, -float("inf")))


def peak_dbfs(x: torch.Tensor) -> torch.Tensor:
    """Peak level in dBFS (pydub ``max_dBFS``)."""
    peak = torch.amax(x.abs(), dim=-1)
    db = 20.0 * torch.log10(torch.clamp(peak, min=1e-30))
    return torch.where(peak > 0, db, torch.full_like(db, -float("inf")))


def peak_normalize(x: torch.Tensor, headroom_db: float = 0.1) -> torch.Tensor:
    """Scale so the peak sits ``headroom_db`` below full scale
    (``pydub.effects.normalize(seg, headroom=0.1)``); silence is returned
    unchanged. Zero padding cannot move the peak, so a padded tensor
    normalises exactly."""
    peak = torch.amax(x.abs(), dim=-1, keepdim=True)
    target = 10.0 ** (-headroom_db / 20.0)
    gain = target / torch.clamp(peak, min=1e-12)
    return torch.where(peak > 0, x * gain, x)
