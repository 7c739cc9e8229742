"""REPET: REpeating Pattern Extraction Technique for vocal isolation (torch).

Counterpart of ``modular_audio_pipeline_tpu/models/separation/repet.py``.
Music accompaniment repeats and vocals do not: the repeating period comes
from the beat spectrum (host numpy, copied), the accompaniment is the
per-bin median of 12 period-shifted copies of the magnitude spectrogram
(on the device), and a soft mask removes it. Bins below 100 Hz go to the
accompaniment. The input is tiled to its bucket length, as in the JAX
package, so both compute over the same spectrogram.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...ops.stft import istft, stft

__all__ = ["beat_spectrum", "find_repeating_period", "repet_separate"]

_N_FFT = 2048
_HOP = 512
_N_SHIFTS = 12  # repetitions sampled for the median model


def beat_spectrum(power: np.ndarray) -> np.ndarray:
    """Mean over frequency of per-bin time autocorrelations. power: [F, T]."""
    f, t = power.shape
    # autocorrelation via FFT, unbiased normalisation
    n = int(2 ** np.ceil(np.log2(2 * t)))
    spec = np.fft.rfft(power, n=n, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), n=n, axis=1)[:, :t]
    ac = ac / np.maximum(np.arange(t, 0, -1)[None, :], 1)  # unbiased
    b = ac.mean(axis=0)
    if b[0] > 0:
        b = b / b[0]
    return b


def find_repeating_period(
    power: np.ndarray, sr: int, hop: int = _HOP,
    min_period_s: float = 0.8, max_period_fraction: float = 1 / 3,
) -> int:
    """Repeating period in frames from the beat spectrum peak."""
    b = beat_spectrum(power)
    t = len(b)
    lo = max(1, int(round(min_period_s * sr / hop)))
    hi = max(lo + 1, int(t * max_period_fraction))
    if hi <= lo:
        return max(1, t // 2)
    return int(lo + np.argmax(b[lo:hi]))


def _repeating_mask(mag: torch.Tensor, period: int) -> torch.Tensor:
    """Soft mask of the repeating (music) component. mag: [F, T].

    The repeating model is the median of ``_N_SHIFTS`` period-shifted
    copies, wrapping modulo T (the input is tiled, so the wrap is
    seamless). The count is even, so the median is the mean of the two
    middle values, as ``jnp.median`` takes it (``torch.median`` would
    return the lower one)."""
    f, t = mag.shape
    t_idx = torch.arange(t, device=mag.device)[:, None]
    k_idx = torch.arange(_N_SHIFTS, device=mag.device)[None, :]
    shifts = (t_idx + k_idx * period) % t  # [T, K]
    samples = torch.sort(mag[:, shifts], dim=-1).values  # [F, T, K]
    mid = _N_SHIFTS // 2
    w = 0.5 * samples[..., mid - 1] + 0.5 * samples[..., mid]
    # the repeating model cannot exceed the mixture
    w = torch.minimum(w, mag)
    return torch.clamp(w / torch.clamp(mag, min=1e-8), 0.0, 1.0)


def repet_separate(
    audio: np.ndarray, sr: int, high_pass_hz: float = 100.0, device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Split host ``audio`` into host (vocals, accompaniment), with the
    spectrogram work on ``device`` (None: CUDA)."""
    from ...ops.bucketing import bucket_length, tile_to_length
    from ...utils import resolve_device

    # bucket by tiling, not zero padding: repetition is REPET's model
    n_valid = len(audio)
    target = bucket_length(n_valid, sr)
    tiled = tile_to_length(np.asarray(audio, np.float32), target)

    x = torch.from_numpy(np.ascontiguousarray(tiled, dtype=np.float32))
    x = x.to(resolve_device(device))
    spec = stft(x, n_fft=_N_FFT, hop=_HOP)  # [F, T] complex
    mag = spec.abs()

    period = find_repeating_period(mag.cpu().numpy() ** 2, sr)
    music_mask = _repeating_mask(mag, period)

    # vocals rarely live below ~100 Hz: those bins go to the accompaniment
    freqs = np.fft.rfftfreq(_N_FFT, 1.0 / sr)
    low_bins = torch.from_numpy((freqs < high_pass_hz).astype(np.float32))[:, None]
    music_mask = torch.maximum(music_mask, low_bins.to(mag.device))

    vocals = istft(spec * (1.0 - music_mask), n_fft=_N_FFT, hop=_HOP, length=target)
    music = istft(spec * music_mask, n_fft=_N_FFT, hop=_HOP, length=target)
    return (vocals.cpu().numpy().astype(np.float32)[:n_valid],
            music.cpu().numpy().astype(np.float32)[:n_valid])
