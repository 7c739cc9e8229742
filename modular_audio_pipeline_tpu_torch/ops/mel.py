"""Whisper-compatible log-mel spectrogram front end (torch).

Counterpart of ``modular_audio_pipeline_tpu/ops/mel.py``: 16 kHz audio,
n_fft=400, hop=160, periodic Hann, centred reflect pad, power spectrum
with the final frame dropped, slaney mel filterbank (fmax 8000),
``log10(clamp(mel, 1e-10))`` floored at max-8 over each window's
(mel, time) plane, then ``(x+4)/4``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .framing import frame_signal, hann_window

__all__ = ["mel_filterbank", "log_mel", "N_FFT", "HOP_LENGTH", "SAMPLE_RATE"]

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    safe = np.maximum(f, 1e-10)
    return np.where(
        f >= min_log_hz, min_log_mel + np.log(safe / min_log_hz) / logstep, f / f_sp
    )


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m
    )


@lru_cache(maxsize=8)
def mel_filterbank(
    n_mels: int = 80,
    n_fft: int = N_FFT,
    sr: int = SAMPLE_RATE,
    fmin: float = 0.0,
    fmax: float = 8000.0,
) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, shape [n_mels, n_fft//2+1]
    (``librosa.filters.mel`` defaults, htk=False, norm="slaney")."""
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(np.array(fmin)), _hz_to_mel_slaney(np.array(fmax)), n_mels + 2
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int = 80, sr: int = SAMPLE_RATE) -> torch.Tensor:
    """Whisper log-mel: ``audio[..., N]`` float32 -> ``[..., n_mels, N // HOP]``."""
    lead = audio.shape[:-1]
    x = audio.float().reshape(-1, audio.shape[-1])  # reflect pad wants [C, W]
    x = F.pad(x, (N_FFT // 2, N_FFT // 2), mode="reflect")
    frames = frame_signal(x, N_FFT, HOP_LENGTH) * hann_window(N_FFT, device=x.device)
    spec = torch.fft.rfft(frames, dim=-1)
    power = (spec.real**2 + spec.imag**2)[..., :-1, :]  # drop last frame (whisper)

    fb = torch.from_numpy(mel_filterbank(n_mels=n_mels, sr=sr)).to(x.device)
    mel = torch.einsum("mf,btf->bmt", fb, power)

    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    max_val = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    out = (log_spec + 4.0) / 4.0
    return out.reshape(lead + out.shape[-2:])
