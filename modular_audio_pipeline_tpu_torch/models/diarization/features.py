"""Batched MFCC features (torch).

Counterpart of ``modular_audio_pipeline_tpu/models/diarization/features.py``:
25 ms Hann frames at a 10 ms hop (no centring), zero-padded to a 512-point
FFT, power spectrum, slaney mel filterbank up to sr/2, natural log floored
at 1e-10, orthonormal DCT-II.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.framing import frame_signal, hann_window
from ...ops.mel import mel_filterbank

__all__ = ["mfcc_batch"]


@lru_cache(maxsize=4)
def _dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [n_out, n_in]."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    mat *= np.sqrt(2.0 / n_in)
    mat[0] *= 1.0 / np.sqrt(2.0)
    return mat.astype(np.float32)


def mfcc_batch(audio: torch.Tensor, sr: int = 16000, n_mfcc: int = 20,
               n_mels: int = 40) -> torch.Tensor:
    """[B, N] float32 -> [B, n_frames, n_mfcc]."""
    frame_len = int(sr * 0.025)
    hop = int(sr * 0.010)
    n_fft = 512
    frames = frame_signal(audio, frame_len, hop) * hann_window(frame_len, device=audio.device)
    frames = F.pad(frames, (0, n_fft - frame_len))
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2  # [B, nf, 257]
    fb = torch.from_numpy(mel_filterbank(n_mels=n_mels, n_fft=n_fft, sr=sr, fmax=sr / 2))
    mel = torch.einsum("mf,btf->btm", fb.to(audio.device), power.float())
    log_mel = torch.log(torch.clamp(mel, min=1e-10))
    dct = torch.from_numpy(_dct_matrix(n_mfcc, n_mels)).to(audio.device)
    return torch.einsum("km,btm->btk", dct, log_mel)
