"""STFT / iSTFT by framing + ``torch.fft`` (torch).

Counterpart of ``modular_audio_pipeline_tpu/ops/stft.py``, with its
conventions (those of librosa and scipy, which ``noisereduce`` uses):
centred frames with reflect padding, a periodic Hann window, a one-sided
spectrum in a frequency-major ``[..., n_bins, n_frames]`` layout, and an
inverse normalised by the sum of squared synthesis windows (NOLA), so
``istft(stft(x)) == x`` for hop <= win/2. ``torch.stft`` is not used: its
defaults (window, normalisation, layout) differ.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .framing import _hann_np, frame_signal, hann_window, overlap_add

__all__ = ["stft", "istft"]


@lru_cache(maxsize=16)
def _nola_norm(win_sq_key: tuple, n_fft: int, hop: int, nf: int, out_len: int) -> np.ndarray:
    """Sum of squared synthesis windows at each output sample (1 where it
    is ~0), accumulated block-wise in float64 as the JAX package does."""
    win_sq = np.asarray(win_sq_key, dtype=np.float64) ** 2
    g = gcd(n_fft, hop)
    fb, hb = n_fft // g, hop // g
    blocks = win_sq.reshape(fb, g)
    norm = np.zeros((out_len // g, g), dtype=np.float64)
    last = (nf - 1) * hb
    for j in range(fb):
        norm[j : j + last + 1 : hb] += blocks[j]
    norm = norm.reshape(-1)
    return np.where(norm > 1e-11, norm, 1.0).astype(np.float32)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    # F.pad's reflect mode wants a batch dimension in front of the signal
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return y.reshape(lead + y.shape[-1:])


def stft(x: torch.Tensor, n_fft: int = 1024, hop: Optional[int] = None) -> torch.Tensor:
    """Centred short-time Fourier transform with an n_fft-point periodic
    Hann window -> complex ``[..., n_fft//2+1, n_frames]``."""
    hop = hop or n_fft // 4
    x = _reflect_pad(x, n_fft // 2)
    frames = frame_signal(x, n_fft, hop) * hann_window(n_fft, device=x.device)
    spec = torch.fft.rfft(frames, dim=-1)  # [..., nf, n_bins]
    return spec.transpose(-1, -2)  # [..., n_bins, nf]


def istft(spec: torch.Tensor, n_fft: int = 1024, hop: Optional[int] = None,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`stft`: a complex one-sided spectrum ``[..., n_bins,
    n_frames]`` -> the signal, cut to ``length`` samples when given."""
    hop = hop or n_fft // 4
    win_np = np.asarray(_hann_np(n_fft, True), dtype=np.float64)
    win = torch.from_numpy(win_np.astype(np.float32)).to(spec.device)

    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * win
    nf = frames.shape[-2]
    out_len = n_fft + hop * (nf - 1)
    sig = overlap_add(frames, hop, out_len)
    norm = _nola_norm(tuple(win_np.tolist()), n_fft, hop, nf, out_len)
    sig = sig / torch.from_numpy(norm).to(spec.device)

    sig = sig[..., n_fft // 2 :]
    if length is not None:
        sig = sig[..., :length]
    return sig
