"""BS.1770 K-weighting in the frequency domain (torch).

Counterpart of the K-weighting half of
``modular_audio_pipeline_tpu/ops/loudness.py``: the two-stage filter
(+4 dB high-shelf at 1500 Hz, Q 1/sqrt(2); high-pass at 38 Hz, Q 0.5, the
parametric design pyloudnorm uses) applied as one rfft/irfft pair with
the cascade's exact transfer function per bin. With at least 1 s of zero
padding the circular tail is below -120 dB, so this equals zero-state
time-domain filtering to float precision. The gating and the gain are
host arithmetic (``serving._whole_file_gain``).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

__all__ = ["k_weighting_coefficients", "k_weight"]


def _next_fast_len(n: int) -> int:
    """Smallest power of two >= n (the JAX package's FFT length)."""
    return 1 << (n - 1).bit_length()


@lru_cache(maxsize=8)
def k_weighting_coefficients(fs: int) -> Tuple[Tuple[float, ...], ...]:
    """((b, a) high-shelf, (b, a) high-pass) for sample rate ``fs``."""
    G, q, fc = 4.0, 1.0 / math.sqrt(2.0), 1500.0
    A = 10.0 ** (G / 40.0)
    w0 = 2.0 * math.pi * fc / fs
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    b_hs = np.array(
        [
            A * ((A + 1) + (A - 1) * cw + 2 * math.sqrt(A) * alpha),
            -2 * A * ((A - 1) + (A + 1) * cw),
            A * ((A + 1) + (A - 1) * cw - 2 * math.sqrt(A) * alpha),
        ]
    )
    a_hs = np.array(
        [
            (A + 1) - (A - 1) * cw + 2 * math.sqrt(A) * alpha,
            2 * ((A - 1) - (A + 1) * cw),
            (A + 1) - (A - 1) * cw - 2 * math.sqrt(A) * alpha,
        ]
    )
    b_hs, a_hs = b_hs / a_hs[0], a_hs / a_hs[0]

    q, fc = 0.5, 38.0
    w0 = 2.0 * math.pi * fc / fs
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    b_hp = np.array([(1 + cw) / 2.0, -(1 + cw), (1 + cw) / 2.0])
    a_hp = np.array([1 + alpha, -2 * cw, 1 - alpha])
    b_hp, a_hp = b_hp / a_hp[0], a_hp / a_hp[0]

    return (tuple(b_hs), tuple(a_hs)), (tuple(b_hp), tuple(a_hp))


def k_weight(x: torch.Tensor, fs: int) -> torch.Tensor:
    """Apply the two-stage K-weighting filter along the last axis (f32;
    the transfer function is evaluated in complex64, as in JAX)."""
    (b1, a1), (b2, a2) = k_weighting_coefficients(fs)
    n = x.shape[-1]
    nfft = _next_fast_len(n + fs)
    xp = torch.nn.functional.pad(x.float(), (0, nfft - n))
    spec = torch.fft.rfft(xp, dim=-1)
    w = torch.arange(spec.shape[-1], dtype=torch.float32, device=x.device) * (2.0 * np.pi / nfft)
    z1 = torch.polar(torch.ones_like(w), -w)  # e^{-jw}
    z2 = z1 * z1

    def response(b, a):
        return (b[0] + b[1] * z1 + b[2] * z2) / (1.0 + a[1] * z1 + a[2] * z2)

    h = response(b1, a1) * response(b2, a2)
    y = torch.fft.irfft(spec * h, n=nfft, dim=-1)
    return y[..., :n]
