"""ITU-R BS.1770-4 loudness metering and normalisation (torch).

Counterpart of ``modular_audio_pipeline_tpu/ops/loudness.py``:

- :func:`k_weight`: the two-stage filter (+4 dB high-shelf at 1500 Hz,
  Q 1/sqrt(2); high-pass at 38 Hz, Q 0.5, the parametric design
  pyloudnorm uses) applied as one rfft/irfft pair with the cascade's
  exact transfer function per bin. With at least 1 s of zero padding the
  circular tail is below -120 dB, so this equals zero-state time-domain
  filtering to float precision.
- :func:`integrated_loudness`: 400 ms gating blocks at 75 % overlap, the
  absolute -70 LUFS and relative -10 LU gates; ``-inf`` for silence.
- :func:`normalize_loudness` and :func:`measure_and_normalize`: a linear
  gain to the target loudness with a unity-peak limiter. The -70 LUFS
  skip is the caller's decision on the returned scalar.

The serving path gates on the host instead (``serving._whole_file_gain``).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

__all__ = ["k_weighting_coefficients", "k_weight", "integrated_loudness",
           "normalize_loudness", "measure_and_normalize"]

_ABS_GATE_LUFS = -70.0
_REL_GATE_LU = -10.0
_BLOCK_S = 0.400
_STEP_S = 0.100
_OFFSET = -0.691


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


def _block_mean_squares(y: torch.Tensor, fs: int) -> torch.Tensor:
    """Per-gating-block mean square of the K-weighted signal."""
    from .framing import frame_signal

    block = int(round(_BLOCK_S * fs))
    step = int(round(_STEP_S * fs))
    frames = frame_signal(y, block, step)  # [..., n_blocks, block]
    return torch.mean(frames * frames, dim=-1)


def integrated_loudness(x: torch.Tensor, fs: int) -> torch.Tensor:
    """Gated integrated loudness (LUFS, f32 scalar) of a mono signal;
    ``-inf`` for silence and for signals shorter than one 400 ms block."""
    if x.shape[-1] < int(round(_BLOCK_S * fs)):
        return torch.tensor(-float("inf"), dtype=torch.float32, device=x.device)
    z = _block_mean_squares(k_weight(x, fs), fs)  # [..., n_blocks]
    block_lufs = _OFFSET + 10.0 * torch.log10(torch.clamp(z, min=1e-30))

    abs_mask = block_lufs > _ABS_GATE_LUFS
    abs_count = torch.clamp(abs_mask.sum(dim=-1), min=1)
    z_abs = torch.where(abs_mask, z, 0.0).sum(dim=-1) / abs_count
    rel_gate = _OFFSET + 10.0 * torch.log10(torch.clamp(z_abs, min=1e-30)) + _REL_GATE_LU

    both_mask = abs_mask & (block_lufs > rel_gate)
    both_count = both_mask.sum(dim=-1)
    z_gated = torch.where(both_mask, z, 0.0).sum(dim=-1) / torch.clamp(both_count, min=1)
    lufs = _OFFSET + 10.0 * torch.log10(torch.clamp(z_gated, min=1e-30))
    return torch.where(both_count > 0, lufs, -float("inf")).float()


def normalize_loudness(x: torch.Tensor, measured_lufs, target_lufs: float = -16.0
                       ) -> torch.Tensor:
    """Linear gain to the target loudness, then a unity-peak limiter."""
    gain = 10.0 ** ((target_lufs - measured_lufs) / 20.0)
    out = x * gain
    peak = torch.amax(out.abs())
    return torch.where(peak > 1.0, out / torch.clamp(peak, min=1e-12), out)


def measure_and_normalize(x: torch.Tensor, fs: int, target_lufs: float = -16.0):
    """``(normalized, measured_lufs)``: unity gain when the measurement is
    not finite; the caller applies the skip below -70 LUFS."""
    lufs = integrated_loudness(x, fs)
    safe = torch.where(torch.isfinite(lufs), lufs, torch.full_like(lufs, target_lufs))
    return normalize_loudness(x, safe, target_lufs), lufs
