"""Stationary spectral-gating noise reduction (torch).

Counterpart of ``modular_audio_pipeline_tpu/ops/spectral_gate.py``, the
replacement for ``noisereduce.reduce_noise(..., stationary=True,
prop_decrease=0.8)``:

1. STFT of the signal and of a noise clip (n_fft 1024, hop 256, Hann).
2. Per-frequency threshold = mean dB of the noise + ``n_std_thresh`` x its
   population standard deviation (ddof 0, as ``jnp.std``).
3. Binary keep-mask where the signal's dB exceeds the threshold. The
   comparison is of f32 values from two FFT libraries, so a bin within
   float noise of its threshold may fall the other way than in the JAX
   package (``tests/test_torch_dsp.py`` counts such bins).
4. The mask smoothed by a separable triangle (box of box) with zero
   padding, through cumulative sums: the mask is 0/1, so its sums are
   integers, exact in f32 at these sizes.
5. Gain = mask x prop_decrease + (1 - prop_decrease) on the complex STFT,
   inverse STFT back to the waveform.
"""

from __future__ import annotations

import torch

from .stft import istft, stft

__all__ = ["spectral_gate_stationary", "amp_to_db"]

_EPS = 1e-20


def amp_to_db(x: torch.Tensor, top_db: float = 80.0) -> torch.Tensor:
    """20*log10(|x|) clamped to ``max - top_db`` (librosa convention)."""
    db = 20.0 * torch.log10(torch.clamp(x.abs(), min=_EPS))
    return torch.maximum(db, db.max() - top_db)


def _box_filter(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Zero-padded 'same' box filter of length ``n`` along ``dim``, by
    cumulative sums (the JAX package's formulation)."""
    if n <= 1:
        return x
    x = x.movedim(dim, -1)
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)  # [.., t+1]
    left = n // 2
    idx = torch.arange(t, device=x.device)
    hi = torch.clamp(idx + (n - left), max=t)
    lo = torch.clamp(idx - left, min=0)
    out = cs[..., hi] - cs[..., lo]
    return out.movedim(-1, dim)


def _smooth_mask(mask: torch.Tensor, n_freq: int, n_time: int) -> torch.Tensor:
    """Separable triangle smoothing (box of box per axis), normalised."""
    out = mask
    norm_const = 1.0
    for n, dim in ((n_freq, 0), (n_time, 1)):
        if n > 1:
            out = _box_filter(_box_filter(out, n, dim), n, dim)
            norm_const *= float(n * n)
    return out / norm_const


def spectral_gate_stationary(
    audio: torch.Tensor,
    noise_clip: torch.Tensor,
    sr: int,
    n_fft: int = 1024,
    hop: int = 256,
    prop_decrease: float = 0.8,
    n_std_thresh: float = 1.5,
    freq_mask_smooth_hz: float = 500.0,
    time_mask_smooth_ms: float = 50.0,
) -> torch.Tensor:
    """Denoise ``audio`` given a representative ``noise_clip`` (both 1-D f32)."""
    length = audio.shape[-1]
    sig_stft = stft(audio, n_fft=n_fft, hop=hop)  # [freq, time]
    noise_db = amp_to_db(stft(noise_clip, n_fft=n_fft, hop=hop))
    sig_db = amp_to_db(sig_stft)

    noise_mean = noise_db.mean(dim=-1, keepdim=True)  # per frequency
    noise_std = noise_db.std(dim=-1, keepdim=True, correction=0)
    thresh = noise_mean + n_std_thresh * noise_std
    mask = (sig_db > thresh).float()

    n_freq = max(1, int(freq_mask_smooth_hz / (sr / n_fft)))
    n_time = max(1, int(time_mask_smooth_ms / 1000.0 * (sr / hop)))
    mask = _smooth_mask(mask, n_freq, n_time)

    gain = mask * prop_decrease + (1.0 - prop_decrease)
    return istft(sig_stft * gain, n_fft=n_fft, hop=hop, length=length)
