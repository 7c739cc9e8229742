"""Trainable spectrogram-masking U-Net for vocal separation (torch).

Counterpart of ``MaskUNet`` in
``modular_audio_pipeline_tpu/models/separation/unet.py``: the magnitude
STFT (n_fft 2048, hop 512) is log-compressed, a frequency-coordinate
channel is added, both dimensions are padded to a multiple of 16, and four
stride-2 3x3 convolutions, a 3x3 middle convolution and four stride-2
transposed convolutions with skip connections (ReLU after each) and a 1x1
sigmoid head predict a per-bin vocal mask. The weights load from the same
``params.npz`` (convolutions ``[out, in, kh, kw]``).

The JAX package's "SAME" padding is kept exactly. A stride-2 convolution
over an even size pads 0 before and 1 after (``F.conv2d``'s ``padding=1``
would pad 1 and 1). ``lax.conv_transpose`` does not flip its kernel and
pads the dilated input 2 before and 1 after: ``F.conv_transpose2d`` with
the kernel flipped, ``padding=0``, cut to twice the input size. The f32
convolutions run with TF32 off, on CUDA unless a device is given.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.stft import istft, stft
from ..vad_net import no_tf32

__all__ = ["MaskUNet"]

_N_FFT = 2048
_HOP = 512
_LEVELS = 4


class MaskUNet(nn.Module):
    """[B, F, T] magnitude -> [B, F, T] vocal mask in (0, 1)."""

    def __init__(self, params: Dict[str, Any], device=None):
        from ...utils import resolve_device
        from ..whisper.convert import params_from_numpy

        super().__init__()
        tensors = params_from_numpy(params, "cpu", torch.float32)
        for name, p in tensors.items():
            self.register_buffer(f"{name}_w", p["w"])
            self.register_buffer(f"{name}_b", p["b"])
        self.to(resolve_device(device))

    def _wb(self, name: str):
        return getattr(self, f"{name}_w"), getattr(self, f"{name}_b")

    def forward(self, mag: torch.Tensor) -> torch.Tensor:
        """mag [B, F, T] (log-compressed inside) -> mask [B, F, T]."""
        x = torch.log1p(mag)[:, None]  # [B, 1, F, T]
        f, t = x.shape[-2], x.shape[-1]
        # frequency-coordinate channel: whether a bin is vocal depends on
        # its absolute frequency, which a convolution cannot see
        freq = torch.linspace(-1.0, 1.0, f, dtype=x.dtype, device=x.device)
        x = torch.cat([x, freq[None, None, :, None].expand_as(x)], dim=1)
        mult = 2**_LEVELS
        x = F.pad(x, (0, (-t) % mult, 0, (-f) % mult))

        skips = []
        with no_tf32():
            for lvl in range(_LEVELS):
                # "SAME" at stride 2 over an even size: 0 before, 1 after
                x = F.relu(F.conv2d(F.pad(x, (0, 1, 0, 1)), *self._wb(f"down{lvl}"), stride=2))
                skips.append(x)
            x = F.relu(F.conv2d(x, *self._wb("mid"), padding=1))
            for lvl in reversed(range(_LEVELS)):
                x = torch.cat([x, skips[lvl]], dim=1)
                h, w = x.shape[-2:]
                wt, b = self._wb(f"up{lvl}")
                y = F.conv_transpose2d(x, wt.permute(1, 0, 2, 3).flip(-1, -2), b, stride=2)
                x = F.relu(y[..., : 2 * h, : 2 * w])
            mask = torch.sigmoid(F.conv2d(x, *self._wb("head")))
        return mask[:, 0, :f, :t]

    def _spec_and_mask(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """STFT of a waveform [n] f32 and the network's vocal mask over it."""
        spec = stft(x, n_fft=_N_FFT, hop=_HOP)
        return spec, self(spec.abs()[None])[0]

    def separate_device(self, x: torch.Tensor) -> torch.Tensor:
        """Vocal stem of a device waveform [n] f32 -> [n] f32 on the same
        device: STFT, mask, masked resynthesis."""
        spec, mask = self._spec_and_mask(x)
        return istft(spec * mask, n_fft=_N_FFT, hop=_HOP, length=x.shape[0])

    def separate(self, audio: np.ndarray, sr: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host (vocals, accompaniment) of host audio, computed on the
        module's device."""
        x = torch.from_numpy(np.ascontiguousarray(audio, dtype=np.float32)).to(self.head_w.device)
        spec, mask = self._spec_and_mask(x)
        vocals = istft(spec * mask, n_fft=_N_FFT, hop=_HOP, length=len(audio))
        music = istft(spec * (1.0 - mask), n_fft=_N_FFT, hop=_HOP, length=len(audio))
        return vocals.cpu().numpy().astype(np.float32), music.cpu().numpy().astype(np.float32)
