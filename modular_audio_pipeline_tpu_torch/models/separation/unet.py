"""Trainable spectrogram-masking U-Net for vocal separation (torch).

Counterpart of ``MaskUNet`` in
``modular_audio_pipeline_tpu/models/separation/unet.py``: the magnitude
STFT (n_fft 2048, hop 512) is log-compressed, a frequency-coordinate
channel is added, both dimensions are padded to a multiple of 16, and four
stride-2 3x3 convolutions, a 3x3 middle convolution and four stride-2
transposed convolutions with skip connections (ReLU after each) and a 1x1
sigmoid head predict a per-bin vocal mask. The weights load from the same
``params.npz`` (convolutions ``[out, in, kh, kw]``) into frozen parameters
(a trainer unfreezes them); :func:`masking_loss` and :func:`dual_stem_loss`
are the training objectives.

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

__all__ = ["MaskUNet", "masking_loss", "dual_stem_loss"]

_N_FFT = 2048
_HOP = 512
_LEVELS = 4
_BASE = 32  # channel width of the first level


class MaskUNet(nn.Module):
    """[B, F, T] magnitude -> [B, F, T] vocal mask in (0, 1)."""

    def __init__(self, params: Dict[str, Any], device=None):
        from ...utils import resolve_device
        from ..whisper.convert import params_from_numpy

        super().__init__()
        tensors = params_from_numpy(params, "cpu", torch.float32)
        self.names = list(tensors)
        for name, p in tensors.items():
            self.register_parameter(f"{name}_w", nn.Parameter(p["w"]))
            self.register_parameter(f"{name}_b", nn.Parameter(p["b"]))
        self.requires_grad_(False)
        self.to(resolve_device(device))

    @staticmethod
    def init_params(seed: int = 0) -> Dict[str, Any]:
        """Random parameters in the JAX layout, with the JAX package's
        distributions drawn from a seeded ``torch.Generator`` (other numbers
        than ``jax.random``'s)."""
        g = torch.Generator().manual_seed(seed)

        def conv_p(cin, cout, kh=3, kw=3):
            w = torch.randn((cout, cin, kh, kw), generator=g) * (cin * kh * kw) ** -0.5
            return {"w": w.numpy(), "b": np.zeros((cout,), np.float32)}

        params: Dict[str, Any] = {}
        cin = 2  # log-magnitude + frequency coordinate
        for lvl in range(_LEVELS):
            params[f"down{lvl}"] = conv_p(cin, _BASE * 2**lvl)
            cin = _BASE * 2**lvl
        params["mid"] = conv_p(cin, cin)
        for lvl in reversed(range(_LEVELS)):
            cout = _BASE * 2**lvl
            params[f"up{lvl}"] = conv_p(cin + cout, cout)
            cin = cout
        params["head"] = conv_p(cin, 1, 1, 1)
        return params

    def numpy_params(self) -> Dict[str, Any]:
        """The parameters in the JAX layout (host numpy), as ``params.npz``
        holds them."""
        return {name: {k: getattr(self, f"{name}_{k}").detach().cpu().numpy().copy()
                       for k in ("w", "b")} for name in self.names}

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


def masking_loss(net: MaskUNet, mix_mag: torch.Tensor, vocal_mag: torch.Tensor) -> torch.Tensor:
    """L1 between the masked mixture and the target vocal magnitudes."""
    mask = net(mix_mag)
    return torch.mean(torch.abs(mask * mix_mag - vocal_mag))


def dual_stem_loss(net: MaskUNet, mix_mag: torch.Tensor, vocal_mag: torch.Tensor,
                   music_mag: torch.Tensor) -> torch.Tensor:
    """L1 on both stems: ``mask * mix`` against the vocals and ``(1 - mask)
    * mix`` against the music (the accompaniment term pushes the mask to
    zero where music dominates)."""
    mask = net(mix_mag)
    vocal_term = torch.mean(torch.abs(mask * mix_mag - vocal_mag))
    music_term = torch.mean(torch.abs((1.0 - mask) * mix_mag - music_mag))
    return vocal_term + music_term
