"""Frame extraction, overlap-add and window functions (torch).

Counterpart of ``modular_audio_pipeline_tpu/ops/framing.py``. The JAX
version builds frames from strided slices to keep gather constants out of
compiled programs; here ``Tensor.unfold`` gives the same frames as a
strided view. ``overlap_add`` adds the frames' base blocks in the JAX
version's order, so the two sum each output sample alike.
"""

from __future__ import annotations

import functools
from math import gcd

import numpy as np
import torch

__all__ = ["frame_signal", "hann_window", "overlap_add"]


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Slice ``x[..., n]`` into overlapping frames -> ``[..., n_frames, frame_length]``."""
    return x.unfold(-1, frame_length, hop)


@functools.lru_cache(maxsize=32)
def _hann_np(n: int, periodic: bool) -> np.ndarray:
    m = n if periodic else n - 1
    if m <= 0:
        return np.ones(max(n, 1), dtype=np.float32)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / m)).astype(np.float32)


def hann_window(n: int, periodic: bool = True, device="cpu") -> torch.Tensor:
    """Hann window, computed in numpy exactly as the JAX package does."""
    return torch.from_numpy(_hann_np(n, periodic)).to(device)


def overlap_add(frames: torch.Tensor, hop: int, out_len: int) -> torch.Tensor:
    """Overlap-add frames ``[..., n_frames, frame_length]`` into a signal of
    ``out_len`` samples (a multiple of gcd(frame_length, hop))."""
    nf, fl = frames.shape[-2], frames.shape[-1]
    g = gcd(fl, hop)
    fb, hb = fl // g, hop // g
    n_blocks = out_len // g
    if n_blocks * g != out_len:
        raise ValueError("out_len must be a multiple of gcd(frame, hop)")
    frames3 = frames.reshape(frames.shape[:-2] + (nf, fb, g))
    out = frames.new_zeros(frames.shape[:-2] + (n_blocks, g))
    last = (nf - 1) * hb
    for j in range(fb):
        out[..., j : j + last + 1 : hb, :] += frames3[..., :, j, :]
    return out.reshape(frames.shape[:-2] + (out_len,))
