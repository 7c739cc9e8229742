"""Frame extraction and window functions (torch).

Counterpart of ``modular_audio_pipeline_tpu/ops/framing.py`` for the
pieces the Whisper front end needs. The JAX version builds frames from
strided slices to keep gather constants out of compiled programs; here
``Tensor.unfold`` gives the same frames as a strided view.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["frame_signal", "hann_window"]


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
