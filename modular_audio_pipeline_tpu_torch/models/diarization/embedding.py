"""Speaker embedders (torch).

Counterparts of ``modular_audio_pipeline_tpu/models/diarization/embedding.py``:

- :class:`StatsEmbedder`, weight-free: the mean and population standard
  deviation of MFCCs c1..c19 and of their frame deltas, unit norm; the
  diarizer's fallback when no embedding bundle exists. Per-span
  statistics of the whole timeline's MFCC frames come from host
  cumulative sums (:meth:`~StatsEmbedder.embed_spans`, copied).
- :class:`ConvEmbedder`: MFCCs (c1..c19) -> three convolutions of width
  5, 3, 3 with dilations 1, 2, 3 and symmetric padding, ReLU -> statistics
  pooling (mean and population standard deviation over time) -> linear
  projection to 192 -> unit norm. The f32 convolutions run with TF32 off:
  the embeddings meet the AHC's hard cut-offs.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..vad_net import no_tf32
from .features import mfcc_batch

__all__ = ["ConvEmbedder", "StatsEmbedder"]


class ConvEmbedder(nn.Module):
    """[B, N] audio -> [B, 192] unit-norm speaker embeddings."""

    HIDDEN = 256
    OUT = 192
    DILATIONS = (1, 2, 3)

    def __init__(self, params: Dict[str, Any], sr: int = 16000, device=None):
        from ...utils import resolve_device

        super().__init__()
        self.sr = sr
        self.convs = nn.ModuleList()
        for name, dil in zip(("conv1", "conv2", "conv3"), self.DILATIONS):
            w = np.asarray(params[name]["w"], np.float32)  # [out, in, width]
            conv = nn.Conv1d(w.shape[1], w.shape[0], w.shape[2], dilation=dil,
                             padding=(w.shape[2] - 1) * dil // 2)
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(w))
                conv.bias.copy_(torch.from_numpy(np.asarray(params[name]["b"], np.float32)))
            self.convs.append(conv)
        w = np.asarray(params["proj"]["w"], np.float32)  # [512, 192]
        self.proj = nn.Linear(w.shape[0], w.shape[1])
        with torch.no_grad():
            self.proj.weight.copy_(torch.from_numpy(w.T))
            self.proj.bias.copy_(torch.from_numpy(np.asarray(params["proj"]["b"], np.float32)))
        self.requires_grad_(False)
        self.to(resolve_device(device))

    @classmethod
    def init_params(cls, seed: int = 0) -> Dict[str, Any]:
        """Random parameters in the JAX layout, with the JAX package's
        distributions drawn from a seeded ``torch.Generator`` (other numbers
        than ``jax.random``'s)."""
        g = torch.Generator().manual_seed(seed)
        h = cls.HIDDEN

        def conv(cin, cout, width):
            w = torch.randn((cout, cin, width), generator=g) * (cin * width) ** -0.5
            return {"w": w.numpy(), "b": np.zeros((cout,), np.float32)}

        return {
            "conv1": conv(19, h, 5), "conv2": conv(h, h, 3), "conv3": conv(h, h, 3),
            "proj": {"w": (torch.randn((2 * h, cls.OUT), generator=g) * (2 * h) ** -0.5).numpy(),
                     "b": np.zeros((cls.OUT,), np.float32)},
        }

    def numpy_params(self) -> Dict[str, Any]:
        """The parameters in the JAX layout (host numpy), as ``params.npz``
        holds them: the inverse of ``__init__``."""
        def host(t):
            return t.detach().cpu().numpy().copy()

        out = {name: {"w": host(conv.weight), "b": host(conv.bias)}
               for name, conv in zip(("conv1", "conv2", "conv3"), self.convs)}
        out["proj"] = {"w": host(self.proj.weight.T), "b": host(self.proj.bias)}
        return out

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = mfcc_batch(audio, sr=self.sr)[..., 1:].transpose(1, 2)  # [B, 19, T]
        with no_tf32():
            for conv in self.convs:
                x = F.relu(conv(x))
        stats = torch.cat([x.mean(dim=-1), x.std(dim=-1, correction=0)], dim=-1)
        emb = self.proj(stats)
        return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-8)

    def embed(self, subsegments: torch.Tensor) -> np.ndarray:
        """[B, N] float32 on the module's device -> [B, 192] on the host."""
        return self(subsegments).cpu().numpy()


class StatsEmbedder:
    """MFCC mean/std/delta statistics, L2-normalised, on ``device`` (None:
    CUDA)."""

    def __init__(self, sr: int = 16000, n_mfcc: int = 20, device=None):
        from ...utils import resolve_device

        self.sr = sr
        self.n_mfcc = n_mfcc
        self.device = resolve_device(device)

    def embed(self, subsegments) -> np.ndarray:
        """[B, N] float32 (host or on the device) -> [B, 38] unit-norm
        embeddings on the host."""
        x = torch.as_tensor(subsegments, dtype=torch.float32, device=self.device)
        m = mfcc_batch(x, sr=self.sr, n_mfcc=self.n_mfcc)[..., 1:]  # c0 is loudness
        delta = m[:, 1:] - m[:, :-1]
        emb = torch.cat([m.mean(dim=1), m.std(dim=1, correction=0),
                         delta.mean(dim=1), delta.std(dim=1, correction=0)], dim=-1)
        norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return (emb / torch.clamp(norm, min=1e-8)).cpu().numpy()

    def frame_features(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """MFCC frames c1..c19 of the whole host signal: [T, 19] on the host
        (one device pass over the bucket-padded audio)."""
        from ...ops.bucketing import pad_to_bucket

        frame_len = int(sr * 0.025)
        hop = int(sr * 0.010)
        n_valid = max(0, (len(audio) - frame_len) // hop + 1)
        padded, _ = pad_to_bucket(np.asarray(audio, np.float32), sr)
        x = torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)
        m = mfcc_batch(x[None], sr=sr, n_mfcc=self.n_mfcc).cpu().numpy()
        return m[0, :n_valid, 1:]

    def embed_spans(self, frames: np.ndarray, spans: np.ndarray, sr: int) -> np.ndarray:
        """Embeddings of sample spans [N, 2] from whole-signal MFCC frames
        (host numpy): statistics over the global 10 ms frame grid, from
        cumulative sums."""
        hop = int(sr * 0.010)
        t = frames.shape[0]
        delta = np.diff(frames, axis=0)

        def cum(x):
            return np.concatenate([np.zeros((1, x.shape[1])), np.cumsum(x, axis=0)])

        c1, c2 = cum(frames), cum(frames**2)
        d1, d2 = cum(delta), cum(delta**2)

        f_start = np.clip(spans[:, 0] // hop, 0, max(t - 1, 0))
        f_end = np.clip(spans[:, 1] // hop, f_start + 1, t)
        n = (f_end - f_start).astype(np.float64)[:, None]

        mean = (c1[f_end] - c1[f_start]) / n
        var = np.maximum((c2[f_end] - c2[f_start]) / n - mean**2, 0.0)

        de = np.clip(f_end - 1, 1, max(t - 1, 1))
        ds = np.minimum(f_start, de - 1)
        dn = np.maximum(de - ds, 1).astype(np.float64)[:, None]
        dmean = (d1[de] - d1[ds]) / dn
        dvar = np.maximum((d2[de] - d2[ds]) / dn - dmean**2, 0.0)

        emb = np.concatenate([mean, np.sqrt(var), dmean, np.sqrt(dvar)], axis=1)
        norm = np.linalg.norm(emb, axis=1, keepdims=True)
        return (emb / np.maximum(norm, 1e-8)).astype(np.float32)
