"""Conv x-vector-style speaker embedder (torch).

Counterpart of ``ConvEmbedder`` in
``modular_audio_pipeline_tpu/models/diarization/embedding.py``: MFCCs
(c1..c19) -> three convolutions of width 5, 3, 3 with dilations 1, 2, 3
and symmetric padding, ReLU -> statistics pooling (mean and population
standard deviation over time) -> linear projection to 192 -> unit norm.
The f32 convolutions run with TF32 off: the embeddings meet the AHC's
hard cut-offs. ``StatsEmbedder``, the JAX package's weight-free fallback
when no bundle exists, is not ported yet and raises.
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
    """The weight-free MFCC-statistics embedder: not ported yet."""

    def __init__(self, *args, **kwargs):
        from ...utils import not_ported

        raise not_ported("StatsEmbedder (diarization without an embedding bundle)",
                         "StatsEmbedder")
