"""Powerset speaker-segmentation network (pyannote-3.1-class), torch.

Counterpart of ``modular_audio_pipeline_tpu/models/diarization/segmentation.py``:
MFCC frames [B, T, 40] -> linear -> two pre-norm transformer blocks (4
heads of 32, GELU in its tanh form, as ``jax.nn.gelu`` defaults to) ->
7-way powerset logits over up to 3 local speakers; the marginal activity
of each speaker, rounded to f16 as the JAX package ships it to the host;
the sliding-window layout and the host aggregation of overlapping windows.

Self-attention goes through ``ops.attention.flash_attention``: the
hand-written kernel on a CUDA tensor (f32 at head dim 32, its CUDA-core route),
the plain version on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import flash_attention

__all__ = ["SegmentationNet", "powerset_decode", "sliding_windows", "aggregate_windows",
           "WINDOW_S", "STEP_S"]

# powerset classes over 3 local speakers
_CLASSES = ((), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2))
N_CLASSES = len(_CLASSES)
N_SPEAKERS = 3

WINDOW_S = 10.0
STEP_S = 1.0
_N_MELS = 40


def _linear(w: np.ndarray, b=None) -> nn.Linear:
    """nn.Linear holding the JAX layout's ``x @ w + b`` (w [in, out])."""
    lin = nn.Linear(w.shape[0], w.shape[1], bias=b is not None)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(w, np.float32).T))
        if b is not None:
            lin.bias.copy_(torch.from_numpy(np.asarray(b, np.float32)))
    return lin


def _layer_norm(p: Dict[str, Any], d: int) -> nn.LayerNorm:
    ln = nn.LayerNorm(d, eps=1e-5)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(np.asarray(p["g"], np.float32)))
        ln.bias.copy_(torch.from_numpy(np.asarray(p["b"], np.float32)))
    return ln


class _Block(nn.Module):
    def __init__(self, p: Dict[str, Any], d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln1 = _layer_norm(p["ln1"], d)
        self.qkv = _linear(p["qkv"])
        self.o = _linear(p["o"])
        self.ln2 = _layer_norm(p["ln2"], d)
        self.fc1 = _linear(p["fc1"])
        self.fc2 = _linear(p["fc2"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        q, k, v = self.qkv(self.ln1(x)).split(d, dim=-1)

        def split(t):  # the kernel takes contiguous [B, H, S, hd]
            return t.reshape(b, s, self.heads, d // self.heads).transpose(1, 2).contiguous()

        o = flash_attention(split(q), split(k), split(v))
        x = x + self.o(o.transpose(1, 2).reshape(b, s, d))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))


class SegmentationNet(nn.Module):
    """mel [B, T, 40] -> powerset logits [B, T, 7]."""

    D = 128
    LAYERS = 2
    HEADS = 4

    def __init__(self, params: Dict[str, Any], device=None):
        from ...utils import resolve_device

        super().__init__()
        self.inp = _linear(params["inp"]["w"], params["inp"]["b"])
        blocks = params["blocks"]  # leaves stacked over layers
        self.blocks = nn.ModuleList(
            _Block(_layer_slice(blocks, i), self.D, self.HEADS) for i in range(self.LAYERS))
        self.head = _linear(params["head"]["w"], params["head"]["b"])
        member = [[1.0 if s in m else 0.0 for s in range(N_SPEAKERS)] for m in _CLASSES]
        self.register_buffer("member", torch.tensor(member, dtype=torch.float32))
        self.requires_grad_(False)
        self.to(resolve_device(device))

    @classmethod
    def init_params(cls, seed: int = 0) -> Dict[str, Any]:
        """Random parameters in the JAX layout (blocks stacked over layers),
        with the JAX package's distributions drawn from a seeded
        ``torch.Generator`` (other numbers than ``jax.random``'s)."""
        g = torch.Generator().manual_seed(seed)
        d = cls.D

        def mat(din, dout, lead=()):
            return (torch.randn(lead + (din, dout), generator=g) * din**-0.5).numpy()

        def ln():
            return {"g": np.ones((cls.LAYERS, d), np.float32),
                    "b": np.zeros((cls.LAYERS, d), np.float32)}

        n = (cls.LAYERS,)
        return {
            "inp": {"w": mat(_N_MELS, d), "b": np.zeros((d,), np.float32)},
            "head": {"w": mat(d, N_CLASSES), "b": np.zeros((N_CLASSES,), np.float32)},
            "blocks": {"qkv": mat(d, 3 * d, n), "o": mat(d, d, n), "ln1": ln(),
                       "fc1": mat(d, 4 * d, n), "fc2": mat(4 * d, d, n), "ln2": ln()},
        }

    def numpy_params(self) -> Dict[str, Any]:
        """The parameters in the JAX layout (host numpy, blocks stacked over
        layers), as ``params.npz`` holds them: the inverse of ``__init__``."""
        def wt(lin):  # nn.Linear's [out, in] -> the JAX layout's [in, out]
            return lin.weight.detach().cpu().numpy().T.copy()

        def vec(t):
            return t.detach().cpu().numpy().copy()

        def stack(fn):
            return np.stack([fn(b) for b in self.blocks])

        return {
            "inp": {"w": wt(self.inp), "b": vec(self.inp.bias)},
            "head": {"w": wt(self.head), "b": vec(self.head.bias)},
            "blocks": {
                "qkv": stack(lambda b: wt(b.qkv)), "o": stack(lambda b: wt(b.o)),
                "fc1": stack(lambda b: wt(b.fc1)), "fc2": stack(lambda b: wt(b.fc2)),
                "ln1": {"g": stack(lambda b: vec(b.ln1.weight)),
                        "b": stack(lambda b: vec(b.ln1.bias))},
                "ln2": {"g": stack(lambda b: vec(b.ln2.weight)),
                        "b": stack(lambda b: vec(b.ln2.bias))},
            },
        }

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.inp(mel)
        for block in self.blocks:
            x = block(x)
        return self.head(x)

    def marginals(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, 40] -> per-speaker marginal activity [B, T, 3] f16
        (softmax over the powerset classes, summed per speaker)."""
        probs = torch.softmax(self(mel), dim=-1)
        return (probs @ self.member).to(torch.float16)


def _layer_slice(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: _layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def powerset_decode(logits: np.ndarray) -> np.ndarray:
    """Powerset logits [..., 7] -> marginal per-speaker activity [..., 3]."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    out = np.zeros(logits.shape[:-1] + (N_SPEAKERS,), dtype=np.float32)
    for cls_idx, members in enumerate(_CLASSES):
        for spk in members:
            out[..., spk] += probs[..., cls_idx]
    return out


def sliding_windows(
    n_samples: int, sr: int, window_s: float = WINDOW_S, step_s: float = STEP_S
) -> List[Tuple[int, int]]:
    """Sample spans of the sliding segmentation windows (pyannote layout)."""
    win = int(window_s * sr)
    step = int(step_s * sr)
    if n_samples <= win:
        return [(0, n_samples)]
    spans = [(s, s + win) for s in range(0, n_samples - win + 1, step)]
    if spans[-1][1] < n_samples:
        spans.append((n_samples - win, n_samples))
    return spans


def aggregate_windows(
    window_acts: np.ndarray,  # [n_windows, T, 3]
    spans: List[Tuple[int, int]],
    n_samples: int,
    sr: int,
) -> np.ndarray:
    """Overlap-average window activities onto the global 10 ms frame grid,
    aligning speakers between overlapping windows by the best-overlap
    permutation against the running aggregate."""
    from itertools import permutations

    hop = sr // 100
    n_frames = n_samples // hop
    acc = np.zeros((n_frames, N_SPEAKERS), dtype=np.float64)
    weight = np.zeros((n_frames, 1), dtype=np.float64)

    for (start, _end), acts in zip(spans, window_acts):
        f0 = start // hop
        t = min(acts.shape[0], n_frames - f0)
        if t <= 0:
            continue
        seg = acts[:t]
        prev = acc[f0 : f0 + t] / np.maximum(weight[f0 : f0 + t], 1e-9)
        if weight[f0 : f0 + t].sum() > 0:
            best, best_score = None, -np.inf
            for perm in permutations(range(N_SPEAKERS)):
                score = float((prev * seg[:, perm]).sum())
                if score > best_score:
                    best, best_score = perm, score
            seg = seg[:, best]
        acc[f0 : f0 + t] += seg
        weight[f0 : f0 + t] += 1.0
    return (acc / np.maximum(weight, 1e-9)).astype(np.float32)
