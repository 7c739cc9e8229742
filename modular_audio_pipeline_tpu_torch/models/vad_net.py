"""The trained ConvVAD as a torch module, and probability post-processing.

Counterpart of ``modular_audio_pipeline_tpu/models/vad_net.py``:

- :class:`ConvVAD`: log band energies of each 512-sample window (16
  log-spaced bands of its power spectrum), three causal width-3
  convolutions (left padding 2) with ReLU, a linear head and a sigmoid:
  one speech probability per 32 ms window. The weights load from the
  same ``params.npz`` (convolutions in torch's ``[out, in, width]``
  layout already), onto CUDA unless a device is given. The f32 convolutions run with TF32 off (cuDNN allows
  it by default): the probabilities meet a hard threshold.
- :func:`energy_speech_probs`: the weight-free sub-band SNR score mapped
  through a sigmoid (host numpy, copied).
- :func:`speech_timestamps_from_probs`: Silero's hysteresis
  post-processing (host, copied).
- :class:`SileroVAD`: the converted torch.hub Silero v5 graph, its LSTM
  state carried across calls.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = [
    "ConvVAD",
    "SileroVAD",
    "energy_speech_probs",
    "speech_timestamps_from_probs",
    "WINDOW_SAMPLES",
    "no_tf32",
]

WINDOW_SAMPLES = 512  # Silero's 32 ms @ 16 kHz


def no_tf32():
    """Context in which cuDNN runs f32 convolutions in full f32."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def energy_speech_probs(audio: np.ndarray, sr: int) -> np.ndarray:
    """Per-512-sample-window speech probability from sub-band SNR."""
    from ..ops.vad_ops import _BAND_EDGES

    n = (len(audio) // WINDOW_SAMPLES) * WINDOW_SAMPLES
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    frames = audio[:n].reshape(-1, WINDOW_SAMPLES)
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    freqs = np.fft.rfftfreq(WINDOW_SAMPLES, 1.0 / sr)
    bands = []
    for lo, hi in zip(_BAND_EDGES[:-1], _BAND_EDGES[1:]):
        sel = (freqs >= lo) & (freqs < hi)
        bands.append(spec[:, sel].sum(axis=-1))
    bands = np.stack(bands, axis=-1)  # [nf, 6]
    k = max(1, len(bands) // 10)
    floor = np.sort(bands, axis=0)[:k].mean(axis=0) + 1e-12
    score = np.log2(1.0 + bands / floor).sum(axis=-1)
    frame_db = 10 * np.log10(np.mean(frames**2, axis=-1) + 1e-12)
    prob = 1.0 / (1.0 + np.exp(-(score - 7.0) / 2.0))
    prob = np.where(frame_db < -60.0, 0.0, prob)
    return prob.astype(np.float32)


def _band_edges(n_bins: int, n_bands: int) -> np.ndarray:
    """The JAX package's 16 log-spaced band edges over the power bins,
    made unique and padded upward to n_bands + 1 edges."""
    edges = np.unique(np.geomspace(2, n_bins - 1, n_bands + 1).astype(int))
    while len(edges) < n_bands + 1:
        edges = np.append(edges, edges[-1] + 1)
    return edges


class ConvVAD(nn.Module):
    """Tiny causal conv VAD: 16 log band energies -> 3 conv layers -> prob."""

    N_MELS = 16
    HIDDEN = 64

    def __init__(self, params: Dict[str, Any], device=None):
        from ..utils import resolve_device

        super().__init__()
        h, m = self.HIDDEN, self.N_MELS
        self.conv1 = nn.Conv1d(m, h, 3)
        self.conv2 = nn.Conv1d(h, h, 3)
        self.conv3 = nn.Conv1d(h, h, 3)
        self.head = nn.Linear(h, 1)
        with torch.no_grad():
            for name in ("conv1", "conv2", "conv3"):
                conv = getattr(self, name)
                conv.weight.copy_(torch.from_numpy(np.asarray(params[name]["w"], np.float32)))
                conv.bias.copy_(torch.from_numpy(np.asarray(params[name]["b"], np.float32)))
            self.head.weight.copy_(torch.from_numpy(np.asarray(params["head"]["w"], np.float32).T))
            self.head.bias.copy_(torch.from_numpy(np.asarray(params["head"]["b"], np.float32)))
        self.requires_grad_(False)
        self.to(resolve_device(device))

    @staticmethod
    def features(audio: torch.Tensor) -> torch.Tensor:
        """[..., T] -> [..., n_windows, N_MELS] log10 band energies per 512 samples."""
        n = (audio.shape[-1] // WINDOW_SAMPLES) * WINDOW_SAMPLES
        frames = audio[..., :n].reshape(audio.shape[:-1] + (-1, WINDOW_SAMPLES))
        spec = torch.fft.rfft(frames, dim=-1).abs() ** 2  # [..., nw, 257]
        edges = _band_edges(spec.shape[-1], ConvVAD.N_MELS)
        bands = [spec[..., lo:hi].sum(dim=-1) for lo, hi in zip(edges[:-1], edges[1:])]
        return torch.log10(torch.stack(bands, dim=-1) + 1e-10)

    @staticmethod
    def init_params(seed: int = 0) -> Dict[str, np.ndarray]:
        """Random parameters in the JAX layout, with the JAX package's
        distributions drawn from a seeded ``torch.Generator`` (other numbers
        than ``jax.random``'s)."""
        g = torch.Generator().manual_seed(seed)
        h, m = ConvVAD.HIDDEN, ConvVAD.N_MELS

        def conv(cin, cout, width):
            w = torch.randn((cout, cin, width), generator=g) * (cin * width) ** -0.5
            return {"w": w.numpy(), "b": np.zeros((cout,), np.float32)}

        return {
            "conv1": conv(m, h, 3), "conv2": conv(h, h, 3), "conv3": conv(h, h, 3),
            "head": {"w": (torch.randn((h, 1), generator=g) * h**-0.5).numpy(),
                     "b": np.zeros((1,), np.float32)},
        }

    def numpy_params(self) -> Dict[str, Any]:
        """The parameters in the JAX layout (host numpy), as ``params.npz``
        holds them: the inverse of ``__init__``."""
        def host(t):
            return t.detach().cpu().numpy().copy()

        out = {name: {"w": host(getattr(self, name).weight), "b": host(getattr(self, name).bias)}
               for name in ("conv1", "conv2", "conv3")}
        out["head"] = {"w": host(self.head.weight.T), "b": host(self.head.bias)}
        return out

    def logits(self, feats: torch.Tensor) -> torch.Tensor:
        """[..., n_windows, N_MELS] log band energies -> [..., n_windows] logits."""
        lead = feats.shape[:-2]
        x = feats.reshape((-1,) + feats.shape[-2:]).transpose(1, 2)  # [B, C, T]
        with no_tf32():
            for conv in (self.conv1, self.conv2, self.conv3):
                x = F.relu(conv(F.pad(x, (2, 0))))  # causal: pad 2 on the left only
        return self.head(x.transpose(1, 2))[..., 0].reshape(lead + x.shape[-1:])

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """[..., n_windows, N_MELS] log band energies -> [..., n_windows] probabilities."""
        return torch.sigmoid(self.logits(feats))

    def speech_probs(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """Host audio -> host probabilities, one per 512-sample window."""
        if sr != 16000:
            from ..audio_io import resample_poly

            audio = resample_poly(audio, sr, 16000)
        if len(audio) < WINDOW_SAMPLES:
            return np.zeros(0, dtype=np.float32)
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.head.weight.device)
        return self(self.features(x)).cpu().numpy()


class SileroVAD(nn.Module):
    """The public Silero VAD v5 graph (16 kHz branch), from a converted
    bundle (:mod:`..models.silero_convert`).

    Per 512-sample chunk with 64 samples of left context: the STFT as a
    basis convolution (n_fft 256, hop 128, VALID) -> magnitude -> four
    width-3 convolutions (padding 1) with ReLU -> mean over time -> an LSTM
    cell of 128 (gates i, f, g, o: torch's own layout) carried across
    chunks -> ReLU -> 1x1 head -> sigmoid. The recurrence runs as one
    ``nn.LSTM`` call over the whole sequence; the f32 convolutions and the
    LSTM run with TF32 off, on CUDA unless a device is given.
    """

    CHUNK = 512
    CONTEXT = 64
    HID = 128

    def __init__(self, params: Dict[str, Any], device=None):
        from ..utils import resolve_device

        super().__init__()

        def t(a):
            return torch.from_numpy(np.array(a, dtype=np.float32))

        self.register_buffer("basis", t(params["stft"]["basis"]))  # [258, 1, 256]
        for i in range(4):
            self.register_buffer(f"enc{i}_w", t(params[f"enc{i}"]["w"]))
            self.register_buffer(f"enc{i}_b", t(params[f"enc{i}"]["b"]))
        rnn = params["rnn"]
        self.lstm = nn.LSTM(self.HID, self.HID)
        with torch.no_grad():
            self.lstm.weight_ih_l0.copy_(t(rnn["w_ih"]))
            self.lstm.weight_hh_l0.copy_(t(rnn["w_hh"]))
            self.lstm.bias_ih_l0.copy_(t(rnn["b_ih"]))
            self.lstm.bias_hh_l0.copy_(t(rnn["b_hh"]))
        self.register_buffer("head_w", t(params["head"]["w"])[0, :, 0])  # [128]
        self.register_buffer("head_b", t(params["head"]["b"]))
        self.requires_grad_(False)
        self.to(resolve_device(device))

    def run_carry(self, chunks: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor):
        """chunks [N, 576] (context prepended), LSTM state h0, c0 [128] ->
        (probs [N], h, c): the state threads across calls, so a file run
        in sections equals the whole-file recurrence."""
        with no_tf32():
            spec = F.conv1d(chunks[:, None, :], self.basis, stride=128)  # [N, 258, 3]
            n_bins = self.basis.shape[0] // 2
            re, im = spec[:, :n_bins], spec[:, n_bins:]
            x = torch.sqrt(re * re + im * im + 1e-12)
            for i in range(4):
                x = F.relu(F.conv1d(x, getattr(self, f"enc{i}_w"), getattr(self, f"enc{i}_b"),
                                    padding=1))
            hs, (h, c) = self.lstm(x.mean(dim=-1)[:, None, :], (h0[None, None], c0[None, None]))
        logits = F.relu(hs[:, 0]) @ self.head_w + self.head_b
        return torch.sigmoid(logits), h[0, 0], c[0, 0]

    def speech_probs(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """Host audio -> host probabilities, one per 512-sample chunk (the
        first chunk's context is zeros)."""
        if sr != 16000:
            from ..audio_io import resample_poly

            audio = resample_poly(audio, sr, 16000)
        n = (len(audio) // self.CHUNK) * self.CHUNK
        if n == 0:
            return np.zeros(0, dtype=np.float32)
        frames = np.asarray(audio[:n], np.float32).reshape(-1, self.CHUNK)
        ctx = np.zeros((frames.shape[0], self.CONTEXT), dtype=np.float32)
        ctx[1:] = frames[:-1, -self.CONTEXT:]
        dev = self.basis.device
        chunks = torch.from_numpy(np.concatenate([ctx, frames], axis=1)).to(dev)
        h0 = torch.zeros(self.HID, device=dev)
        return self.run_carry(chunks, h0, h0)[0].cpu().numpy()


def speech_timestamps_from_probs(
    probs: np.ndarray,
    sr: int,
    threshold: float = 0.5,
    min_speech_duration_ms: int = 250,
    min_silence_duration_ms: int = 100,
    speech_pad_ms: int = 30,
    audio_length_samples: Optional[int] = None,
) -> List[Dict[str, float]]:
    """Silero-style hysteresis over window probabilities: trigger at
    ``threshold``, release below ``threshold - 0.15`` held for
    ``min_silence_duration_ms``, drop speech under
    ``min_speech_duration_ms``, pad by ``speech_pad_ms``. Returns
    ``[{"start": s, "end": s}]`` in seconds."""
    window = WINDOW_SAMPLES
    neg_threshold = max(threshold - 0.15, 0.01)
    min_speech = sr * min_speech_duration_ms / 1000
    min_silence = sr * min_silence_duration_ms / 1000
    pad = int(sr * speech_pad_ms / 1000)
    total = audio_length_samples if audio_length_samples is not None else len(probs) * window

    speeches: List[Dict[str, float]] = []
    triggered = False
    start = 0
    temp_end = 0

    for i, p in enumerate(probs):
        pos = i * window
        if p >= threshold and temp_end:
            temp_end = 0
        if p >= threshold and not triggered:
            triggered = True
            start = pos
            continue
        if p < neg_threshold and triggered:
            if not temp_end:
                temp_end = pos
            if pos - temp_end >= min_silence:
                end = temp_end + window
                if end - start >= min_speech:
                    speeches.append({"start": start, "end": end})
                triggered = False
                temp_end = 0

    if triggered:
        end = total
        if end - start >= min_speech:
            speeches.append({"start": start, "end": end})

    out = []
    for s in speeches:
        a = max(0, int(s["start"]) - pad)
        b = min(total, int(s["end"]) + pad)
        out.append({"start": a / sr, "end": b / sr})
    return out
