"""Plain diarization segmentation: the per-speaker activity that the
shipped segmentation network gives each 10 s window of a timeline, 1 s
apart, as the program's ``SpeakerDiarizer`` reads it.

MFCCs of the whole timeline (25 ms periodic-Hann frames at a 10 ms hop, no
centring, zero-padded to a 512-point FFT, power, the slaney mel
filterbank of 40 bands to 8 kHz, natural log floored at 1e-10, 40
orthonormal DCT-II coefficients); windows of 1,000 frames every 100
frames; the network (an input projection, two pre-norm blocks of 4-head
self-attention with q and k each scaled by hd^-0.25 and a tanh-GELU MLP,
no biases inside the blocks, a head over the 7 powerset classes); a
softmax, summed per speaker. The weights are the shipped bundle's
``params.npz``, read here. All in f32 with TF32 off; it imports nothing of
the program.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .whisper import mel_filters

CLASSES = ((), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2))
HEADS = 4
WINDOW_FRAMES, STEP_FRAMES = 1000, 100


def load(path: Path, device) -> dict:
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]).to(device) for k in z.files}


def mfcc(audio: torch.Tensor, n: int = 40, n_mels: int = 40) -> torch.Tensor:
    """``[..., N]`` f32 -> ``[..., frames, n]``."""
    frame, hop, n_fft = 400, 160, 512
    w = 0.5 - 0.5 * torch.cos(2 * np.pi * torch.arange(frame, dtype=torch.float64) / frame)
    frames = audio.float().unfold(-1, frame, hop) * w.float().to(audio.device)
    power = torch.fft.rfft(F.pad(frames, (0, n_fft - frame)), dim=-1).abs() ** 2
    mel = power @ mel_filters(n_mels, n_fft).to(audio.device).t()
    k = torch.arange(n, dtype=torch.float64)[:, None]
    m = torch.arange(n_mels, dtype=torch.float64)[None, :]
    dct = torch.cos(np.pi * k * (2 * m + 1) / (2 * n_mels)) * np.sqrt(2.0 / n_mels)
    dct[0] /= np.sqrt(2.0)
    return torch.log(torch.clamp(mel, min=1e-10)) @ dct.float().to(audio.device).t()


def _block(x, p, i):
    d = x.shape[-1]
    b, s, _ = x.shape
    y = F.layer_norm(x, (d,), p["blocks/ln1/g"][i], p["blocks/ln1/b"][i], eps=1e-5)
    q, k, v = (y @ p["blocks/qkv"][i]).split(d, dim=-1)

    def heads(t):
        return t.reshape(b, s, HEADS, d // HEADS).transpose(1, 2)

    scale = (d // HEADS) ** -0.25
    att = torch.softmax((heads(q) * scale) @ (heads(k) * scale).transpose(-1, -2), dim=-1)
    x = x + (att @ heads(v)).transpose(1, 2).reshape(b, s, d) @ p["blocks/o"][i]
    y = F.layer_norm(x, (d,), p["blocks/ln2/g"][i], p["blocks/ln2/b"][i], eps=1e-5)
    return x + F.gelu(y @ p["blocks/fc1"][i], approximate="tanh") @ p["blocks/fc2"][i]


@torch.no_grad()
def window_activity(timeline: torch.Tensor, params: dict, block: int = 64) -> torch.Tensor:
    """``timeline [N]`` f32 -> per-speaker activity ``[windows, 1000, 3]``
    f32 of its 10 s windows at a 1 s step."""
    feats = mfcc(timeline)
    n_steps = feats.shape[0] // STEP_FRAMES
    n_win = max(1, n_steps - WINDOW_FRAMES // STEP_FRAMES + 1)
    wins = feats[: n_steps * STEP_FRAMES].unfold(0, WINDOW_FRAMES, STEP_FRAMES).transpose(1, 2)
    member = torch.tensor([[1.0 if s in c else 0.0 for s in range(3)] for c in CLASSES],
                          device=timeline.device)
    out = []
    for lo in range(0, n_win, block):
        x = wins[lo: lo + block] @ params["inp/w"] + params["inp/b"]
        for i in range(params["blocks/qkv"].shape[0]):
            x = _block(x, params, i)
        out.append(torch.softmax(x @ params["head/w"] + params["head/b"], dim=-1) @ member)
    return torch.cat(out)
