"""Plain Whisper in PyTorch: the reference the benchmark holds the port to.

It follows OpenAI's published model (``whisper/audio.py``,
``whisper/model.py``): log-mel of 16 kHz audio (n_fft 400, hop 160, a
periodic Hann window, centred reflect padding, the last frame dropped, the
slaney mel filterbank, log10 floored at the window's max - 8, then
(x + 4) / 4); the encoder (two GELU convolutions, sinusoidal positions,
pre-norm blocks with q and k each scaled by hd^-0.25, a final norm); the
decoder teacher-forced over a whole token sequence with a causal mask,
cross-attention over the encoder states and logits against the token
embedding; and word times as ``whisper/timing.py`` finds them, from the
decoder's cross-attention (``words.py``). The weights are the benchmark's tree (``weights.py``: ``[in,
out]`` projections, stacked layers). It imports nothing of the program.

Every product runs in ``prec``: "f32" (TF32 off: the reference), or a
control one step below the configuration's type: "fp8" rounds both
operands of every product to float8 e4m3 with a per-tensor scale. Layer
norms, softmaxes and sums of logits stay in f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, SR = 400, 160, 16000
FP8_MAX = 448.0


def mel_filters(n_mels: int, n_fft: int = N_FFT) -> torch.Tensor:
    """librosa.filters.mel(sr=16000, n_fft, n_mels) (slaney scale and
    norm), as Whisper's shipped ``mel_filters.npz`` holds it for n_fft
    400."""
    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        lin = m * (200.0 / 3)
        log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
        return np.where(m >= 15.0, log, lin)

    fft_f = np.linspace(0.0, SR / 2, n_fft // 2 + 1)
    hz = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SR / 2), n_mels + 2))
    fb = np.zeros((n_mels, len(fft_f)))
    for i in range(n_mels):
        lo, c, hi = hz[i], hz[i + 1], hz[i + 2]
        up = (fft_f - lo) / (c - lo)
        down = (hi - fft_f) / (hi - c)
        fb[i] = np.maximum(0.0, np.minimum(up, down)) * (2.0 / (hi - lo))
    return torch.from_numpy(fb.astype(np.float32))


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """``[B, N]`` float audio -> ``[B, n_mels, N // 160]`` f32."""
    x = audio.float()
    window = torch.hann_window(N_FFT, periodic=True, device=x.device)
    spec = torch.stft(x, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    power = spec[..., :-1].abs() ** 2
    mel = mel_filters(n_mels).to(x.device) @ power
    logs = torch.clamp(mel, min=1e-10).log10()
    logs = torch.maximum(logs, logs.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (logs + 4.0) / 4.0


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    x = x.float()
    if prec == "f32":
        return x
    if prec == "fp8":
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {prec}")


def _mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return torch.matmul(_round(a, prec), _round(b, prec))


def _linear(x, w, b, prec):
    y = _mm(x, w, prec)
    return y + b.float() if b is not None else y


def _ln(x, g, b):
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), eps=1e-5)


def _heads(x, h):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)


def _attend(q, k, v, h, prec, mask=None, probs=None):
    hd = q.shape[-1] // h
    s = hd ** -0.25
    qh, kh, vh = _heads(q * s, h), _heads(k * s, h), _heads(v, h)
    scores = _mm(qh, kh.transpose(-1, -2), prec)
    if mask is not None:
        scores = scores + mask
    p = torch.softmax(scores, dim=-1)
    if probs is not None:
        probs.append(p)
    out = _mm(p, vh, prec)
    b, _, t, _ = out.shape
    return out.transpose(1, 2).reshape(b, t, -1)


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _block(x, p, h, prec, xa=None, mask=None, cross_probs=None):
    y = _ln(x, p["attn_ln"]["g"], p["attn_ln"]["b"])
    a = p["attn"]
    x = x + _linear(_attend(_linear(y, a["q_w"], a["q_b"], prec), _linear(y, a["k_w"], None, prec),
                            _linear(y, a["v_w"], a["v_b"], prec), h, prec, mask),
                    a["o_w"], a["o_b"], prec)
    if xa is not None:
        y = _ln(x, p["cross_ln"]["g"], p["cross_ln"]["b"])
        c = p["cross"]
        x = x + _linear(_attend(_linear(y, c["q_w"], c["q_b"], prec),
                                _linear(xa, c["k_w"], None, prec),
                                _linear(xa, c["v_w"], c["v_b"], prec), h, prec,
                                probs=cross_probs),
                        c["o_w"], c["o_b"], prec)
    y = _ln(x, p["mlp_ln"]["g"], p["mlp_ln"]["b"])
    m = p["mlp"]
    return x + _linear(F.gelu(_linear(y, m["fc1_w"], m["fc1_b"], prec)), m["fc2_w"], m["fc2_b"],
                       prec)


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def _conv(x, w, b, stride, prec):
    return F.conv1d(_round(x, prec), _round(w, prec), b.float(), stride=stride, padding=1)


def encoder(tree, cfg, mel: torch.Tensor, prec: str = "f32", checkpoint: bool = False):
    """``mel [B, n_mels, 3000]`` -> encoder states ``[B, 1500, d]`` f32."""
    enc = tree["encoder"]
    x = F.gelu(_conv(mel, enc["conv1"]["w"], enc["conv1"]["b"], 1, prec))
    x = F.gelu(_conv(x, enc["conv2"]["w"], enc["conv2"]["b"], 2, prec)).transpose(1, 2)
    x = x + sinusoids(x.shape[1], x.shape[2]).to(x.device)
    h = cfg["encoder_attention_heads"]
    for i in range(cfg["encoder_layers"]):
        p = _layer(enc["blocks"], i)
        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(_block, x, p, h, prec, use_reentrant=False)
        else:
            x = _block(x, p, h, prec)
    return _ln(x, enc["ln_post"]["g"], enc["ln_post"]["b"])


def decoder_logits(tree, cfg, xa: torch.Tensor, tokens: torch.Tensor, prec: str = "f32",
                   cross_probs=None):
    """Teacher-forced logits ``[B, S, vocab]`` f32 of ``tokens [B, S]``.
    With a list ``cross_probs``, each layer's cross-attention
    probabilities ``[B, H, S, T]`` are appended to it."""
    dec = tree["decoder"]
    s = tokens.shape[1]
    x = dec["tok_emb"][tokens].float() + dec["pos_emb"][:s].float()
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    h = cfg["decoder_attention_heads"]
    for i in range(cfg["decoder_layers"]):
        x = _block(x, _layer(dec["blocks"], i), h, prec, xa=xa, mask=mask,
                   cross_probs=cross_probs)
    x = _ln(x, dec["ln"]["g"], dec["ln"]["b"])
    return _mm(x, dec["tok_emb"][: cfg["vocab_size"]].t(), prec)


@torch.no_grad()
def served_outputs(tree, cfg, windows: torch.Tensor, prefix, served, finished, eot: int,
                   prec: str = "f32", block: int = 4):
    """For each window row ``i`` of ``windows [W, 480000]``, teacher-forced
    after ``prefix`` over its served tokens ``served[i]``: the sum of their
    log-softmax (and of the EOT that ended a finished hypothesis), an f64
    sum of f32 terms, and the alignment of the decoder's cross-attention
    (``words.window_alignment``: the DTW's cost matrix and each token's
    entry column). Returns (sums, costs, cols)."""
    from .words import window_alignment

    sums, costs, cols = [], [], []
    top = cfg["decoder_layers"] // 2
    for lo in range(0, windows.shape[0], block):
        rows = range(lo, min(lo + block, windows.shape[0]))
        xa = encoder(tree, cfg, log_mel(windows[lo: rows[-1] + 1], cfg["num_mel_bins"]), prec)
        for r, i in enumerate(rows):
            tail = list(served[i]) + ([eot] if finished[i] else [])
            seq = torch.tensor([list(prefix) + list(served[i])], device=windows.device)
            cross = []
            logits = decoder_logits(tree, cfg, xa[r: r + 1], seq, prec, cross_probs=cross)
            lp = torch.log_softmax(logits, dim=-1)
            pos = torch.arange(len(prefix) - 1, len(prefix) - 1 + len(tail), device=lp.device)
            picked = lp[0, pos, torch.tensor(tail, device=lp.device)]
            sums.append(float(picked.double().sum()))
            heads = torch.stack([c[0] for c in cross[top:]])  # [L/2, H, S, T]
            cost, col = window_alignment(heads[:, :, len(prefix):], list(served[i]))
            costs.append(cost.astype(np.float32))
            cols.append(col)
            del cross, heads, logits, lp
    return sums, costs, cols


def set_exact_f32() -> None:
    """f32 products really in f32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, ignore: int = -100) -> torch.Tensor:
    mask = targets != ignore
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, torch.where(mask, targets, 0)[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def train_loss(tree, cfg, mel, tokens, targets, prec: str = "f32",
               checkpoint: bool = True) -> torch.Tensor:
    xa = encoder(tree, cfg, mel, prec, checkpoint=checkpoint)
    return cross_entropy(decoder_logits(tree, cfg, xa, tokens, prec), targets)
