"""ConvVAD training on synthetic voices (PyTorch, zero-egress).

Counterpart of ``modular_audio_pipeline_tpu/training/vad.py``. The clip
generators are host numpy, copied: the same seed gives the same clips and
labels. Positives are source-filter utterances (optionally under noise)
and formantless pitched vocalisations; negatives are coloured noise,
chords, percussion and silence. Labels are per 512-sample window from
the clean speech track's RMS. :func:`train_vad` trains the port's
:class:`~..models.vad_net.ConvVAD` with sigmoid cross-entropy and Adam
under a cosine decay, on the card unless the caller asks for the CPU.

Run offline::

    python -m modular_audio_pipeline_tpu_torch.training.vad \
        --out ~/.cache/map_tpu --steps 1200
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.vad_net import no_tf32
from .voices import SR, sample_voice, synth_utterance

logger = logging.getLogger(__name__)

__all__ = ["make_clip", "build_dataset", "train_vad", "evaluate_vad", "main"]

CLIP_S = 4.0
CLIP_SAMPLES = int(CLIP_S * SR)  # 64000
WINDOW = 512
N_WINDOWS = CLIP_SAMPLES // WINDOW  # 125
_RMS_FLOOR = 0.01  # window with speech-track RMS above this is "speech"


# --------------------------------------------------------------------------
# Clip synthesis
# --------------------------------------------------------------------------


def _colored_noise(rng: np.random.Generator, n: int, slope: float) -> np.ndarray:
    """Noise with spectrum ~ f^-slope (0 white, 1 pink, 2 brown)."""
    spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.fft.rfftfreq(n, 1.0 / SR)
    shaped = spec / np.maximum(freqs, 1.0) ** (slope / 2.0)
    out = np.fft.irfft(shaped, n)
    return (out / max(np.abs(out).max(), 1e-9)).astype(np.float32)


def _pitched_voice(rng: np.random.Generator, n: int) -> np.ndarray:
    """Formantless pitched vocalisation: single-f0 harmonic stack with
    temporal gating/AM at phrase-to-syllable rates (0.8-6 Hz).

    Silero (the reference's DNN VAD) is permissive on pitched vocal-ish
    content — humming, monotone speech, degraded codec speech all
    trigger it; the pipeline's music rejection lives in the separator,
    not the VAD. Training these as POSITIVES keeps that behaviour
    (music negatives below are chords or AM-free tones)."""
    t = np.arange(n) / SR
    f0 = float(rng.uniform(80.0, 350.0))
    drift = np.interp(
        np.linspace(0, 1, n), np.linspace(0, 1, 8),
        rng.normal(0.0, 0.03, 8).cumsum(),
    )
    vib = 1.0 + rng.uniform(0.0, 0.02) * np.sin(
        2 * np.pi * rng.uniform(3.5, 6.5) * t
    )
    inst = f0 * np.exp(drift) * vib
    tilt = rng.uniform(0.5, 1.8)
    sig = np.zeros(n)
    for k in range(1, 30):
        if k * f0 > SR / 2 - 200:
            break
        sig += (k ** -tilt) * np.sin(2 * np.pi * k * np.cumsum(inst) / SR)
    rate = rng.uniform(0.8, 6.0)
    phase = rng.uniform(0, 6)
    if rng.random() < 0.5:  # hard on/off gating (phrase-like)
        env = (np.sin(2 * np.pi * rate * t + phase) > rng.uniform(-0.5, 0.2)).astype(
            np.float64
        )
    else:  # sinusoidal AM (syllable-like)
        env = np.clip(
            0.5 * (1 + np.sin(2 * np.pi * rate * t + phase)) * 1.5 - 0.2, 0.0, 1.0
        )
    sig *= env
    peak = np.abs(sig).max()
    return (sig / max(peak, 1e-9) * rng.uniform(0.2, 0.4)).astype(np.float32)


def _music(rng: np.random.Generator, n: int) -> np.ndarray:
    """Non-vocal harmonic negative: a CHORD (2-4 simultaneous notes) or a
    single AM-free steady tone. Single gated/AM'd notes are pitched-voice
    positives (see :func:`_pitched_voice`)."""
    t = np.arange(n) / SR
    sig = np.zeros(n)
    n_notes = int(rng.integers(2, 5)) if rng.random() < 0.75 else 1
    steady = n_notes == 1  # single note must stay AM-free to be a negative
    for _ in range(n_notes):
        f0 = float(rng.uniform(70.0, 500.0))
        vib = 1.0 + rng.uniform(0.0, 0.01) * np.sin(
            2 * np.pi * rng.uniform(4.0, 6.5) * t
        )
        tilt = rng.uniform(0.8, 2.0)
        for k in range(1, 20):
            if k * f0 > SR / 2 - 200:
                break
            sig += (k ** -tilt) * np.sin(2 * np.pi * k * f0 * np.cumsum(vib) / SR)
    if not steady:
        # slow tremolo (below the phrase-gating band) and note on/offs
        trem = 1.0 + rng.uniform(0.0, 0.3) * np.sin(
            2 * np.pi * rng.uniform(0.2, 0.6) * t + rng.uniform(0, 6)
        )
        sig *= trem
        if rng.random() < 0.5:  # note boundary
            cut = int(rng.uniform(0.3, 0.7) * n)
            ramp = np.ones(n)
            ramp[cut : cut + 800] = np.linspace(1, 0.2, 800)
            ramp[cut + 800 :] = 0.2
            sig *= ramp
    return (sig / max(np.abs(sig).max(), 1e-9)).astype(np.float32)


def _percussion(rng: np.random.Generator, n: int) -> np.ndarray:
    """Decaying noise-burst train (drums/clicks)."""
    sig = np.zeros(n, dtype=np.float32)
    step = int(SR / rng.uniform(1.5, 6.0))
    for i in range(0, n - 2000, step):
        burst = rng.standard_normal(1600).astype(np.float32)
        burst *= np.exp(-np.arange(1600) / rng.uniform(100.0, 500.0)).astype(
            np.float32
        )
        sig[i : i + 1600] += burst
    return sig / max(np.abs(sig).max(), 1e-9)


def make_clip(
    rng: np.random.Generator, voices: Optional[List] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """One training clip -> (audio [CLIP_SAMPLES], window labels [N_WINDOWS])."""
    kind = rng.random()
    speech = np.zeros(CLIP_SAMPLES, dtype=np.float32)
    if kind < 0.45:  # formant speech (possibly several utterances)
        voice = (
            voices[int(rng.integers(0, len(voices)))] if voices else sample_voice(rng)
        )
        n_utt = int(rng.integers(1, 3))
        for _ in range(n_utt):
            dur = float(rng.uniform(0.6, 2.5))
            start = int(rng.uniform(0.0, max(0.05, CLIP_S - dur)) * SR)
            utt = synth_utterance(voice, dur, rng)
            end = min(start + len(utt), CLIP_SAMPLES)
            speech[start:end] += utt[: end - start]
    elif kind < 0.6:  # pitched vocalisation (formantless positive)
        dur = float(rng.uniform(1.5, CLIP_S))
        start = int(rng.uniform(0.0, CLIP_S - dur) * SR)
        utt = _pitched_voice(rng, int(dur * SR))
        speech[start : start + len(utt)] += utt
    audio = speech.copy()

    r = rng.random()
    if r < 0.35:  # add/stand-alone noise bed
        noise = _colored_noise(rng, CLIP_SAMPLES, float(rng.uniform(0.0, 2.0)))
        audio = audio + noise * rng.uniform(0.002, 0.12)
    elif r < 0.55:
        audio = audio + _music(rng, CLIP_SAMPLES) * rng.uniform(0.05, 0.3)
    elif r < 0.7:
        audio = audio + _percussion(rng, CLIP_SAMPLES) * rng.uniform(0.05, 0.4)
    # else: clean / near-silence

    peak = np.abs(audio).max()
    if peak > 0.95:
        audio = audio / peak * 0.95

    win_rms = np.sqrt((speech.reshape(N_WINDOWS, WINDOW) ** 2).mean(axis=-1))
    labels = (win_rms > _RMS_FLOOR).astype(np.float32)
    return audio.astype(np.float32), labels


def build_dataset(
    n_clips: int, seed: int, n_speakers: int = 64
) -> Tuple[np.ndarray, np.ndarray]:
    """[n, CLIP_SAMPLES] audio + [n, N_WINDOWS] labels from a seeded
    speaker pool (train/held-out pools never overlap across seeds)."""
    rng = np.random.default_rng(seed)
    voices = [sample_voice(rng) for _ in range(n_speakers)]
    xs, ys = [], []
    for _ in range(n_clips):
        a, l = make_clip(rng, voices)
        xs.append(a)
        ys.append(l)
    return np.stack(xs), np.stack(ys)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------


def train_vad(
    out_dir: str,
    steps: int = 1200,
    batch_size: int = 32,
    n_train_clips: int = 640,
    seed: int = 0,
    lr: float = 3e-4,
    params=None,
    device=None,
    eval_clips: int = 160,
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> Dict[str, float]:
    """Train ConvVAD; saves ``<out_dir>/vad-silero/{params.npz,calibration.json}``.

    ``params``: the initial parameters (numpy in the JAX layout, or a bundle
    dir); None draws them from ``seed``. ``eval_clips`` held-out clips make
    the calibration. ``on_step(i, loss)`` sees each step's loss tensor."""
    from ..models.vad_net import ConvVAD
    from ..models.whisper.convert import initial_params, save_params
    from ..utils import resolve_device
    from .optim import adam, cosine_decay_schedule, sigmoid_binary_cross_entropy

    dev = resolve_device(device)
    t0 = time.time()
    logger.info("Synthesising %d training clips...", n_train_clips)
    xs, ys = build_dataset(n_train_clips, seed=seed)
    logger.info("Dataset ready (%.1fs)", time.time() - t0)

    net = ConvVAD(initial_params(params, ConvVAD.init_params, seed), device=dev)
    net.requires_grad_(True)
    state = adam(cosine_decay_schedule(lr, steps)).init(net.parameters())

    rng = np.random.default_rng(seed + 1)
    loss = acc = 0.0
    for i in range(steps):
        idx = rng.integers(0, len(xs), batch_size)
        audio = torch.from_numpy(xs[idx]).to(dev)
        labels = torch.from_numpy(ys[idx]).to(dev)
        logits = net.logits(ConvVAD.features(audio))  # [B, N_WINDOWS]
        loss_d = sigmoid_binary_cross_entropy(logits, labels).mean()
        state.zero_grad()
        with no_tf32():
            loss_d.backward()
        state.step()
        if on_step is not None:
            on_step(i, loss_d.detach())
        if i % 100 == 0 or i == steps - 1:
            acc_d = ((logits > 0) == (labels > 0.5)).float().mean()
            loss, acc = float(loss_d.detach()), float(acc_d)
            logger.info("vad step %d/%d loss=%.4f acc=%.3f (%.1fs)",
                        i, steps, loss, acc, time.time() - t0)

    host = net.numpy_params()
    bundle = Path(out_dir) / "vad-silero"
    bundle.mkdir(parents=True, exist_ok=True)
    save_params(host, str(bundle))

    metrics = evaluate_vad(host, n_clips=eval_clips, seed=seed + 1000, device=dev)
    (bundle / "calibration.json").write_text(json.dumps(metrics, indent=2))
    logger.info("Saved ConvVAD bundle to %s: %s", bundle, metrics)
    return metrics


def evaluate_vad(
    params, n_clips: int = 160, seed: int = 1000, device=None,
) -> Dict[str, float]:
    """Held-out window accuracy/F1 on UNSEEN speakers + threshold sweep."""
    from ..models.vad_net import ConvVAD

    net = ConvVAD(params, device=device)
    xs, ys = build_dataset(n_clips, seed=seed)
    with torch.no_grad():
        probs = np.stack([net.speech_probs(x, SR) for x in xs])  # [n, N_WINDOWS]
    labels = ys > 0.5

    best = {"threshold": 0.5, "f1": -1.0}
    for th in np.linspace(0.2, 0.8, 25):
        pred = probs >= th
        tp = float((pred & labels).sum())
        fp = float((pred & ~labels).sum())
        fn = float((~pred & labels).sum())
        f1 = 2 * tp / max(2 * tp + fp + fn, 1.0)
        if f1 > best["f1"]:
            best = {"threshold": round(float(th), 3), "f1": round(f1, 4)}

    pred = probs >= best["threshold"]
    return {
        "threshold": best["threshold"],
        "window_accuracy": round(float((pred == labels).mean()), 4),
        "f1": best["f1"],
        "speech_recall": round(
            float((pred & labels).sum() / max(labels.sum(), 1)), 4
        ),
        "nonspeech_specificity": round(
            float((~pred & ~labels).sum() / max((~labels).sum(), 1)), 4
        ),
        "held_out_clips": n_clips,
    }


def main(argv: Optional[List[str]] = None, device=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=str(Path.home() / ".cache" / "map_tpu"))
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--clips", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    train_vad(args.out, steps=args.steps, n_train_clips=args.clips, seed=args.seed,
              device=device)


if __name__ == "__main__":
    main()
