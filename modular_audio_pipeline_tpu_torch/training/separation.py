"""MaskUNet separation training on synthetic speech+music mixtures (PyTorch).

Counterpart of ``modular_audio_pipeline_tpu/training/separation.py``. The
mixtures are host numpy, copied: voices from :mod:`.voices` over
procedurally generated music beds (sustained chords, a bass line and
percussive noise hits), the same for the same seed. :func:`train_separator`
trains the port's :class:`~..models.separation.unet.MaskUNet` on the
magnitude STFTs with :func:`~..models.separation.unet.dual_stem_loss` and
Adam under a warm-up cosine schedule, on the card unless the caller asks
for the CPU.

Run offline::

    python -m modular_audio_pipeline_tpu_torch.training.separation \
        --out ~/.cache/map_tpu --steps 500

The checkpoint lands in ``<out>/separation-htdemucs`` (the default
``VocalSeparationConfig.model`` bundle name), where the separator finds it.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .voices import SR, sample_voice, synth_utterance

logger = logging.getLogger(__name__)

__all__ = ["synth_music", "train_separator", "si_snr", "evaluate_separation", "main"]

_CLIP_S = 6.0
_N_FFT = 2048
_HOP = 512

# equal-tempered scale frequencies for chord beds (A minor pentatonic-ish)
_NOTES = np.array([110.0, 130.8, 146.8, 164.8, 196.0, 220.0, 261.6, 293.7])


def synth_music(rng: np.random.Generator, seconds: float, sr: int = SR) -> np.ndarray:
    """Procedural accompaniment: chord pad + bass line + noise percussion."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    out = np.zeros(n)

    # sustained chord pad (3-4 notes, slow tremolo, few harmonics each)
    for note in rng.choice(_NOTES, size=int(rng.integers(3, 5)), replace=False):
        trem = 1.0 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.2, 1.5) * t + rng.uniform(0, 6))
        for k in range(1, 5):
            out += (0.25 / k) * trem * np.sin(
                2 * np.pi * k * note * t + rng.uniform(0, 6)
            )

    # bass line: note changes every beat
    tempo = rng.uniform(1.5, 2.5)  # beats/s
    beat_len = int(sr / tempo)
    n_beats = n // beat_len + 1
    bass_notes = rng.choice(_NOTES[:4] / 2.0, size=n_beats)
    bass_f = np.repeat(bass_notes, beat_len)[:n]
    out += 0.3 * np.sin(2 * np.pi * np.cumsum(bass_f) / sr)

    # percussion: short filtered-noise hits on the beat grid
    hit = rng.standard_normal(int(0.05 * sr)) * np.exp(
        -np.arange(int(0.05 * sr)) / (0.01 * sr)
    )
    for b in range(n_beats):
        pos = int(b * beat_len)
        if pos + len(hit) < n and rng.random() < 0.8:
            out[pos : pos + len(hit)] += 0.5 * hit

    peak = np.abs(out).max()
    return (out / max(peak, 1e-9) * 0.3).astype(np.float32)


def _mixture_batch(
    rng: np.random.Generator, batch: int, seconds: float = _CLIP_S
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mix, vocals, music) ``[B, N]`` at speech/music ratios around 0 dB."""
    n = int(seconds * SR)
    mixes = np.zeros((batch, n), dtype=np.float32)
    vocals = np.zeros((batch, n), dtype=np.float32)
    musics = np.zeros((batch, n), dtype=np.float32)
    for b in range(batch):
        voice = sample_voice(rng)
        v = synth_utterance(voice, seconds, rng, pause_prob=0.4)[:n]
        m = synth_music(rng, seconds)[:n]
        gain = 10.0 ** (rng.uniform(-6.0, 6.0) / 20.0)  # music SNR ±6 dB
        vocals[b, : len(v)] = v
        musics[b, : len(m)] = gain * m
        mixes[b] = vocals[b] + musics[b]
        peak = np.abs(mixes[b]).max()
        if peak > 0.95:
            mixes[b] /= peak / 0.95
            vocals[b] /= peak / 0.95
            musics[b] /= peak / 0.95
    return mixes, vocals, musics


def train_separator(
    out_dir: str,
    steps: int = 1500,
    batch: int = 8,
    lr: float = 1e-3,
    seed: int = 0,
    params=None,
    device=None,
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> Dict[str, float]:
    """Train MaskUNet with the dual-stem spectrogram L1; save ``params.npz``.

    ``params``: the initial parameters (numpy in the JAX layout, or a bundle
    dir); None draws them from ``seed``. ``on_step(i, loss)`` sees each
    step's loss tensor."""
    from ..models.separation.unet import MaskUNet, dual_stem_loss
    from ..models.vad_net import no_tf32
    from ..models.whisper.convert import initial_params, save_params
    from ..ops.stft import stft
    from ..utils import resolve_device
    from .optim import adam, warmup_cosine_decay_schedule

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    net = MaskUNet(initial_params(params, MaskUNet.init_params, seed), device=dev)
    net.requires_grad_(True)
    state = adam(warmup_cosine_decay_schedule(0.0, lr, min(100, steps // 10), steps,
                                              lr * 0.05)).init(net.parameters())

    def mags(x: np.ndarray) -> torch.Tensor:
        return stft(torch.from_numpy(x).to(dev), n_fft=_N_FFT, hop=_HOP).abs()

    t0 = time.time()
    loss = 0.0
    for i in range(steps):
        mixes, vocals, musics = _mixture_batch(rng, batch)
        loss_d = dual_stem_loss(net, mags(mixes), mags(vocals), mags(musics))
        state.zero_grad()
        with no_tf32():
            loss_d.backward()
        state.step()
        if on_step is not None:
            on_step(i, loss_d.detach())
        if i % 50 == 0 or i == steps - 1:
            loss = float(loss_d.detach())
            logger.info("separator step %d/%d L1=%.5f (%.1fs)", i, steps, loss, time.time() - t0)

    save_params(net.numpy_params(), out_dir)
    logger.info("Saved separation checkpoint to %s", out_dir)
    return {"l1": loss, "steps": steps}


# --------------------------------------------------------------------------
# Evaluation: SI-SNR on held-out mixtures, REPET vs MaskUNet
# --------------------------------------------------------------------------


def si_snr(estimate: np.ndarray, target: np.ndarray) -> float:
    """Scale-invariant SNR (dB) of ``estimate`` against ``target``."""
    t = target - target.mean()
    e = estimate - estimate.mean()
    s = (np.dot(e, t) / max(np.dot(t, t), 1e-12)) * t
    noise = e - s
    return float(10.0 * np.log10(
        max(np.dot(s, s), 1e-12) / max(np.dot(noise, noise), 1e-12)
    ))


def evaluate_separation(
    weights_dir: str, seed: int = 0, count: int = 8, device=None,
) -> Dict[str, float]:
    """Mean SI-SNR over held-out mixtures for the mixture itself (no
    separation), REPET, and the trained MaskUNet."""
    from ..models.separation.repet import repet_separate
    from ..models.separation.unet import MaskUNet
    from ..models.whisper.convert import load_params

    rng = np.random.default_rng(seed + 77_000)  # held-out generator stream
    net = MaskUNet(load_params(weights_dir), device=device)

    scores = {"mixture": 0.0, "repet": 0.0, "unet": 0.0}
    with torch.no_grad():
        for _ in range(count):
            mixes, vocals, _music = _mixture_batch(rng, 1)
            mix, voc = mixes[0], vocals[0]
            scores["mixture"] += si_snr(mix, voc)
            scores["repet"] += si_snr(repet_separate(mix, SR, device=device)[0], voc)
            scores["unet"] += si_snr(net.separate(mix, SR)[0], voc)
    return {k: round(v / count, 2) for k, v in scores.items()}


def main(argv: Optional[List[str]] = None, device=None) -> None:
    import argparse
    import os

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.environ.get(
        "MAP_TPU_WEIGHTS", os.path.join(os.path.expanduser("~"), ".cache", "map_tpu")))
    ap.add_argument("--model", default="htdemucs", help="bundle name (separation-<model>)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-only", action="store_true")
    args = ap.parse_args(argv)

    dst = str(Path(args.out) / f"separation-{args.model}")
    if not args.eval_only:
        train_separator(dst, steps=args.steps, seed=args.seed, device=device)
    print(evaluate_separation(dst, seed=args.seed, device=device))


if __name__ == "__main__":
    main()
