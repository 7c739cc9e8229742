"""Parametric synthetic voices (host numpy): the benchmark's own copy.

Copied from ``modular_audio_pipeline_tpu_torch/training/voices.py`` (itself
a copy of the JAX package's voice model), so that a later change to the
program cannot change the benchmark's inputs: a source-filter voice model
with per-speaker fundamental frequency, formant layout, spectral tilt and
breathiness, and utterance-level prosody (f0 random walk, syllabic
amplitude modulation, pauses), drawn from a seeded distribution. It is the
speech the shipped ConvVAD and diarization bundles were trained on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

__all__ = ["SpeakerVoice", "sample_voice", "synth_utterance", "synth_conversation"]

SR = 16000


@dataclass(frozen=True)
class SpeakerVoice:
    """Per-speaker identity parameters (the 'vocal tract')."""

    f0: float  # base fundamental, Hz
    formants: Tuple[float, ...]  # F1..F4 centre frequencies, Hz
    bandwidths: Tuple[float, ...]  # formant bandwidths, Hz
    tilt: float  # spectral tilt exponent (harmonic k ** -tilt)
    breathiness: float  # aspiration noise level, 0..~0.3
    vibrato_hz: float
    vibrato_depth: float  # relative f0 depth


def sample_voice(rng: np.random.Generator) -> SpeakerVoice:
    """Draw a speaker from the population distribution."""
    # Two broad f0 clusters (low/high register) plus a continuum between.
    f0 = float(np.exp(rng.uniform(np.log(85.0), np.log(290.0))))
    # Formant layouts roughly track vocal-tract length (inverse of f0
    # register, loosely) with independent per-speaker scatter.
    tract = rng.uniform(0.85, 1.2)
    base = np.array([500.0, 1500.0, 2500.0, 3500.0]) / tract
    formants = base * rng.uniform(0.88, 1.12, size=4)
    bandwidths = np.array([80.0, 120.0, 180.0, 250.0]) * rng.uniform(0.8, 1.3, 4)
    return SpeakerVoice(
        f0=f0,
        formants=tuple(float(f) for f in formants),
        bandwidths=tuple(float(b) for b in bandwidths),
        tilt=float(rng.uniform(0.4, 1.6)),
        breathiness=float(rng.uniform(0.02, 0.22)),
        vibrato_hz=float(rng.uniform(3.0, 7.0)),
        vibrato_depth=float(rng.uniform(0.005, 0.03)),
    )


def _formant_gain(freqs: np.ndarray, voice: SpeakerVoice) -> np.ndarray:
    """Vocal-tract magnitude response at ``freqs`` (sum of resonances)."""
    gain = np.zeros_like(freqs)
    for fc, bw in zip(voice.formants, voice.bandwidths):
        gain += 1.0 / (1.0 + ((freqs - fc) / (bw / 2.0)) ** 2)
    return gain + 0.02  # spectral floor


def synth_utterance(
    voice: SpeakerVoice,
    seconds: float,
    rng: np.random.Generator,
    sr: int = SR,
    pause_prob: float = 0.25,
) -> np.ndarray:
    """One utterance: harmonic source * formant filter + aspiration noise,
    with syllabic envelope, f0 prosody and occasional pauses."""
    n = int(seconds * sr)
    t = np.arange(n) / sr

    # f0 contour: slow random walk (prosody) + vibrato + jitter
    n_ctrl = max(4, int(seconds * 3))
    walk = np.cumsum(rng.normal(0.0, 0.04, n_ctrl))
    walk -= walk.mean()
    contour = np.interp(np.linspace(0, 1, n), np.linspace(0, 1, n_ctrl), walk)
    f0_t = voice.f0 * np.exp(contour)
    f0_t *= 1.0 + voice.vibrato_depth * np.sin(2 * np.pi * voice.vibrato_hz * t)
    f0_t *= 1.0 + rng.normal(0.0, 0.003, n)  # jitter
    phase = 2 * np.pi * np.cumsum(f0_t) / sr

    # Harmonic stack through the formant filter (evaluated per harmonic).
    max_harm = max(3, int((sr / 2 - 200) / voice.f0))
    max_harm = min(max_harm, 40)
    sig = np.zeros(n)
    # Per-utterance formant perturbation ("phoneme" movement): slow wander
    # of the filter evaluation point.
    n_seg = max(2, int(seconds * 2.5))
    wander = np.interp(
        np.linspace(0, 1, n),
        np.linspace(0, 1, n_seg),
        rng.uniform(0.9, 1.1, n_seg),
    )
    for k in range(1, max_harm + 1):
        fk = k * f0_t * wander
        amp = _formant_gain(fk, voice) * (k ** -voice.tilt)
        amp = np.where(fk < sr / 2 - 100, amp, 0.0)
        sig += amp * np.sin(k * phase)

    # Aspiration: white noise shaped by the same formant envelope (cheap
    # approximation — bandpass around F2).
    noise = rng.standard_normal(n)
    f2 = voice.formants[1]
    # one-pole-ish bandpass via FFT masking (utterances are short)
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    spec *= _formant_gain(freqs, voice)
    _ = f2
    noise = np.fft.irfft(spec, n)
    noise /= max(np.abs(noise).max(), 1e-9)
    sig = sig + voice.breathiness * noise * 3.0

    # Syllabic envelope (~4 Hz) with sharper onsets, plus optional pause.
    syll = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t + rng.uniform(0, 6)))
    env = np.clip(syll * 1.6 - 0.25, 0.0, 1.0) ** 0.7
    if seconds > 1.0 and rng.random() < pause_prob:
        p0 = rng.uniform(0.2, 0.7)
        p1 = min(p0 + rng.uniform(0.08, 0.25), 0.95)
        env[int(p0 * n) : int(p1 * n)] *= 0.02
    sig *= env

    peak = np.abs(sig).max()
    if peak > 1e-9:
        sig = sig / peak * rng.uniform(0.2, 0.35)
    return sig.astype(np.float32)


def synth_conversation(
    voices: List[SpeakerVoice],
    turns: List[Tuple[int, float]],
    rng: np.random.Generator,
    sr: int = SR,
    overlap_prob: float = 0.0,
    max_overlap_s: float = 1.0,
    noise_level: float = 0.0,
    gap_s: float = 0.0,
) -> Tuple[np.ndarray, List[Tuple[str, float, float]]]:
    """Multi-speaker conversation.

    ``turns``: [(speaker_index, seconds)]. With ``overlap_prob``, a turn
    may start before the previous one ends (up to ``max_overlap_s``).
    Returns (audio, truth) with truth entries ``("S<idx>", start, end)``
    on the output timeline.
    """
    total = sum(sec for _, sec in turns) + gap_s * len(turns) + max_overlap_s
    n_total = int(total * sr) + sr
    audio = np.zeros(n_total, dtype=np.float32)
    truth: List[Tuple[str, float, float]] = []

    cursor = 0.0
    prev_end = 0.0
    for spk, sec in turns:
        start = cursor
        if truth and overlap_prob > 0 and rng.random() < overlap_prob:
            start = max(0.0, prev_end - rng.uniform(0.2, max_overlap_s))
        utt = synth_utterance(voices[spk], sec, rng, sr=sr)
        a = int(start * sr)
        audio[a : a + len(utt)] += utt
        end = start + sec
        truth.append((f"S{spk}", round(start, 3), round(end, 3)))
        prev_end = end
        cursor = end + (gap_s if gap_s > 0 else 0.0)

    n_used = int((max(e for _, _, e in truth) + 0.2) * sr)
    audio = audio[:n_used]
    if noise_level > 0:
        audio = audio + noise_level * rng.standard_normal(n_used).astype(np.float32)
    peak = np.abs(audio).max()
    if peak > 0.95:
        audio = audio / peak * 0.95
    return audio.astype(np.float32), truth
