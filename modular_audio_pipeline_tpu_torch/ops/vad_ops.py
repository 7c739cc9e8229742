"""Voice-activity primitives: sub-band statistics + hangover machine.

Counterpart of ``modular_audio_pipeline_tpu/ops/vad_ops.py``:

1. :func:`band_energies` (device): per-frame energies in WebRTC's six
   analysis sub-bands (80-4000 Hz) and the frame level in dB, over
   non-overlapping 10/20/30 ms frames; :func:`flags_from_band_stats`
   (host, copied) turns them into speech flags with an adaptive noise
   floor (mean of the quietest tenth of frames per band) and the mode's
   thresholds.
2. :func:`hangover_segments` (host): the reference's ring-buffer
   trigger/detrigger machine over per-frame flags. The JAX package runs
   it as a ``lax.scan``; here it is a loop over a small int array, with
   the same events and the same segment extraction.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .framing import frame_signal

__all__ = ["band_energies", "flags_from_band_stats", "frame_speech_flags", "hangover_segments"]

# WebRTC's six analysis sub-bands (Hz).
_BAND_EDGES = (80.0, 250.0, 500.0, 1000.0, 2000.0, 3000.0, 4000.0)

# Aggressiveness -> (log2-SNR score threshold, absolute energy gate dBFS).
_MODE_THRESHOLDS = {
    0: (4.0, -65.0),
    1: (5.0, -60.0),
    2: (6.5, -55.0),
    3: (8.0, -50.0),
}


def band_energies(audio: torch.Tensor, sr: int, frame_ms: int = 30
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bands [nf, 6], frame_db [nf]) over non-overlapping frames."""
    frame_len = int(sr * frame_ms / 1000)
    frames = frame_signal(audio, frame_len, frame_len)
    spec = torch.fft.rfft(frames, dim=-1).abs() ** 2  # [nf, bins]
    freqs = np.fft.rfftfreq(frame_len, 1.0 / sr)
    bands = []
    for lo, hi in zip(_BAND_EDGES[:-1], _BAND_EDGES[1:]):
        sel = np.flatnonzero((freqs >= lo) & (freqs < hi))
        bands.append(spec[:, int(sel[0]) : int(sel[-1]) + 1].sum(dim=-1))
    frame_db = 10.0 * torch.log10(torch.mean(frames * frames, dim=-1) + 1e-12)
    return torch.stack(bands, dim=-1), frame_db


def frame_speech_flags(audio: np.ndarray, sr: int, frame_ms: int = 30, mode: int = 1,
                       device=None) -> np.ndarray:
    """Per-frame speech decisions (int32 0/1) over the valid frames of a
    host waveform: the band statistics of its bucket-padded copy on
    ``device`` (None: CUDA), the noise floor and thresholds on the host
    over the valid frames only."""
    from ..utils import resolve_device
    from .bucketing import pad_to_bucket

    audio = np.asarray(audio, dtype=np.float32)
    frame_len = sr * frame_ms // 1000
    n_valid_frames = len(audio) // frame_len
    if n_valid_frames == 0:
        return np.zeros(0, dtype=np.int32)
    padded, _ = pad_to_bucket(audio, sr)
    x = torch.from_numpy(np.ascontiguousarray(padded)).to(resolve_device(device))
    bands_d, db_d = band_energies(x, sr, frame_ms)
    bands = bands_d.cpu().numpy()[:n_valid_frames]
    frame_db = db_d.cpu().numpy()[:n_valid_frames]
    return flags_from_band_stats(bands, frame_db, mode)


def flags_from_band_stats(
    bands: np.ndarray, frame_db: np.ndarray, mode: int = 1
) -> np.ndarray:
    """Per-frame speech decisions (int32 0/1) from host band statistics."""
    k = max(1, len(bands) // 10)
    floor = np.sort(bands, axis=0)[:k].mean(axis=0) + 1e-12
    score = np.log2(1.0 + bands / floor).sum(axis=-1)
    score_th, db_th = _MODE_THRESHOLDS[mode]
    return ((score > score_th) & (frame_db > db_th)).astype(np.int32)


def _hangover_events(flags: np.ndarray, ring_size: int, start_th: float, stop_th: float):
    """The ring-buffer machine, frame by frame: per-frame (trigger,
    detrigger, segment start, oldest ring frame) and whether the machine
    is still triggered at the end. The ring holds the last ``ring_size``
    flags; it triggers when the voiced count exceeds ``start_th`` x
    ring_size, detriggers when the unvoiced count exceeds ``stop_th`` x
    ring_size, and empties at each transition."""
    n = len(flags)
    trigger = np.zeros(n, bool)
    detrig = np.zeros(n, bool)
    seg_start = np.zeros(n, np.int64)
    oldest = np.zeros(n, np.int64)
    ring: List[int] = []
    triggered, start = False, 0
    for i, f in enumerate(flags.tolist()):
        ring.append(int(f))
        if len(ring) > ring_size:
            ring.pop(0)
        voiced = sum(ring)
        unvoiced = len(ring) - voiced
        oldest[i] = i - len(ring) + 1
        if not triggered and voiced > start_th * ring_size:
            trigger[i], triggered, start = True, True, int(oldest[i])
            ring = []
        elif triggered and unvoiced > stop_th * ring_size:
            detrig[i], triggered = True, False
            ring = []
        seg_start[i] = start
    return trigger, detrig, seg_start, oldest, triggered


def hangover_segments(
    flags: np.ndarray,
    frame_ms: int,
    padding_ms: int,
    start_threshold: float,
    stop_threshold: float,
) -> List[Tuple[int, int, int]]:
    """Speech segments ``(start_frame, last_frame_inclusive,
    boundary_end_frame)`` from per-frame flags: the kept audio spans
    ``[start_frame, last_frame]``, the reported end is the oldest ring
    entry's end at detrigger (the reference's boundary). A segment still
    open at the end closes at the final frame."""
    flags = np.asarray(flags)
    n = int(flags.shape[0])
    if n == 0:
        return []
    ring_size = max(1, int(padding_ms / frame_ms))
    trigger, detrig, seg_start, oldest, still_triggered = _hangover_events(
        flags, ring_size, start_threshold, stop_threshold)
    trig_at = np.flatnonzero(trigger)
    detrig_at = np.flatnonzero(detrig)
    segments: List[Tuple[int, int, int]] = []
    for t in trig_at:
        j = np.searchsorted(detrig_at, t, side="right")
        if j < len(detrig_at):
            d = detrig_at[j]
            segments.append((int(seg_start[t]), int(d), int(oldest[d]) + 1))
        else:
            if still_triggered:
                segments.append((int(seg_start[t]), n - 1, n))
            break
    return segments
