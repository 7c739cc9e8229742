"""The recording's own truth, against which the speech the program keeps
and the speaker turns it finds are judged.

The benchmark writes every utterance itself (``synth.layout``): where
each starts, how long it lasts and which of the recording's voices says
it. So the plain reference of the VAD's keep decision is that layout (the
speech is exactly the utterances, the rest is silence), and of the
diarization the layout's voices. Both are judged on a 1 ms grid. It
imports nothing of the program.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np


def truth_ms(utts: Sequence[Tuple[float, float, int]], total_s: float) -> np.ndarray:
    """Speaker slot of every ms of the recording, -1 where nobody speaks."""
    out = np.full(int(round(total_s * 1000)), -1, dtype=np.int64)
    for start, dur, slot in utts:
        a = int(round(start * 1000))
        out[a: a + int(round(dur * 1000))] = slot
    return out


def kept_ms(keep: Sequence[Tuple[int, int]], n: int) -> np.ndarray:
    """Indices of the kept ms, in the order of the kept timeline."""
    parts = [np.arange(max(0, a), min(n, b)) for a, b in keep]
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)


def keep_vs_speech(keep: Sequence[Tuple[int, int]], truth: np.ndarray) -> Dict[str, float]:
    """The share of the speech that the keep intervals (ms of the
    recording) leave out, and the seconds of silence they keep."""
    mask = np.zeros(len(truth), dtype=bool)
    mask[kept_ms(keep, len(truth))] = True
    speech = truth >= 0
    return {"speech_missed": float((speech & ~mask).sum()) / max(1, int(speech.sum())),
            "silence_kept_s": float((~speech & mask).sum()) / 1000.0}


def paint(turns: List[Dict], n: int) -> np.ndarray:
    """Label index (by sorted speaker name) of each of ``n`` ms of a
    timeline that ``turns`` (seconds) cover, -1 elsewhere; a later turn
    wins where two overlap."""
    names = sorted({t["speaker"] for t in turns})
    out = np.full(n, -1, dtype=np.int64)
    for t in turns:
        out[int(round(t["start"] * 1000)): int(round(t["end"] * 1000))] = names.index(t["speaker"])
    return out


def mismatch(want: np.ndarray, got: np.ndarray, where: np.ndarray) -> float:
    """Share of the ms ``where`` whose ``got`` label differs from ``want``'s
    (-1: none), under the one-to-one mapping of labels that agrees most."""
    total = int(where.sum())
    if total == 0:
        return 0.0
    k = max(int(want.max()), int(got.max()), 0) + 1
    both = where & (want >= 0) & (got >= 0)
    conf = np.zeros((k, k), dtype=np.int64)
    np.add.at(conf, (want[both], got[both]), 1)
    best = max(int(conf[np.arange(k), perm].sum()) for perm in itertools.permutations(range(k)))
    return 1.0 - best / total


def speaker_error(turns: List[Dict], keep: Sequence[Tuple[int, int]], truth: np.ndarray
                  ) -> Dict[str, float]:
    """Share of the kept speech whose speaker the turns (seconds of the
    kept timeline, as ``process`` returns them) get wrong or leave
    unlabelled, under the one-to-one mapping of turn labels to voices that
    gets the most right."""
    want = truth[kept_ms(keep, len(truth))]
    return {"speaker_error": mismatch(want, paint(turns, len(want)), want >= 0),
            "speakers_found": len({t["speaker"] for t in turns})}


def turns_gap(got: List[Dict], want: List[Dict], n_ms: int) -> float:
    """Share of the ``n_ms`` of a timeline that either side's turns cover
    where the two disagree, under the mapping of labels that agrees most."""
    a, b = paint(want, n_ms), paint(got, n_ms)
    return mismatch(a, b, (a >= 0) | (b >= 0))
