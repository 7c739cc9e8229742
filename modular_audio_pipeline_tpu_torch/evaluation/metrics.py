"""WER and DER, and the comparison of two transcription JSONs.

A host copy of ``modular_audio_pipeline_tpu/evaluation/metrics.py`` (numpy
and SciPy; nothing here runs on the device):

- :func:`wer`: word error rate by Levenshtein alignment (substitutions +
  insertions + deletions over the reference's words).
- :func:`der`: diarization error rate on labelled turns: missed speech +
  false-alarm speech + speaker confusion over the reference's speech
  time, with the optimal speaker mapping (Hungarian).
- :func:`compare_transcriptions`: WER and DER between two pipeline output
  JSONs (the schema ``AudioPipeline.run`` writes).

Run ``python -m modular_audio_pipeline_tpu_torch.evaluation.metrics REF HYP``
to print them for two JSON files.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["wer", "der", "compare_transcriptions"]


def _normalize_words(text: str) -> List[str]:
    text = re.sub(r"[^\w\s']", " ", text.lower())
    return text.split()


def wer(reference: str, hypothesis: str) -> Dict[str, float]:
    """Word error rate with S/I/D breakdown."""
    ref = _normalize_words(reference)
    hyp = _normalize_words(hypothesis)
    if not ref:
        return {
            "wer": 0.0 if not hyp else float("inf"),
            "substitutions": 0, "insertions": len(hyp), "deletions": 0,
            "ref_words": 0,
        }

    # Levenshtein with backtrace over (S, I, D)
    n, m = len(ref), len(hyp)
    dist = np.zeros((n + 1, m + 1), dtype=np.int32)
    dist[:, 0] = np.arange(n + 1)
    dist[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        sub_cost = (np.array(hyp) != ref[i - 1]).astype(np.int32)
        for j in range(1, m + 1):
            dist[i, j] = min(
                dist[i - 1, j - 1] + sub_cost[j - 1],  # sub / match
                dist[i - 1, j] + 1,  # deletion
                dist[i, j - 1] + 1,  # insertion
            )

    # backtrace for the breakdown
    i, j = n, m
    subs = ins = dels = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            subs += ref[i - 1] != hyp[j - 1]
            i, j = i - 1, j - 1
        elif i > 0 and dist[i, j] == dist[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1

    return {
        "wer": float(dist[n, m]) / n,
        "substitutions": int(subs),
        "insertions": int(ins),
        "deletions": int(dels),
        "ref_words": n,
    }


Turn = Tuple[str, float, float]  # (speaker, start, end)


def _speech_mask(turns: Sequence[Turn], resolution: float, total: float) -> np.ndarray:
    """Frame-level speaker-id matrix [n_frames]; -1 = no speech."""
    n = int(np.ceil(total / resolution)) + 1
    frame = np.full(n, -1, dtype=np.int64)
    speakers = {}
    for spk, s, e in turns:
        sid = speakers.setdefault(spk, len(speakers))
        a, b = int(round(s / resolution)), int(round(e / resolution))
        frame[a:b] = sid
    return frame


def der(
    reference: Sequence[Turn],
    hypothesis: Sequence[Turn],
    resolution: float = 0.01,
) -> Dict[str, float]:
    """Diarization error rate over single-speaker turn lists.

    DER = (missed + false alarm + confusion) / total reference speech,
    with the hypothesis->reference speaker mapping chosen optimally.
    """
    if not reference:
        return {"der": 0.0 if not hypothesis else float("inf"),
                "missed": 0.0, "false_alarm": 0.0, "confusion": 0.0}

    total = max(max(e for _, _, e in reference),
                max((e for _, _, e in hypothesis), default=0.0))
    ref = _speech_mask(reference, resolution, total)
    hyp = _speech_mask(hypothesis, resolution, total)

    ref_speech = ref >= 0
    hyp_speech = hyp >= 0
    missed = np.sum(ref_speech & ~hyp_speech)
    false_alarm = np.sum(~ref_speech & hyp_speech)

    # optimal label mapping over co-occurrence counts
    both = ref_speech & hyp_speech
    n_ref = int(ref.max()) + 1
    n_hyp = int(hyp.max()) + 1 if hyp_speech.any() else 0
    confusion = int(np.sum(both))
    if n_hyp > 0:
        counts = np.zeros((n_ref, n_hyp), dtype=np.int64)
        np.add.at(counts, (ref[both], hyp[both]), 1)
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(-counts)
        confusion = int(np.sum(both)) - int(counts[rows, cols].sum())

    ref_total = int(np.sum(ref_speech))
    scale = resolution
    return {
        "der": float(missed + false_alarm + confusion) / ref_total,
        "missed": float(missed) * scale,
        "false_alarm": float(false_alarm) * scale,
        "confusion": float(confusion) * scale,
        "ref_speech_s": float(ref_total) * scale,
    }


def _segments_to_turns(segments: List[dict]) -> List[Turn]:
    return [
        (s.get("speaker", "SPEAKER_00"), float(s["start"]), float(s["end"]))
        for s in segments
    ]


def compare_transcriptions(reference_json: str, hypothesis_json: str) -> Dict:
    """WER + DER between two pipeline output JSON files."""
    with open(reference_json, encoding="utf-8") as f:
        ref = json.load(f)
    with open(hypothesis_json, encoding="utf-8") as f:
        hyp = json.load(f)

    ref_text = " ".join(s.get("text", "") for s in ref.get("segments", []))
    hyp_text = " ".join(s.get("text", "") for s in hyp.get("segments", []))

    return {
        "wer": wer(ref_text, hyp_text),
        "der": der(
            _segments_to_turns(ref.get("segments", [])),
            _segments_to_turns(hyp.get("segments", [])),
        ),
    }


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="WER/DER between two pipeline outputs")
    ap.add_argument("reference")
    ap.add_argument("hypothesis")
    args = ap.parse_args()
    print(json.dumps(compare_transcriptions(args.reference, args.hypothesis), indent=2))


if __name__ == "__main__":
    main()
