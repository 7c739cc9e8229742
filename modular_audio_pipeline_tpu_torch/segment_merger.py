"""Merging of adjacent same-speaker transcript segments (host).

Copied from ``modular_audio_pipeline_tpu/segment_merger.py`` for the dict
segments ``run_file`` merges: sorts by start, merges same-speaker
neighbours whose gap is at most ``max_gap_s``, extends the end with
``max``, joins text with one space. A merged segment carries ``speaker``,
``start``, ``end``, ``track`` and ``text`` only, as in the JAX package:
other keys of the input (``original_start``) are dropped.
"""

from __future__ import annotations

from typing import Any, Dict, List

__all__ = ["SegmentMerger"]

Segment = Dict[str, Any]


class SegmentMerger:
    """Consolidate adjacent turns of the same speaker."""

    def __init__(self, max_gap_s: float = 0.5):
        self.max_gap_s = max_gap_s

    def merge(self, segments: List[Segment]) -> List[Segment]:
        if not segments:
            return []
        ordered = sorted(segments, key=lambda s: float(s.get("start", 0.0)))

        merged: List[Segment] = []
        first = ordered[0]
        speaker = first.get("speaker")
        start = float(first.get("start", 0.0))
        end = float(first.get("end", 0.0))
        track = str(first.get("track", "0"))
        text = first.get("text")

        def close():
            merged.append({"speaker": speaker, "start": start, "end": end, "track": track,
                           "text": text if text is not None else ""})

        for seg in ordered[1:]:
            s_speaker = seg.get("speaker")
            s_start = float(seg.get("start", 0.0))
            s_end = float(seg.get("end", 0.0))
            if s_speaker == speaker and (s_start - end) <= self.max_gap_s:
                end = max(end, s_end)
                s_text = seg.get("text")
                if text is not None and s_text is not None:
                    text = f"{text.strip()} {s_text.strip()}" if text.strip() else s_text
                elif text is None and s_text is not None:
                    text = s_text
            else:
                close()
                speaker, start, end = s_speaker, s_start, s_end
                track = str(seg.get("track", "0"))
                text = seg.get("text")
        close()
        return merged
