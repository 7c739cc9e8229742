"""The run result and the two post-processing steps ``run_file`` shares
with the stage-by-stage pipeline.

Copied from ``modular_audio_pipeline_tpu/pipeline.py``: ``PipelineResult``
and ``AudioPipeline``'s speaker alignment and timestamp back-mapping. The
orchestrator itself (stages chained through files) is the reference-parity
path, ROADMAP.md §A item 10.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .protocols import DiarizationSegment, TimestampMapping

__all__ = ["PipelineResult", "AudioPipeline"]


@dataclass
class PipelineResult:
    """Outcome of one pipeline run."""

    success: bool
    input_file: str
    output_file: Optional[str]
    segments: List[Dict[str, Any]]
    error: Optional[str] = None
    metadata: Dict[str, Any] = None

    def __post_init__(self):
        if self.metadata is None:
            self.metadata = {}


class AudioPipeline:
    """The pipeline's post-processing helpers (the members ported so far)."""

    @staticmethod
    def _map_timestamp_to_original(
        processed_time: float, mappings: List[TimestampMapping]
    ) -> float:
        """Linear interpolation inside the containing mapping interval;
        identity when no interval contains the time."""
        if not mappings:
            return processed_time
        for m in mappings:
            if m.processed_start <= processed_time <= m.processed_end:
                ratio = (processed_time - m.processed_start) / (
                    m.processed_end - m.processed_start + 1e-10
                )
                return m.original_start + ratio * (m.original_end - m.original_start)
        return processed_time

    @staticmethod
    def _align_transcription_with_speakers(
        transcription_segments: List[Dict],
        diarization_segments: List[DiarizationSegment],
    ) -> List[Dict]:
        """Max-overlap speaker attribution; segments without text dropped."""
        aligned = []
        for seg in transcription_segments:
            start, end = seg["start"], seg["end"]
            text = seg.get("text", "").strip()
            if not text:
                continue
            speaker = "Unknown"
            best_overlap = 0.0
            for d in diarization_segments:
                overlap = max(0.0, min(end, d.end) - max(start, d.start))
                if overlap > best_overlap:
                    best_overlap = overlap
                    speaker = d.speaker
            aligned.append({"speaker": speaker, "start": start, "end": end, "text": text})
        return aligned
