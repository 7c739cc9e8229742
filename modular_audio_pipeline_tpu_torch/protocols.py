"""Data classes passed between the port's stages.

Copied from ``modular_audio_pipeline_tpu/protocols.py`` (same fields): the
diarizer's speaker turns and the table that maps the processed (kept)
timeline back to the original audio.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["DiarizationSegment", "TimestampMapping"]


@dataclass
class DiarizationSegment:
    """One speaker turn."""

    speaker: str
    start: float
    end: float
    track: str = ""


@dataclass
class TimestampMapping:
    """Interval map from the processed timeline back to the original audio,
    produced where silence removal and VAD cut audio out."""

    processed_start: float
    processed_end: float
    original_start: float
    original_end: float
