"""Near-duplicate transcription segment filtering (host).

Copied from ``modular_audio_pipeline_tpu/redundancy.py`` for ``run_file``:
texts are normalised (punctuation stripped, whitespace collapsed, lower
case) and compared with ``difflib.SequenceMatcher``; a segment is dropped
when its similarity to the last kept segment reaches the threshold, and
empty segments are dropped.
"""

from __future__ import annotations

import logging
import re
from difflib import SequenceMatcher
from typing import Dict, List

logger = logging.getLogger(__name__)

__all__ = ["RedundancyRemover", "NoOpRedundancyRemover"]


class RedundancyRemover:
    """Sequential near-duplicate filter over segment text."""

    def __init__(self, similarity_threshold: float = 0.85):
        if not 0 <= similarity_threshold <= 1:
            raise ValueError(f"similarity_threshold must be 0-1, got: {similarity_threshold}")
        self.threshold = similarity_threshold

    @classmethod
    def from_config(cls, config) -> "RedundancyRemover":
        return cls(similarity_threshold=config.redundancy.similarity_threshold)

    @staticmethod
    def _normalize_text(text: str) -> str:
        text = re.sub(r"[^\w\s]", "", text)
        return " ".join(text.split()).lower()

    def get_similarity(self, a: str, b: str) -> float:
        return SequenceMatcher(None, self._normalize_text(a), self._normalize_text(b)).ratio()

    def remove(self, segments: List[Dict]) -> List[Dict]:
        """Drop segments too similar to the last kept one, and empties."""
        if not segments:
            return []
        kept = [segments[0]]
        dropped = 0
        for seg in segments[1:]:
            text = seg.get("text", "").strip()
            if not text:
                dropped += 1
                continue
            if self.get_similarity(kept[-1].get("text", "").strip(), text) >= self.threshold:
                dropped += 1
                continue
            kept.append(seg)
        if dropped:
            logger.info("Removed %d redundant segments", dropped)
        return kept


class NoOpRedundancyRemover:
    """Pass-through used when redundancy removal is disabled."""

    def remove(self, segments: List[Dict]) -> List[Dict]:
        return segments
