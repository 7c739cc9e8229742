"""LLM post-processing: the result schemas and the OpenAI backend.

A host copy of ``modular_audio_pipeline_tpu/post_processing.py``: typed
``ActionItem``/``MeetingAnalysis`` schemas (dataclasses, no pydantic),
:func:`validate_analysis`, and the OpenAI-backed ``LLMPostProcessor``,
which imports ``openai`` only when it is built and raises ``ImportError``
without it. The pipeline wires in the hybrid processor of
:mod:`.post_processing_hybrid`.
"""

from __future__ import annotations

import json
import logging
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = ["ActionItem", "MeetingAnalysis", "LLMPostProcessor", "validate_analysis"]


@dataclass
class ActionItem:
    """A task extracted from the meeting."""

    description: str
    owner: Optional[str] = None
    due: Optional[str] = None


@dataclass
class MeetingAnalysis:
    """Structured analysis of a transcript."""

    summary: str
    topics: List[str] = field(default_factory=list)
    action_items: List[ActionItem] = field(default_factory=list)
    sentiment: str = "neutral"

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def validate_analysis(data: Dict[str, Any]) -> MeetingAnalysis:
    """Coerce an untyped dict (LLM output) into a MeetingAnalysis."""
    items = []
    for item in data.get("action_items", []) or []:
        if isinstance(item, str):
            items.append(ActionItem(description=item))
        elif isinstance(item, dict) and item.get("description"):
            items.append(
                ActionItem(
                    description=str(item["description"]),
                    owner=item.get("owner"),
                    due=item.get("due"),
                )
            )
    sentiment = str(data.get("sentiment", "neutral")).lower()
    if sentiment not in ("positive", "neutral", "negative", "mixed"):
        sentiment = "neutral"
    return MeetingAnalysis(
        summary=str(data.get("summary", "")),
        topics=[str(t) for t in (data.get("topics") or [])],
        action_items=items,
        sentiment=sentiment,
    )


_PROMPT = (
    "Analyze this meeting transcript and reply with JSON containing: "
    '"summary" (3-5 sentences), "topics" (list of main topics), '
    '"action_items" (list of {{"description", "owner", "due"}}), and '
    '"sentiment" (positive/neutral/negative/mixed).\n\nTranscript:\n{text}'
)


class LLMPostProcessor:
    """OpenAI-backed analyzer (requires OPENAI_API_KEY + openai package)."""

    def __init__(self, model: str = "gpt-4o-mini", temperature: float = 0.3):
        self.model = model
        self.temperature = temperature
        try:
            from openai import OpenAI  # type: ignore

            self._client = OpenAI()
        except Exception as exc:  # package or key missing
            raise ImportError(f"OpenAI backend unavailable: {exc}")

    def process(self, text: str) -> Dict[str, Any]:
        try:
            resp = self._client.chat.completions.create(
                model=self.model,
                temperature=self.temperature,
                response_format={"type": "json_object"},
                messages=[{"role": "user", "content": _PROMPT.format(text=text[:24000])}],
            )
            data = json.loads(resp.choices[0].message.content)
            return validate_analysis(data).to_dict()
        except Exception as exc:
            logger.warning("OpenAI analysis failed: %s", exc)
            return {"error": str(exc)}
