"""Hybrid LLM post-processing: OpenAI -> local LM -> heuristic.

Counterpart of ``modular_audio_pipeline_tpu/post_processing_hybrid.py``,
with the same backend ladder:

1. **openai**: when a key exists and ``force_local`` is False;
2. **local**: a converted checkpoint (``local_model``, a directory with
   ``params.npz`` and ``tokenizer.json``, optionally ``"dir::name"`` with a
   name of ``models.lm.LM_MODELS``: the llama family, or
   ``deepseek-v2-lite``), run on the card by the model's LM class;
   the ``tokenizers`` package is imported only here;
3. **heuristic**: the always-available extractive analyzer
   (frequency-scored summary, content-word topics, modal-verb action
   items, lexicon sentiment), host code with no weights.

``LLMPostProcessor`` is an alias of the hybrid processor, as in the JAX
package. ``lm_device`` places the local LM (None: CUDA, raising without
it); ``device`` (the config's ``llm.device``) is kept and not read, as in
the JAX package.
"""

from __future__ import annotations

import logging
import os
import re
from collections import Counter
from typing import Any, Dict, List, Optional

import numpy as np

from .post_processing import validate_analysis

logger = logging.getLogger(__name__)

__all__ = ["HybridLLMPostProcessor", "HeuristicAnalyzer", "LLMPostProcessor"]

_STOPWORDS = frozenset(
    """a an the and or but if then else for while of in on at to from by with
    about as into through during is are was were be been being have has had
    do does did will would should could can may might must shall not no nor
    so than too very just that this these those it its he she they them his
    her their we us our you your i me my mine am what which who whom when
    where why how all any both each few more most other some such only own
    same s t don now o que de da do em um uma para com por os as e ou mas se
    na no nos nas dos das ao aos à às é são foi eram ser estar tem têm""".split()
)

_POSITIVE = frozenset(
    """good great excellent positive agreed agree success successful happy
    glad perfect well done resolved improvement improved progress win
    ótimo bom excelente sucesso feliz resolvido melhorou""".split()
)
_NEGATIVE = frozenset(
    """bad poor negative problem issue fail failed failure blocked concern
    worried difficult delay delayed risk broken bug error wrong
    ruim problema falha bloqueado atraso risco erro""".split()
)

_ACTION_PATTERNS = re.compile(
    r"\b(will|should|must|need to|needs to|have to|has to|going to|let's|"
    r"action item|todo|follow up|take care of|vamos|precisa|deve|tem que)\b",
    re.IGNORECASE,
)


def _sentences(text: str) -> List[str]:
    parts = re.split(r"(?<=[.!?])\s+|\n+", text)
    return [p.strip() for p in parts if len(p.strip()) > 2]


def _content_words(text: str) -> List[str]:
    words = re.findall(r"[\w'-]+", text.lower())
    return [w for w in words if w not in _STOPWORDS and len(w) > 2 and not w.isdigit()]


class HeuristicAnalyzer:
    """Deterministic extractive analysis — the weight-free backend."""

    def __init__(self, max_summary_sentences: int = 4, max_topics: int = 6):
        self.max_summary_sentences = max_summary_sentences
        self.max_topics = max_topics

    def process(self, text: str) -> Dict[str, Any]:
        sentences = _sentences(text)
        if not sentences:
            return validate_analysis({"summary": "", "topics": []}).to_dict()

        freqs = Counter(_content_words(text))

        def score(sentence: str) -> float:
            words = _content_words(sentence)
            if not words:
                return 0.0
            return sum(freqs[w] for w in words) / (len(words) ** 0.5)

        ranked = sorted(range(len(sentences)), key=lambda i: -score(sentences[i]))
        chosen = sorted(ranked[: self.max_summary_sentences])  # restore order
        summary = " ".join(sentences[i] for i in chosen)

        topics = [w for w, _ in freqs.most_common(self.max_topics)]

        action_items = []
        for s in sentences:
            if _ACTION_PATTERNS.search(s) and len(action_items) < 8:
                action_items.append({"description": s[:200]})

        words = set(_content_words(text))
        pos = len(words & _POSITIVE)
        neg = len(words & _NEGATIVE)
        if pos > neg * 1.5 and pos > 0:
            sentiment = "positive"
        elif neg > pos * 1.5 and neg > 0:
            sentiment = "negative"
        elif pos and neg:
            sentiment = "mixed"
        else:
            sentiment = "neutral"

        return validate_analysis(
            {
                "summary": summary,
                "topics": topics,
                "action_items": action_items,
                "sentiment": sentiment,
            }
        ).to_dict()


_ANALYSIS_PROMPT = (
    "You are a meeting analyst. Analyze the transcript and respond ONLY "
    "with JSON: {\"summary\": \"...\", \"topics\": [...], "
    "\"action_items\": [{\"description\": \"...\"}], "
    "\"sentiment\": \"positive|neutral|negative|mixed\"}.\n\n"
    "Transcript:\n{text}\n\nJSON:"
)


def extract_json_block(raw: str) -> Optional[Dict[str, Any]]:
    """JSON extraction ladder: fenced block -> first balanced object ->
    regex field scraping (reference post_processing_hybrid.py:196-241)."""
    import json

    fenced = re.search(r"```(?:json)?\s*(\{.*?\})\s*```", raw, re.DOTALL)
    if fenced:
        try:
            return json.loads(fenced.group(1))
        except json.JSONDecodeError:
            pass

    start = raw.find("{")
    if start >= 0:
        depth = 0
        for i, ch in enumerate(raw[start:], start):
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    try:
                        return json.loads(raw[start : i + 1])
                    except json.JSONDecodeError:
                        break

    summary = re.search(r'"summary"\s*:\s*"([^"]*)"', raw)
    if summary:
        topics = re.findall(r'"([^"]{2,40})"', raw[summary.end():])
        return {"summary": summary.group(1), "topics": topics[:6]}
    return None


class LocalLMAnalyzer:
    """Meeting analysis on a converted local checkpoint, on the card. The
    model's name picks its configuration, LM class, end-of-text id and
    loader from ``models.lm.LM_MODELS``: the llama family, or DeepSeek-V2."""

    def __init__(self, weights_dir: str, model_name: str = "tinyllama-1.1b",
                 temperature: float = 0.3, max_length: int = 2048, device=None):
        from pathlib import Path

        import torch

        from .models.lm import LM_MODELS
        from .utils import resolve_device

        self.temperature = temperature
        self.max_length = max_length
        model = LM_MODELS[model_name]
        self.eos_id = getattr(model.config, "eos_id", 2)  # llama's </s> where unstated
        dev = resolve_device(device)
        self.lm = model.lm(model.config, params=model.load(weights_dir, dev, torch.bfloat16),
                           device=dev)

        tok_file = Path(weights_dir) / "tokenizer.json"
        if not tok_file.exists():
            raise ImportError(f"tokenizer.json missing in {weights_dir}")
        from tokenizers import Tokenizer

        self.tokenizer = Tokenizer.from_file(str(tok_file))

    def process(self, text: str) -> Dict[str, Any]:
        prompt = _ANALYSIS_PROMPT.replace("{text}", text[: self.max_length * 3])
        # keep the prompt within the context, with room to generate (the
        # small test configs have max_seq << 512)
        reserve = min(512, max(8, self.lm.cfg.max_seq // 4))
        ids = self.tokenizer.encode(prompt).ids[-(self.lm.cfg.max_seq - reserve):]
        if not ids:
            ids = [0]
        out_ids = self.lm.generate(
            np.asarray(ids, dtype=np.int32),
            max_new_tokens=min(512, self.lm.cfg.max_seq - len(ids) - 1),
            temperature=self.temperature,
            eos_id=self.eos_id,
        )
        raw = self.tokenizer.decode([int(t) for t in out_ids])
        data = extract_json_block(raw)
        if data is None:
            return {"error": f"no JSON in model output: {raw[:120]}..."}
        return validate_analysis(data).to_dict()


class HybridLLMPostProcessor:
    """Backend-selecting analyzer with the reference's constructor shape."""

    def __init__(
        self,
        device: str = "auto",
        max_length: int = 2048,
        temperature: float = 0.3,
        force_local: bool = False,
        openai_model: str = "gpt-4o-mini",
        local_model: Optional[str] = None,
        lm_device=None,
    ):
        self.device = device
        self.max_length = max_length
        self.temperature = temperature
        self.local_model = local_model

        self._backend = "heuristic"
        self._model_desc = "extractive-heuristic"
        self._processor: Any = HeuristicAnalyzer()

        if not force_local and os.getenv("OPENAI_API_KEY"):
            try:
                from .post_processing import LLMPostProcessor as _OpenAIProcessor

                self._processor = _OpenAIProcessor(
                    model=openai_model, temperature=temperature
                )
                self._backend = "openai"
                self._model_desc = openai_model
            except ImportError as exc:
                logger.warning("OpenAI backend unavailable (%s); trying local", exc)

        if self._backend == "heuristic" and local_model:
            # local_model: converted checkpoint dir, optionally "dir::name"
            # to select the architecture config.
            try:
                path, _, name = str(local_model).partition("::")
                self._processor = LocalLMAnalyzer(
                    path, model_name=name or "tinyllama-1.1b",
                    temperature=temperature, max_length=max_length, device=lm_device,
                )
                self._backend = "local"
                self._model_desc = name or "tinyllama-1.1b"
            except Exception as exc:
                logger.warning("Local LM unavailable (%s); using heuristic analyzer", exc)

        logger.info("LLM backend: %s (%s)", self._backend, self._model_desc)

    def process(self, text: str) -> Dict[str, Any]:
        result = self._processor.process(text)
        if "error" in result and self._backend != "heuristic":
            logger.warning("LLM backend failed; falling back to heuristic analyzer")
            return HeuristicAnalyzer().process(text)
        return result

    def get_backend_info(self) -> Dict[str, str]:
        return {"backend": self._backend, "model": self._model_desc}


# the pipeline imports LLMPostProcessor from this module, as the JAX
# package's does
LLMPostProcessor = HybridLLMPostProcessor
