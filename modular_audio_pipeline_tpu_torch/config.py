"""Configuration dataclasses read by the PyTorch port.

Copied from ``modular_audio_pipeline_tpu/config.py``: the
``TranscriptionConfig`` fields that ``WhisperTranscriber.from_config``
reads, ``RetryConfig``, and a ``PipelineConfig`` holding only those.
``from_config`` reads attributes only, so the JAX package's own
``PipelineConfig`` works there too.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

__all__ = ["TranscriptionConfig", "RetryConfig", "PipelineConfig"]


@dataclass
class TranscriptionConfig:
    """Whisper decoding settings."""

    model: str = "large-v3"
    compute_type: str = "bfloat16"  # "bfloat16" | "float32" | "int8" (weight-only decoder)
    language: str = "pt"
    task: str = "transcribe"
    temperature: float = 0.0
    beam_size: int = 5
    prompt: Optional[str] = None
    batch_size: int = 16  # 30 s windows decoded together
    weights_path: Optional[str] = None  # converted checkpoint dir or "random:<seed>"
    max_decode_tokens: int = 224  # decode-loop bound per 30 s window
    word_timestamps: bool = True  # cross-attention DTW word alignment
    chunking: str = "batched"  # "sequential" (seek loop): not ported yet
    # Whisper quality gates: a window is dropped as non-speech when
    # no_speech_prob exceeds no_speech_threshold AND avg_logprob is below
    # logprob_threshold; windows failing the logprob/compression gates
    # retry up the temperature ladder.
    no_speech_threshold: Optional[float] = 0.6
    logprob_threshold: Optional[float] = -1.0
    compression_ratio_threshold: Optional[float] = 2.4
    # Beam-search patience: search until round(beam_size * patience)
    # finished hypotheses per window.
    patience: Optional[float] = None
    condition_on_previous_text: bool = True
    # Decoder self-attention KV cache dtype: "int8" (default) or "bfloat16".
    kv_cache_dtype: str = "int8"


@dataclass
class RetryConfig:
    """Exponential-backoff retry for flaky calls."""

    max_attempts: int = 3
    initial_delay_s: float = 1.0
    exponential_backoff: bool = True
    max_delay_s: float = 30.0


@dataclass
class PipelineConfig:
    """The part of the pipeline configuration the transcriber reads."""

    transcription: TranscriptionConfig = field(default_factory=TranscriptionConfig)
    lazy_load_models: bool = True
