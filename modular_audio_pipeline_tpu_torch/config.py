"""Configuration dataclasses read by the PyTorch port.

Copied from ``modular_audio_pipeline_tpu/config.py``, same fields and
defaults: the sections the transcriber and the serving path read
(``audio``, ``vad``, ``noise_reduction``, ``vocal_separation``,
``transcription``, ``diarization``, ``redundancy``, ``segment_merging``),
``RetryConfig``, and a ``PipelineConfig`` holding them. The readers take
attributes only, so the JAX package's own ``PipelineConfig`` works too.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

__all__ = [
    "AudioConfig",
    "VADConfig",
    "NoiseReductionConfig",
    "VocalSeparationConfig",
    "TranscriptionConfig",
    "DiarizationConfig",
    "RedundancyConfig",
    "SegmentMergingConfig",
    "RetryConfig",
    "PipelineConfig",
]


@dataclass
class AudioConfig:
    """Target waveform format for the whole pipeline."""

    sample_rate: int = 16000
    channels: int = 1
    bit_depth: int = 16


@dataclass
class VADConfig:
    """Voice-activity-detection settings: ``provider`` "silero" runs the
    trained ConvVAD (energy probabilities without a bundle), "webrtc" the
    frame classifier with the ring-buffer hangover machine."""

    enabled: bool = True
    provider: str = "silero"  # "webrtc" | "silero"
    # silero-style
    threshold: float = 0.5
    min_speech_duration_ms: int = 250
    # webrtc-style
    mode: int = 1
    frame_duration_ms: int = 30
    padding_duration_ms: int = 500
    start_threshold: float = 0.5
    stop_threshold: float = 0.9


@dataclass
class NoiseReductionConfig:
    """Stationary spectral-gate denoise settings."""

    enabled: bool = True
    auto_detect_noise: bool = True
    noise_sample_duration_s: float = 0.5
    noise_sample_path: Optional[str] = None
    prop_decrease: float = 0.8


@dataclass
class VocalSeparationConfig:
    """Vocal isolation: MaskUNet bundle ``separation-<model>``, else REPET;
    ``chunk_minutes`` per separation call; ``auto_detect`` separates only
    audio that the energy-CV test finds music in."""

    enabled: bool = False
    model: str = "htdemucs"
    chunk_minutes: float = 5.0
    auto_detect: bool = True


@dataclass
class TranscriptionConfig:
    """Whisper decoding settings."""

    backend: str = "faster-whisper"  # the name written into run_file's JSON
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
class DiarizationConfig:
    """Speaker diarization settings."""

    enabled: bool = True
    min_speakers: int = 1
    max_speakers: int = 5
    model: str = "pyannote/speaker-diarization-3.1"  # weight-bundle name
    weights_path: Optional[str] = None
    segmentation_batch_size: int = 32
    embedding_batch_size: int = 32
    window_s: float = 10.0
    step_s: float = 1.0


@dataclass
class RedundancyConfig:
    """Near-duplicate segment filtering."""

    enabled: bool = True
    similarity_threshold: float = 0.85


@dataclass
class SegmentMergingConfig:
    """Merge adjacent same-speaker segments closer than ``max_gap_s``."""

    enabled: bool = True
    max_gap_s: float = 0.5


@dataclass
class RetryConfig:
    """Exponential-backoff retry for flaky calls."""

    max_attempts: int = 3
    initial_delay_s: float = 1.0
    exponential_backoff: bool = True
    max_delay_s: float = 30.0


@dataclass
class PipelineConfig:
    """The part of the pipeline configuration the port reads."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    vad: VADConfig = field(default_factory=VADConfig)
    noise_reduction: NoiseReductionConfig = field(default_factory=NoiseReductionConfig)
    vocal_separation: VocalSeparationConfig = field(default_factory=VocalSeparationConfig)
    transcription: TranscriptionConfig = field(default_factory=TranscriptionConfig)
    diarization: DiarizationConfig = field(default_factory=DiarizationConfig)
    redundancy: RedundancyConfig = field(default_factory=RedundancyConfig)
    segment_merging: SegmentMergingConfig = field(default_factory=SegmentMergingConfig)
    preserve_timestamps: bool = True
    lazy_load_models: bool = True
