"""Typed configuration of the PyTorch port.

Copied from ``modular_audio_pipeline_tpu/config.py``: the same nested
dataclasses with the same fields and defaults (including the ``tpu``
and ``llm`` sections, so that a config file written for the JAX package
loads here), JSON round-trip with ``_``-prefixed comment keys,
``AUDIO_PIPELINE_*`` environment overrides and aggregated validation.

The port reads ``tpu.mesh_shape`` as the device mesh (one process per
card under ``torchrun``, ``parallel/mesh.py``), ``tpu.profile_dir`` as a
``torch.profiler`` trace directory, and ``transcription.device`` not at
all: the placement is the ``device=`` argument of the entry points (CUDA
unless the caller asks for the CPU).

Precedence when building a config (as the CLI does): CLI flags > JSON
file > environment > dataclass defaults.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from .exceptions import ConfigurationError

logger = logging.getLogger(__name__)

__all__ = [
    "AudioConfig",
    "VADConfig",
    "NoiseReductionConfig",
    "VocalSeparationConfig",
    "TranscriptionConfig",
    "SegmentMergingConfig",
    "LLMConfig",
    "DiarizationConfig",
    "RedundancyConfig",
    "RetryConfig",
    "TPUConfig",
    "PipelineConfig",
    "DEFAULT_PROMPTS",
    "get_default_config",
]


def _strip_comments(d: Dict[str, Any]) -> Dict[str, Any]:
    """Drop ``_``-prefixed keys, which JSON configs use as inline comments
    ."""
    return {k: v for k, v in d.items() if not k.startswith("_")}


@dataclass
class AudioConfig:
    """Target waveform format for the whole pipeline."""

    sample_rate: int = 16000
    channels: int = 1
    bit_depth: int = 16


@dataclass
class VADConfig:
    """Voice-activity-detection settings: ``provider`` "silero" runs the
    trained ConvVAD or a converted Silero VAD (energy probabilities
    without a bundle), "webrtc" the frame classifier with the ring-buffer
    hangover machine."""

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
    prop_decrease: float = 0.8  # gate strength


@dataclass
class VocalSeparationConfig:
    """Vocal isolation settings. Off by default; auto-detect gates execution."""

    enabled: bool = False
    model: str = "htdemucs"  # weight bundle separation-<model>; REPET otherwise
    chunk_minutes: float = 5.0
    auto_detect: bool = True


@dataclass
class TranscriptionConfig:
    """Whisper decoding settings."""

    backend: str = "faster-whisper"  # "openai" | "faster-whisper" (one torch backend)
    model: str = "large-v3"
    device: str = "tpu"  # carried for config files; the entry points' device= places the work
    compute_type: str = "bfloat16"  # "bfloat16" | "float32" | "int8"
    language: str = "pt"
    task: str = "transcribe"
    temperature: float = 0.0
    beam_size: int = 5
    prompt: Optional[str] = None
    batch_size: int = 16  # 30 s windows decoded together per device
    weights_path: Optional[str] = None  # converted checkpoint dir or "random:<seed>"
    max_decode_tokens: int = 224  # decode-loop bound per 30 s window
    word_timestamps: bool = True  # cross-attention DTW word alignment
    # "batched": windows decode independently in parallel (throughput);
    # "sequential": whisper's seek loop, one window at a time conditioned on
    # the previous text (accuracy over throughput).
    chunking: str = "batched"
    # Whisper quality gates (faster-whisper exposes the same options):
    # a window is dropped as non-speech when no_speech_prob exceeds
    # no_speech_threshold AND avg_logprob is below logprob_threshold;
    # windows failing logprob/compression gates retry up the temperature
    # ladder.
    no_speech_threshold: float = 0.6
    logprob_threshold: float = -1.0
    compression_ratio_threshold: float = 2.4
    # Beam-search patience (faster-whisper option): search until
    # round(beam_size * patience) finished hypotheses per window.
    patience: Optional[float] = None
    # The seek loop's conditioning on previously decoded text.
    condition_on_previous_text: bool = True
    # Decoder self-attention KV cache dtype: "int8" (default) or "bfloat16".
    kv_cache_dtype: str = "int8"


@dataclass
class SegmentMergingConfig:
    """Merge adjacent same-speaker segments closer than ``max_gap_s``."""

    enabled: bool = True
    max_gap_s: float = 0.5


@dataclass
class LLMConfig:
    """Optional LLM post-processing (summary / topics / action items)."""

    enabled: bool = False
    use_openai: bool = True
    openai_model: str = "gpt-4o-mini"
    local_model: Optional[str] = None  # path to converted JAX LM weights
    device: str = "auto"
    max_length: int = 2048
    temperature: float = 0.3


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
class RetryConfig:
    """Exponential-backoff retry for flaky external calls."""

    max_attempts: int = 3
    initial_delay_s: float = 1.0
    exponential_backoff: bool = True
    max_delay_s: float = 30.0


@dataclass
class TPUConfig:
    """Execution policy (the JAX package's accelerator section, kept under
    its name so config files load unchanged).

    ``mesh_shape`` maps axis names to sizes; any axis above 1 asks for a
    multi-device mesh (``data`` shards window batches, ``model`` the
    Whisper heads), whose size must equal the number of ranks that
    ``torchrun`` starts. ``profile_dir`` makes ``AudioPipeline.run`` write a
    ``torch.profiler`` trace there. The other fields are carried for
    config parity.
    """

    mesh_shape: Dict[str, int] = field(default_factory=dict)  # {} => single device
    data_axis: str = "data"
    model_axis: str = "model"
    compute_dtype: str = "bfloat16"
    bucket_seconds: List[float] = field(
        default_factory=lambda: [30.0, 60.0, 300.0, 600.0, 1800.0, 3600.0]
    )
    window_seconds: float = 30.0  # whisper context
    prefetch_depth: int = 2  # host->device staging double buffering
    donate_buffers: bool = True
    profile_dir: Optional[str] = None  # torch.profiler trace output


@dataclass
class PipelineConfig:
    """Root configuration object."""

    media_dir: str = "./files"
    temp_dir: Optional[str] = None
    results_dir: Optional[str] = None

    audio: AudioConfig = field(default_factory=AudioConfig)
    vad: VADConfig = field(default_factory=VADConfig)
    noise_reduction: NoiseReductionConfig = field(default_factory=NoiseReductionConfig)
    vocal_separation: VocalSeparationConfig = field(default_factory=VocalSeparationConfig)
    transcription: TranscriptionConfig = field(default_factory=TranscriptionConfig)
    diarization: DiarizationConfig = field(default_factory=DiarizationConfig)
    redundancy: RedundancyConfig = field(default_factory=RedundancyConfig)
    retry: RetryConfig = field(default_factory=RetryConfig)
    segment_merging: SegmentMergingConfig = field(default_factory=SegmentMergingConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)

    preserve_timestamps: bool = True
    subprocess_timeout_s: int = 600
    lazy_load_models: bool = True  # load weights on first use
    checkpoint_enabled: bool = True

    _NESTED = {
        "audio": AudioConfig,
        "vad": VADConfig,
        "noise_reduction": NoiseReductionConfig,
        "vocal_separation": VocalSeparationConfig,
        "transcription": TranscriptionConfig,
        "diarization": DiarizationConfig,
        "redundancy": RedundancyConfig,
        "retry": RetryConfig,
        "segment_merging": SegmentMergingConfig,
        "llm": LLMConfig,
        "tpu": TPUConfig,
    }
    _SCALARS = (
        "media_dir",
        "temp_dir",
        "results_dir",
        "preserve_timestamps",
        "subprocess_timeout_s",
        "lazy_load_models",
        "checkpoint_enabled",
    )

    def __post_init__(self) -> None:
        """Resolve paths; derive temp/results under media_dir when unset."""
        self.media_dir = str(Path(self.media_dir).resolve())
        if self.temp_dir is None:
            self.temp_dir = str(Path(self.media_dir) / "temp")
        else:
            self.temp_dir = str(Path(self.temp_dir).resolve())
        if self.results_dir is None:
            self.results_dir = str(Path(self.media_dir) / "results")
        else:
            self.results_dir = str(Path(self.results_dir).resolve())

    # -- validation ---------------------------------------------------------

    def validate(self) -> None:
        """Aggregate all validation failures into one ConfigurationError."""
        problems: List[str] = []

        if self.audio.sample_rate not in (8000, 16000, 22050, 44100, 48000):
            problems.append(f"Invalid sample rate: {self.audio.sample_rate}")

        if not 0 <= self.vad.mode <= 3:
            problems.append(f"VAD mode must be 0-3, got: {self.vad.mode}")
        if self.vad.frame_duration_ms not in (10, 20, 30):
            problems.append("VAD frame duration must be 10, 20, or 30ms")
        if not 0 <= self.vad.start_threshold <= 1:
            problems.append("VAD start threshold must be 0-1")
        if not 0 <= self.vad.stop_threshold <= 1:
            problems.append("VAD stop threshold must be 0-1")

        known_models = (
            "tiny", "base", "small", "medium",
            "large", "large-v2", "large-v3", "large-v3-turbo",
        )
        if self.transcription.model not in known_models:
            logger.warning("Unknown Whisper model: %s", self.transcription.model)

        if self.diarization.min_speakers > self.diarization.max_speakers:
            problems.append("min_speakers cannot be greater than max_speakers")

        if not 0 <= self.redundancy.similarity_threshold <= 1:
            problems.append("Similarity threshold must be 0-1")

        if self.tpu.compute_dtype not in ("bfloat16", "float32", "float16"):
            problems.append(f"Unsupported compute dtype: {self.tpu.compute_dtype}")
        for axis, size in self.tpu.mesh_shape.items():
            if size < 1:
                problems.append(f"Mesh axis {axis!r} must be >= 1, got {size}")
        if any(b <= 0 for b in self.tpu.bucket_seconds):
            problems.append("bucket_seconds entries must be positive")

        if problems:
            raise ConfigurationError(
                "Configuration validation failed", details="\n".join(problems)
            )

    # -- construction -------------------------------------------------------

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "PipelineConfig":
        """Build from a (possibly comment-annotated) dict."""
        cfg = cls()
        for key in cls._SCALARS:
            if key in data:
                setattr(cfg, key, data[key])
        for key, sub_cls in cls._NESTED.items():
            if key in data:
                setattr(cfg, key, sub_cls(**_strip_comments(data[key])))
        cfg.__post_init__()
        return cfg

    @classmethod
    def from_json(cls, path: str) -> "PipelineConfig":
        """Load from a JSON file (``_``-keys ignored as comments)."""
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_env(cls) -> "PipelineConfig":
        """Defaults overridden by ``AUDIO_PIPELINE_*`` environment variables."""
        cfg = cls()
        env = os.getenv
        if v := env("AUDIO_PIPELINE_MEDIA_DIR"):
            cfg.media_dir = v
        if v := env("AUDIO_PIPELINE_MODEL"):
            cfg.transcription.model = v
        if v := env("AUDIO_PIPELINE_LANGUAGE"):
            cfg.transcription.language = v
        if v := env("AUDIO_PIPELINE_PROMPT"):
            cfg.transcription.prompt = v
        cfg.__post_init__()
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def to_json(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, ensure_ascii=False)


# Prompt presets, the same names and texts as the JAX package's.
DEFAULT_PROMPTS: Dict[str, str] = {
    "pt_instructions": (
        "(Portuguese context) Transcribe this recording in Portuguese. "
        "The content is a manager providing work instructions. Preserve punctuation, "
        "indicate pauses or hesitations, and format the transcription into readable "
        "paragraphs."
    ),
    "pt_meeting": (
        "(Portuguese context) This is a work meeting in Portuguese. "
        "Transcribe all speech accurately and identify different speakers. "
        "Keep correct punctuation and indicate pauses where appropriate."
    ),
    "pt_interview": (
        "(Portuguese context) This is an interview in Portuguese. "
        "Transcribe questions and answers accurately, preserving tone and speaking style."
    ),
    "en_general": (
        "Transcribe this audio accurately in English. "
        "Maintain proper punctuation and indicate pauses or hesitations. "
        "Format the transcription in paragraphs for readability."
    ),
    "en_technical": (
        "This is a technical discussion in English. "
        "Transcribe accurately, paying attention to technical terms and acronyms. "
        "Maintain proper punctuation."
    ),
}


def get_default_config() -> PipelineConfig:
    """Default config with the English instructional prompt preset."""
    cfg = PipelineConfig()
    cfg.transcription.prompt = DEFAULT_PROMPTS["en_general"]
    return cfg
