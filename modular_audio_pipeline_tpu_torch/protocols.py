"""Dependency-injection contracts and the data passed between stages.

Copied from ``modular_audio_pipeline_tpu/protocols.py`` (same method names
and dataclass fields): the orchestrator talks to every stage through these
runtime-checkable ``typing.Protocol`` interfaces, so any stage can be
swapped for a custom or fake implementation. Every method keeps the
path-in/path-out signature; first-party stages also hand device tensors
to each other (``audio_io.publish_buffer``/``get_buffer``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol, Tuple, runtime_checkable

__all__ = [
    "TranscriptionSegment",
    "DiarizationSegment",
    "TimestampMapping",
    "ProcessingResult",
    "AudioBuffer",
    "MediaHandlerProtocol",
    "PreprocessorProtocol",
    "VocalSeparatorProtocol",
    "VADProtocol",
    "TranscriberProtocol",
    "DiarizerProtocol",
    "RedundancyRemoverProtocol",
]


# ---------------------------------------------------------------------------
# Data classes (the wire format between stages)
# ---------------------------------------------------------------------------

@dataclass
class TranscriptionSegment:
    """One transcribed span with timing and speaker attribution."""

    text: str
    start: float
    end: float
    speaker: str = "Unknown"
    confidence: float = 1.0
    original_start: Optional[float] = None
    original_end: Optional[float] = None


@dataclass
class DiarizationSegment:
    """One speaker turn."""

    speaker: str
    start: float
    end: float
    track: str = ""


@dataclass
class TimestampMapping:
    """Interval map from the processed timeline back to the original audio.

    Produced by silence removal and VAD (both of which cut audio out), and
    consumed by the orchestrator's back-mapping step.
    """

    processed_start: float
    processed_end: float
    original_start: float
    original_end: float


@dataclass
class ProcessingResult:
    """Path + mapping pair returned by audio-mutating stages."""

    audio_path: str
    timestamp_mappings: List[TimestampMapping]


@dataclass
class AudioBuffer:
    """In-memory audio exchange format: ``samples`` is a host array or a
    device tensor, float32 in [-1, 1]; ``length`` is the number of valid
    samples when it is padded to a bucket boundary."""

    samples: Any  # np.ndarray | torch.Tensor, shape [padded_len]
    sample_rate: int
    length: Optional[int] = None  # valid samples; None => samples.shape[0]
    source_path: Optional[str] = None
    mappings: List[TimestampMapping] = field(default_factory=list)

    @property
    def valid_length(self) -> int:
        return int(self.length) if self.length is not None else int(self.samples.shape[0])

    @property
    def duration(self) -> float:
        return self.valid_length / float(self.sample_rate)


# ---------------------------------------------------------------------------
# Component protocols
# ---------------------------------------------------------------------------

@runtime_checkable
class MediaHandlerProtocol(Protocol):
    """Finds media files and converts them to pipeline-format WAV."""

    def find_media_file(self) -> Tuple[str, bool]:
        """Return (path, is_video) for the first discovered media file."""

    def convert_to_wav(self, input_path: str) -> str:
        """Convert any supported media file to mono 16-bit WAV."""

    def validate_file(self, file_path: str) -> bool:
        """Raise FileValidationError unless the file is usable."""


@runtime_checkable
class PreprocessorProtocol(Protocol):
    """Denoise, normalize, and silence-strip audio."""

    def reduce_stationary_noise(
        self, input_wav: str, noise_sample_path: Optional[str] = None
    ) -> str:
        """Reduce stationary noise; returns the denoised WAV path."""

    def normalize_audio(self, input_wav: str) -> str:
        """Peak-normalize to mono 16-bit at the target rate; returns the path."""

    def normalize_loudness(self, input_wav: str, target_lufs: float = -16.0) -> str:
        """BS.1770 loudness normalization toward ``target_lufs``."""

    def remove_silence(self, input_wav: str) -> Tuple[str, List[TimestampMapping]]:
        """Strip silent spans; returns (path, mappings to the original timeline)."""


@runtime_checkable
class VocalSeparatorProtocol(Protocol):
    """Isolate vocals from music-contaminated audio."""

    def extract_vocals(self, input_wav: str) -> str:
        """Return the vocal-stem WAV path (input unchanged when not needed)."""

    def is_separation_needed(self, input_wav: str) -> bool:
        """True when music-detection says separation would help."""


@runtime_checkable
class VADProtocol(Protocol):
    """Voice-activity detection: keep speech, drop the rest."""

    def filter_voice(
        self, input_wav: str, output_dir: str
    ) -> Tuple[str, List[TimestampMapping]]:
        """Keep voiced spans only; returns (path, timeline mappings)."""

    def detect_speech_segments(self, input_wav: str) -> List[Tuple[float, float]]:
        """(start_s, end_s) speech spans without modifying the audio."""


@runtime_checkable
class TranscriberProtocol(Protocol):
    """Speech to text."""

    def transcribe(self, input_wav: str) -> Dict[str, Any]:
        """Return {"text": ..., "segments": [{start, end, text, ...}], ...}."""

    def is_loaded(self) -> bool:
        """Whether weights are resident."""

    def load_model(self) -> None:
        """Load weights (idempotent)."""


@runtime_checkable
class DiarizerProtocol(Protocol):
    """Who spoke when."""

    def diarize(
        self, audio_path: str, min_speakers: int = 2, max_speakers: int = 5
    ) -> List[DiarizationSegment]:
        """Speaker turns within the given speaker-count bounds."""

    def is_loaded(self) -> bool:
        """Whether weights are resident."""

    def load_model(self) -> None:
        """Load weights (idempotent)."""


@runtime_checkable
class RedundancyRemoverProtocol(Protocol):
    """Drop near-duplicate consecutive transcription segments."""

    def remove(self, segments: List[Dict]) -> List[Dict]:
        """Filtered copy with near-duplicate consecutive texts dropped."""

    def is_similar(self, a: str, b: str) -> bool:
        """True when two texts exceed the similarity threshold."""
