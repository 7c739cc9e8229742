"""Typed failures raised by the PyTorch port.

Copied from ``modular_audio_pipeline_tpu/exceptions.py`` so the port never
imports the JAX package: one class per pipeline stage with the same names,
``stage``/``retryable`` metadata, ``str()`` wire format and ``to_dict()``
form for batch ledgers, including the integrity layer's
``FetchIntegrityError`` (``runtime/integrity.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = [
    "AudioPipelineError", "MediaNotFoundError", "MediaConversionError",
    "AudioProcessingError", "VocalSeparationError", "TranscriptionError",
    "DiarizationError", "VADError", "ConfigurationError", "ModelLoadError",
    "FileValidationError", "ShardingError", "FetchIntegrityError",
]


class AudioPipelineError(Exception):
    """Base class for every pipeline failure.

    Carries a short human message plus optional diagnostic ``details``
    (stderr tails, shape dumps, ...) appended on its own line by
    ``str()``.
    """

    stage: str = "pipeline"
    retryable: bool = False

    def __init__(self, message: str, details: Optional[str] = None):
        self.message = message
        self.details = details
        super().__init__(message)

    def __str__(self) -> str:
        return f"{self.message}\nDetails: {self.details}" if self.details else self.message

    def to_dict(self) -> Dict[str, Any]:
        """Structured form for batch ledgers / JSON logs."""
        return {
            "type": type(self).__name__,
            "stage": self.stage,
            "retryable": self.retryable,
            "message": self.message,
            "details": self.details,
        }


class MediaNotFoundError(AudioPipelineError):
    """Discovery found no usable media file."""
    stage = "discovery"


class MediaConversionError(AudioPipelineError):
    """Decoding or conversion of the input media failed."""
    stage = "convert"
    retryable = True  # subprocess/IO hiccups


class AudioProcessingError(AudioPipelineError):
    """A DSP preprocessing stage (denoise / normalize / silence) failed."""
    stage = "preprocess"


class VocalSeparationError(AudioPipelineError):
    """Vocal separation failed."""
    stage = "separate"
    retryable = True


class TranscriptionError(AudioPipelineError):
    """Speech-to-text failed."""
    stage = "transcribe"
    retryable = True


class DiarizationError(AudioPipelineError):
    """Speaker diarization failed."""
    stage = "diarize"
    retryable = True


class VADError(AudioPipelineError):
    """Voice-activity detection failed."""
    stage = "vad"


class ConfigurationError(AudioPipelineError):
    """The pipeline configuration is invalid (never retryable)."""
    stage = "config"


class ModelLoadError(AudioPipelineError):
    """Model weights / tokenizer / compiled program could not be loaded."""
    stage = "model-load"


class FileValidationError(AudioPipelineError):
    """A file failed existence / extension / size validation."""
    stage = "validate"


class ShardingError(AudioPipelineError):
    """Mesh construction or sharding specification failed."""
    stage = "sharding"


class FetchIntegrityError(AudioPipelineError):
    """A device<->host transfer failed checksum verification.

    Raised when a critical device buffer (decoded tokens, beam logprobs,
    uploaded weights) keeps disagreeing with the checksum computed from the
    other side's copy of the same bytes. Callers should retry the run in a
    fresh process rather than trust the data.
    """
    stage = "fetch"
