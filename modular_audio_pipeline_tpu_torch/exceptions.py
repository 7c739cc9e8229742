"""Typed failures raised by the PyTorch port.

The subset of ``modular_audio_pipeline_tpu/exceptions.py`` that the port
raises, copied so the port never imports the JAX package. Same class names, stages and ``str()`` wire format.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = [
    "AudioPipelineError", "AudioProcessingError", "TranscriptionError",
    "ModelLoadError", "VocalSeparationError",
]


class AudioPipelineError(Exception):
    """Base class for every pipeline failure.

    Carries a short human message plus optional diagnostic ``details``
    appended on its own line by ``str()``.
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


class AudioProcessingError(AudioPipelineError):
    """Reading, writing or resampling audio failed."""
    stage = "preprocess"


class TranscriptionError(AudioPipelineError):
    """Speech-to-text failed."""
    stage = "transcribe"
    retryable = True


class VocalSeparationError(AudioPipelineError):
    """Vocal separation failed."""
    stage = "separate"
    retryable = True


class ModelLoadError(AudioPipelineError):
    """Model weights or tokenizer could not be loaded."""
    stage = "model-load"
