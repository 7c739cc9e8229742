"""modular_audio_pipeline_tpu_torch — the PyTorch/CUDA port of
``modular_audio_pipeline_tpu`` for NVIDIA Hopper GPUs.

It mirrors the JAX package's layout, module for module, and is tested
against it on the same inputs and weights. It imports torch and numpy,
never jax and nothing of the JAX package. Ported so far: Whisper
transcription over 30 s windows (log-mel, encoder with a hand-written
flash-attention kernel, beam decode with a hand-written ancestry-attention
kernel over an int8 KV cache, segment and DTW word timestamps, the
temperature-fallback ladder, language detection, and a weight-only int8
decoder through a hand-written int8 product kernel), and the serving path
around it (``ServingPipeline.process`` and ``run_file``: auto-detected vocal
separation by the MaskUNet or REPET, denoise and loudness statistics, the
trained ConvVAD or a converted Silero VAD, the window gather, the trained
segmentation + embedding diarization stack or the weight-free statistics
embedder, speaker alignment and the JSON output).

Example::

    from modular_audio_pipeline_tpu_torch import PipelineConfig, ServingPipeline

    cfg = PipelineConfig()
    cfg.transcription.model = "large-v3-turbo"
    result = ServingPipeline(cfg).run_file("meeting.wav", "results/")  # CUDA

Names are resolved on first access, so importing the package loads no
model code.
"""

import importlib

__all__ = ["WhisperTranscriber", "TorchWhisperBackend", "ServingPipeline",
           "TranscriptionConfig", "PipelineConfig", "ModelLoadError", "TranscriptionError"]

_HOME = {
    "ServingPipeline": ".serving",
    "WhisperTranscriber": ".transcriber",
    "TorchWhisperBackend": ".transcriber",
    "TranscriptionConfig": ".config",
    "PipelineConfig": ".config",
    "ModelLoadError": ".exceptions",
    "TranscriptionError": ".exceptions",
}


def __getattr__(name):
    if name in _HOME:
        return getattr(importlib.import_module(_HOME[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
