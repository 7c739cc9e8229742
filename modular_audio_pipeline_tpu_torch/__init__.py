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
embedder, speaker alignment and the JSON output); the stage-by-stage
``AudioPipeline`` with dependency injection, WAV checkpoints per stage
and the timestamp mappings, its media handler with native FLAC/MP3
decoders, the checkpointed ``BatchDriver`` and the CLI
(``python -m modular_audio_pipeline_tpu_torch``, the flags of the
repository's ``main.py``); whisper's seek loop (``chunking="sequential"``)
and incremental ``StreamingSession``s over it; the LLM post-processing
ladder with a local Llama LM on the card; and the WER/DER metrics
(``python -m modular_audio_pipeline_tpu_torch.evaluation.metrics``); the
checksummed device transfers of the decode and the weight upload; and
multi-card data and tensor parallelism (one process per card under
``torchrun``: ``parallel/mesh.py``, ``parallel/sharding.py``) through
serving, the transcribers, the batch driver and training. Every name of
the JAX package's ``__all__`` resolves here.

Example::

    from modular_audio_pipeline_tpu_torch import AudioPipeline, PipelineConfig

    cfg = PipelineConfig.from_json("config.json")
    result = AudioPipeline(cfg).run("meeting.mp3")  # CUDA; device="cpu" for the CPU

Names are resolved on first access, so importing the package loads no
model code.
"""

import importlib

# every name of the JAX package's __all__, and the port's own entry points
_EXPORTS = {
    ".pipeline": ("AudioPipeline", "PipelineResult"),
    ".config": ("PipelineConfig", "AudioConfig", "VADConfig", "NoiseReductionConfig",
                "VocalSeparationConfig", "TranscriptionConfig", "DiarizationConfig",
                "RedundancyConfig", "RetryConfig", "SegmentMergingConfig", "LLMConfig",
                "TPUConfig", "DEFAULT_PROMPTS", "get_default_config"),
    ".protocols": ("MediaHandlerProtocol", "PreprocessorProtocol", "VocalSeparatorProtocol",
                   "VADProtocol", "TranscriberProtocol", "DiarizerProtocol",
                   "RedundancyRemoverProtocol", "TranscriptionSegment", "DiarizationSegment",
                   "TimestampMapping", "ProcessingResult", "AudioBuffer"),
    ".exceptions": ("AudioPipelineError", "MediaNotFoundError", "MediaConversionError",
                    "AudioProcessingError", "VocalSeparationError", "TranscriptionError",
                    "DiarizationError", "VADError", "ConfigurationError", "ModelLoadError",
                    "FileValidationError", "ShardingError"),
    ".media_handler": ("MediaHandler",),
    ".preprocessor": ("AudioPreprocessor",),
    ".separator": ("VocalSeparator", "NoOpVocalSeparator"),
    ".vad": ("VADFilter", "SileroVADFilter", "NoOpVADFilter"),
    ".transcriber": ("WhisperTranscriber", "FasterWhisperTranscriber", "TorchWhisperBackend"),
    ".streaming": ("StreamingSession",),
    ".diarizer": ("SpeakerDiarizer", "NoOpDiarizer"),
    ".redundancy": ("RedundancyRemover", "NoOpRedundancyRemover"),
    ".segment_merger": ("SegmentMerger",),
    ".utils": ("retry_with_backoff", "validate_file", "CheckpointManager", "get_file_hash",
               "ensure_directory", "get_audio_duration", "format_timestamp",
               "parse_timestamp"),
    ".serving": ("ServingPipeline",),
    ".parallel.batch": ("BatchDriver",),
}
_HOME = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = list(_HOME)


def __getattr__(name):
    if name in _HOME:
        return getattr(importlib.import_module(_HOME[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
