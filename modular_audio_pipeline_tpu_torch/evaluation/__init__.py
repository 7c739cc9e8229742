"""Quality measures: WER / DER between transcription outputs.

A host copy of ``modular_audio_pipeline_tpu/evaluation``: word error rate,
diarization error rate, and a comparator that diffs two pipeline JSON
outputs (the port's against the JAX package's, or two configurations).
"""

from .metrics import compare_transcriptions, der, wer

__all__ = ["wer", "der", "compare_transcriptions"]
