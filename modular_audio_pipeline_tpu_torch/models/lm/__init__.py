"""Decoder-only language models for local LLM post-processing.

Counterpart of ``modular_audio_pipeline_tpu/models/lm``: a llama-architecture
model (RMSNorm, RoPE, GQA, SwiGLU) with offline checkpoint conversion and a
generation loop over a preallocated KV cache, so meeting analysis runs on
the same card as transcription.
"""

from .llama import LLAMA_CONFIGS, LlamaConfig, LlamaLM

__all__ = ["LlamaConfig", "LlamaLM", "LLAMA_CONFIGS"]
