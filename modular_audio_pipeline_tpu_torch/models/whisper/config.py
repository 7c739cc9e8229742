"""Whisper model-family dimension tables.

Covers every size the reference accepts (transcriber.py:71-80 /
config.py:212): tiny..large-v3-turbo, including the v3 128-mel frontend and
the turbo 4-layer decoder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

__all__ = ["WhisperDims", "WHISPER_DIMS", "MODEL_INFO"]


@dataclass(frozen=True)
class WhisperDims:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


def _dims(layers, width, heads, n_mels=80, n_vocab=51865, dec_layers=None) -> WhisperDims:
    return WhisperDims(
        n_mels=n_mels,
        n_audio_ctx=1500,
        n_audio_state=width,
        n_audio_head=heads,
        n_audio_layer=layers,
        n_vocab=n_vocab,
        n_text_ctx=448,
        n_text_state=width,
        n_text_head=heads,
        n_text_layer=dec_layers if dec_layers is not None else layers,
    )


WHISPER_DIMS: Dict[str, WhisperDims] = {
    "tiny": _dims(4, 384, 6),
    "base": _dims(6, 512, 8),
    "small": _dims(12, 768, 12),
    "medium": _dims(24, 1024, 16),
    "large": _dims(32, 1280, 20),
    "large-v2": _dims(32, 1280, 20),
    "large-v3": _dims(32, 1280, 20, n_mels=128, n_vocab=51866),
    "large-v3-turbo": _dims(32, 1280, 20, n_mels=128, n_vocab=51866, dec_layers=4),
    # tiny test model: fast to init/jit, exercises every code path
    "test-tiny": WhisperDims(
        n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
        n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_state=64,
        n_text_head=2, n_text_layer=2,
    ),
}

# Reference-compatible capability table (transcriber.py:71-80); the VRAM
# figures are the reference's device working-set estimates.
MODEL_INFO = {
    "tiny": {"vram_gb": 1, "params": "39M"},
    "base": {"vram_gb": 1, "params": "74M"},
    "small": {"vram_gb": 2, "params": "244M"},
    "medium": {"vram_gb": 5, "params": "769M"},
    "large": {"vram_gb": 10, "params": "1550M"},
    "large-v2": {"vram_gb": 10, "params": "1550M"},
    "large-v3": {"vram_gb": 10, "params": "1550M"},
    "large-v3-turbo": {"vram_gb": 6, "params": "809M"},
}
