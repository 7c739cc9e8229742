"""Incremental (streaming) transcription sessions.

Counterpart of ``modular_audio_pipeline_tpu/streaming.py``.
:class:`StreamingSession` takes audio a chunk at a time and emits
*finalized* segments as soon as whisper's seek grammar completes them,
through the sequential loop's own step
(:meth:`~.transcriber.TorchWhisperBackend.seek_decode_step`: advance by the
last paired timestamp, condition on the previous text, the no-speech gate),
so a streamed session gives the segments of an offline sequential run over
the concatenated audio.

Usage::

    backend = TorchWhisperBackend("large-v3-turbo", language="en")  # CUDA
    with StreamingSession(backend) as session:
        for chunk in microphone():        # any chunk sizes, one sample rate
            for seg in session.feed(chunk, sr):
                print(seg["start"], seg["text"])   # final, never revised
        result = session.finish()          # drains the tail

A 30 s window is decoded only once it is fully buffered (or at
``finish()``), and only the segments whisper marks complete (paired
timestamps) are emitted; the rest is decoded again with more context in
the next window, as offline seek decoding does. Each window's log-mel,
encoder and decode run on the backend's device; the buffer and the
resampling stay on the host.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .audio_io import resample_poly

logger = logging.getLogger(__name__)

__all__ = ["StreamingSession"]

_SR = 16000
_WINDOW_S = 30.0


class StreamingSession:
    """Chunk-at-a-time ingest over a ``TorchWhisperBackend``."""

    def __init__(self, backend, language: Optional[str] = None):
        self.backend = backend
        self._buf: List[np.ndarray] = []
        self._buffered = 0  # samples buffered (from _seek on)
        self._seek = 0  # absolute sample position of the buffer's start
        self._all_tokens: List[int] = []
        self._segments: List[Dict[str, Any]] = []
        self._opts = None
        self._language = language
        self._finished = False

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def from_config(cls, config, device: Optional[str] = None) -> "StreamingSession":
        """A session over the backend a :class:`~.config.PipelineConfig`
        describes (the pipeline components' factory convention)."""
        from .transcriber import FasterWhisperTranscriber

        tr = FasterWhisperTranscriber.from_config(config, device=device)
        return cls(tr._backend, language=config.transcription.language)

    def __enter__(self) -> "StreamingSession":
        return self

    def __exit__(self, *exc) -> None:
        if not self._finished:
            self.finish()

    def _ensure_opts(self, first_window: np.ndarray) -> None:
        if self._opts is not None:
            return
        self.backend.load()
        language = self._language or self.backend.language
        if language in (None, "", "auto"):
            from .models.whisper.decode import detect_language
            from .ops.mel import log_mel

            win = int(_WINDOW_S * _SR)
            padded = np.zeros(win, dtype=np.float32)
            padded[: len(first_window)] = first_window[:win]
            mel = log_mel(torch.from_numpy(padded[None]).to(self.backend.device),
                          n_mels=self.backend.dims.n_mels)
            language, _ = detect_language(self.backend.params, self.backend.dims,
                                          self.backend.tokenizer, mel)
            logger.info("Streaming session language: %s", language)
        self._language = language
        self._opts = self.backend._decode_options(language)

    # -- ingest ----------------------------------------------------------------

    def feed(self, chunk: np.ndarray, sr: int = _SR) -> List[Dict[str, Any]]:
        """Append audio; return the segments this chunk finalized.

        Chunks may be of any length and of one sample rate; int16 input is
        rescaled, input at another rate than 16 kHz is resampled on the host.
        """
        if self._finished:
            raise RuntimeError("StreamingSession already finished")
        chunk = np.asarray(chunk)
        if chunk.dtype == np.int16:
            chunk = chunk.astype(np.float32) * (1.0 / 32768.0)
        else:
            chunk = chunk.astype(np.float32, copy=False)
        if sr != _SR:
            chunk = resample_poly(chunk, sr, _SR)
        if chunk.size == 0:
            return []
        self._buf.append(chunk)
        self._buffered += len(chunk)
        return self._drain(final=False)

    def finish(self) -> Dict[str, Any]:
        """Decode the remaining tail; return the whole result dict (the
        shape of ``transcribe_array``'s)."""
        if not self._finished:
            self._drain(final=True)
            self._finished = True
        return {
            "text": " ".join(s["text"] for s in self._segments if s["text"]),
            "segments": self._segments,
            "language": self._language or self.backend.language,
            "duration": (self._seek + self._buffered) / _SR,
        }

    # -- internals -------------------------------------------------------------

    def _window(self) -> np.ndarray:
        """The buffer's first 30 s (or less) as one contiguous array."""
        if len(self._buf) > 1:
            self._buf = [np.concatenate(self._buf)]
        return self._buf[0][: int(_WINDOW_S * _SR)]

    def _consume(self, n: int) -> None:
        self._buf = [self._buf[0][n:]] if self._buf else []
        self._buffered -= n
        self._seek += n

    def _drain(self, final: bool) -> List[Dict[str, Any]]:
        """Decode every full window (all the remaining audio when ``final``)."""
        win = int(_WINDOW_S * _SR)
        emitted: List[Dict[str, Any]] = []
        while self._buffered >= win or (final and self._buffered > 0):
            chunk = self._window()
            self._ensure_opts(chunk)
            # only whisper-completed segments come back; the rest is decoded
            # again with more context once the next window fills (or at the end)
            segs, advance, self._all_tokens = self.backend.seek_decode_step(
                chunk, self._seek, self._opts, self._all_tokens)
            emitted.extend(segs)
            self._consume(min(advance, self._buffered))
        self._segments.extend(emitted)
        return emitted
