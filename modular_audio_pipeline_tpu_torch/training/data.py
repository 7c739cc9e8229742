"""Fine-tuning data pipeline: (audio, transcript) -> (mel, tokens, targets).

Counterpart of ``modular_audio_pipeline_tpu/training/data.py``. Consumes a
JSONL manifest (``{"audio": path, "text": transcript}`` per line, or rows
with ``"segments"`` for the long-form grammar) and produces fixed-shape
host batches for :func:`.whisper_train.make_train_step`:

- mel ``[B, n_mels, 3000]`` (30 s window, the audio at its start, zeros
  after), computed by ``ops/mel.log_mel`` on the dataset's device;
- tokens ``[B, S]`` teacher-forcing inputs (SOT sequence + text + EOT,
  EOT-padded);
- targets ``[B, S]`` next-token labels with ``IGNORE_INDEX`` on the SOT
  prefix and the padding.

The token encoders are host code, copied. With ``cache_mels`` the first
epoch's mels are kept in float16 on the host, and later epochs return
those rounded values, as the JAX dataset does.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.whisper.config import WhisperDims
from ..models.whisper.tokenizer import WhisperTokenizer
from .whisper_train import IGNORE_INDEX

logger = logging.getLogger(__name__)

__all__ = ["TranscriptDataset", "encode_example", "encode_longform_example"]

_SR = 16000
_WINDOW = 30 * _SR


def encode_example(
    tokenizer: WhisperTokenizer,
    text: str,
    language: str = "en",
    task: str = "transcribe",
    max_len: int = 448,
    timestamps: bool = False,
    duration: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Transcript -> (tokens [S], targets [S]) for teacher forcing.

    With ``timestamps``, the transcript is wrapped as one
    ``<|0.00|> text <|duration|>`` segment, the grammar the decoder
    enforces."""
    sot = tokenizer.sot_sequence(language, task, timestamps=timestamps)
    text_ids = tokenizer.encode(" " + text.strip())
    if timestamps:
        t_end = float(np.clip(duration if duration is not None else 30.0, 0.02, 30.0))
        body = (
            [tokenizer.timestamp_begin]
            + text_ids
            + [tokenizer.timestamp_begin + int(round(t_end / 0.02))]
        )
    else:
        body = text_ids
    full = (sot + body + [tokenizer.eot])[:max_len + 1]

    tokens = np.asarray(full[:-1], dtype=np.int32)
    targets = np.asarray(full[1:], dtype=np.int32)
    # no training on predicting the SOT prefix itself
    targets[: len(sot) - 1] = IGNORE_INDEX
    return tokens, targets


def encode_longform_example(
    tokenizer: WhisperTokenizer,
    segments: List[dict],
    language: str = "en",
    task: str = "transcribe",
    max_len: int = 448,
    tail_start: Optional[float] = None,
    prompt: str = "",
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-segment 30 s window -> (tokens, targets), Whisper's long-form
    grammar: ``<|a_i|> text_i <|b_i|>`` per segment completed inside the
    window; a bare start timestamp for a segment straddling the window's
    end; an optional ``[sot_prev] + prompt`` prefix, masked from the loss
    with the SOT sequence."""
    prefix: List[int] = []
    if prompt:
        prefix = [tokenizer.sot_prev] + tokenizer.encode(" " + prompt.strip())
    sot = tokenizer.sot_sequence(language, task, timestamps=True)
    ts0 = tokenizer.timestamp_begin

    def ts(seconds: float) -> int:
        return ts0 + int(round(min(max(float(seconds), 0.0), 30.0) / 0.02))

    def build(segs: List[dict], tail: Optional[float]) -> List[int]:
        body: List[int] = []
        for seg in segs:
            body += [ts(seg["start"])]
            body += tokenizer.encode(" " + str(seg["text"]).strip())
            body += [ts(seg["end"])]
        if tail is not None:
            body.append(ts(tail))
        return body

    # Keep EOT in the sequence: when the example overflows max_len, drop the
    # prompt first, then turn trailing complete segments into a start-only
    # tail until it fits.
    segs, tail = list(segments), tail_start
    body = build(segs, tail)
    while len(prefix) + len(sot) + len(body) + 1 > max_len + 1:
        if prefix:
            prefix = []
        elif segs:
            tail = float(segs[-1]["start"])
            segs = segs[:-1]
        else:
            break
        body = build(segs, tail)
    full = (prefix + sot + body + [tokenizer.eot])[: max_len + 1]

    tokens = np.asarray(full[:-1], dtype=np.int32)
    targets = np.asarray(full[1:], dtype=np.int32)
    targets[: len(prefix) + len(sot) - 1] = IGNORE_INDEX
    return tokens, targets


@dataclass
class TranscriptDataset:
    """Batched iterator over (audio, transcript) pairs."""

    examples: List[Tuple[str, str, Optional[float]]]  # (wav_path, text, duration_s)
    tokenizer: WhisperTokenizer
    dims: WhisperDims
    language: str = "en"
    batch_size: int = 8
    seq_len: int = 224
    shuffle_seed: Optional[int] = 0
    timestamps: bool = False  # wrap transcripts in the timestamp grammar
    # raw manifest rows (parallel to ``examples``): rows with a "segments"
    # list encode through the long-form grammar
    rows: Optional[List[dict]] = None
    # keep every example's mel (float16, host) from the first epoch on
    cache_mels: bool = False
    device: Optional[str] = None  # where log_mel runs (None: CUDA)

    def __post_init__(self):
        from ..utils import resolve_device

        self.device = resolve_device(self.device)
        self._mel_cache: Optional[np.ndarray] = None
        self._mel_done: Optional[np.ndarray] = None

    @classmethod
    def from_manifest(cls, path: str, tokenizer, dims, **kw) -> "TranscriptDataset":
        examples, rows = [], []
        with open(path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                examples.append((row["audio"], row["text"], row.get("duration")))
                rows.append(row)
        logger.info("Manifest %s: %d examples", path, len(examples))
        if not any("segments" in r for r in rows):
            rows = None  # a plain single-sentence manifest
        return cls(examples=examples, tokenizer=tokenizer, dims=dims, rows=rows, **kw)

    def __len__(self) -> int:
        return (len(self.examples) + self.batch_size - 1) // self.batch_size

    def _load_audio(self, path: str) -> np.ndarray:
        from ..audio_io import read_wav, resample_poly

        audio, sr = read_wav(path)
        if sr != _SR:
            audio = resample_poly(audio, sr, _SR)
        out = np.zeros(_WINDOW, dtype=np.float32)
        n = min(len(audio), _WINDOW)
        out[:n] = audio[:n]
        return out

    def _mel_for(self, idx: np.ndarray) -> np.ndarray:
        """Mel for the example indices [bs] (cached after the first epoch)."""
        from ..ops.mel import log_mel

        if self.cache_mels and self._mel_cache is None:
            self._mel_cache = np.zeros(
                (len(self.examples), self.dims.n_mels, _WINDOW // 160), dtype=np.float16)
            self._mel_done = np.zeros(len(self.examples), dtype=bool)
        if self._mel_cache is not None and bool(self._mel_done[idx].all()):
            return self._mel_cache[idx].astype(np.float32)

        audio = np.zeros((len(idx), _WINDOW), dtype=np.float32)
        for j, k in enumerate(idx):
            audio[j] = self._load_audio(self.examples[k][0])
        x = torch.from_numpy(audio).to(self.device)
        mel = log_mel(x, n_mels=self.dims.n_mels).cpu().numpy()
        if self._mel_cache is not None:
            self._mel_cache[idx] = mel.astype(np.float16)
            self._mel_done[idx] = True
        return mel

    def batches(self, epoch: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (mel, tokens, targets) host arrays of fixed shapes."""
        order = np.arange(len(self.examples))
        if self.shuffle_seed is not None:
            np.random.default_rng(self.shuffle_seed + epoch).shuffle(order)

        bs, s = self.batch_size, self.seq_len
        for i in range(0, len(order), bs):
            idx = order[i : i + bs]
            tokens = np.full((bs, s), self.tokenizer.eot, dtype=np.int32)
            targets = np.full((bs, s), IGNORE_INDEX, dtype=np.int32)

            for j, k in enumerate(idx):
                _path, text, duration = self.examples[k]
                row = self.rows[k] if self.rows is not None else {}
                if "segments" in row:
                    t, y = encode_longform_example(
                        self.tokenizer, row["segments"],
                        language=self.language, max_len=s,
                        tail_start=row.get("tail_start"),
                        prompt=row.get("prompt", ""),
                    )
                else:
                    t, y = encode_example(
                        self.tokenizer, text, language=self.language,
                        max_len=s, timestamps=self.timestamps,
                        duration=duration,
                    )
                n = min(len(t), s)
                tokens[j, :n] = t[:n]
                targets[j, :n] = y[:n]

            if len(idx) < bs:  # fixed shapes: pad rows carry IGNORE targets
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - len(idx))])
            mel = self._mel_for(idx)
            yield mel, tokens, targets
