"""Long-form WER of the proxy through both production window paths.

The port of the JAX package's ``tools/eval_longform.py``. It synthesises
multi-minute streams of held-out tone-language sentences (the generator
of ``training/synth_asr``, on the disjoint stream ``SEED_STREAM``), writes
each as a WAV, and transcribes it with ``WhisperTranscriber`` on the
shipped ``whisper-tiny-synth-proxy`` bundle through the batched fixed
windows (the serving default) and through ``chunking="sequential"`` (the
seek loop: seek advanced by the last timestamp, conditioned on the
previous text, the temperature ladder armed). It reports each path's WER
and whether segment starts never go back in time across windows.

On the CPU (``--device cpu``) it decodes in f32 as the JAX tool does; on
the card (the default) in bf16 through the kernels::

    python -m modular_audio_pipeline_tpu_torch.evaluation.longform --minutes 2.5 --streams 3

prints one JSON line: ``minutes``, ``streams``, ``beam`` and, per path,
``{"wer", "ref_words", "monotonic", "wall_s", "segments"}``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from ..audio_io import write_wav
from ..training.synth_asr import SR, VOCAB, synth_sentence
from ..transcriber import WhisperTranscriber
from ..utils import resolve_device
from .metrics import wer
from .paired import BUNDLE

logger = logging.getLogger(__name__)

__all__ = ["SEED_STREAM", "make_stream", "monotonic", "transcriber", "evaluate", "main"]

SEED_STREAM = 900_000  # disjoint from training (0) and the single-sentence eval (500k)


def make_stream(minutes: float, rng: np.random.Generator, min_words: int = 12,
                max_words: int = 26) -> Tuple[np.ndarray, str, List[float]]:
    """Held-out sentences with pauses of 0.4-0.9 s until ``minutes`` are
    reached -> (audio, truth text, sentence starts in seconds)."""
    target = minutes * 60.0 * SR
    parts, words_all, starts = [], [], []
    pos = 0
    while pos < target:
        k = int(rng.integers(min_words, max_words + 1))
        words = rng.integers(0, len(VOCAB), size=k)
        sent = synth_sentence(list(words), rng)
        pause = np.zeros(int(rng.uniform(0.4, 0.9) * SR), np.float32)
        starts.append(pos / SR)
        parts.extend([sent, pause])
        words_all.extend(VOCAB[w] for w in words)
        pos += len(sent) + len(pause)
    return np.concatenate(parts), " ".join(words_all), starts


def monotonic(segments: Sequence[dict]) -> bool:
    """No segment starts before the one ahead of it."""
    return all(b["start"] >= a["start"] - 1e-6 for a, b in zip(segments, segments[1:]))


def transcriber(weights: str, model: str, beam: int, max_tokens: int, device,
                chunking: str = "batched"):
    """The proxy's ``WhisperTranscriber`` as the JAX tools set it up: words
    off, f32 on the CPU (bf16 on the card); the seek loop's budget capped
    at 216 tokens so its prompt and budget fit the 448-token context."""
    device = resolve_device(device)
    tr = WhisperTranscriber(model_name=model, language="en", beam_size=beam,
                            weights_path=str(weights), word_timestamps=False,
                            max_decode_tokens=max_tokens, device=str(device))
    tr._backend.chunking = chunking
    tr._backend.compute_dtype = "float32" if device.type == "cpu" else "bfloat16"
    if chunking == "sequential":
        tr._backend.max_decode_tokens = min(max_tokens, 216)
    return tr


def evaluate(minutes: float = 2.5, streams: int = 3, paths=("batched", "sequential"),
             beam: int = 5, weights: str = str(BUNDLE), model: str = "tiny", min_words: int = 8,
             max_words: int = 20, max_tokens: int = 440, device=None) -> dict:
    rng = np.random.default_rng(SEED_STREAM)
    data = [make_stream(minutes, rng, min_words, max_words) for _ in range(streams)]
    results = {}
    with tempfile.TemporaryDirectory(prefix="longform_") as tmp:
        files = []
        for i, (audio, _text, _st) in enumerate(data):
            p = f"{tmp}/stream_{i}.wav"
            write_wav(p, audio, SR)
            files.append(p)
        for mode in paths:
            tr = transcriber(weights, model, beam, max_tokens, device, mode)
            total_w, total_e, mono, n_segs = 0, 0.0, True, 0
            t0 = time.perf_counter()
            for p, (audio, text, _st) in zip(files, data):
                out = tr.transcribe(p)
                m = wer(text, out.get("text", ""))
                total_w += m["ref_words"]
                total_e += m["wer"] * m["ref_words"]
                segs = out["segments"]
                mono = mono and monotonic(segs)
                n_segs += len(segs)
                logger.info("[%s] %s: wer=%.3f segs=%d last_end=%.1fs dur=%.1fs", mode,
                            Path(p).name, m["wer"], len(segs),
                            max((s["end"] for s in segs), default=0.0), len(audio) / SR)
            results[mode] = {"wer": round(total_e / max(total_w, 1), 4), "ref_words": total_w,
                             "monotonic": mono, "wall_s": round(time.perf_counter() - t0, 1),
                             "segments": n_segs}
    return {"minutes": minutes, "streams": streams, "beam": beam, **results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--minutes", type=float, default=2.5)
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--paths", default="batched,sequential")
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--weights", default=str(BUNDLE))
    ap.add_argument("--model", default="tiny", help="whisper dims of the proxy under test")
    ap.add_argument("--min-words", type=int, default=8)
    ap.add_argument("--max-words", type=int, default=20,
                    help="sentence lengths; the default matches the long-form training crops")
    ap.add_argument("--max-tokens", type=int, default=440,
                    help="decode budget; byte tokens need ~7 a word, so a full 30 s window "
                    "of tone-words runs past 224")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(evaluate(args.minutes, args.streams, tuple(args.paths.split(",")),
                              args.beam, args.weights, args.model, args.min_words,
                              args.max_words, args.max_tokens, args.device)))
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    sys.exit(main())
