"""Decode quality on the card against the CPU, sentence by sentence.

The port of the JAX package's ``tools/eval_tpu_paired.py``. Each held-out
sentence of the synthetic ASR proxy (``default_rng(500_000)``, the stream
``training/synth_asr`` evaluates on) goes through production beam 5 on
the shipped ``whisper-tiny-synth-proxy`` bundle, loaded by
``WhisperTranscriber``, twice:

- on the CPU in f32, where the kernels' wrappers take their plain
  versions (the JAX tool's CPU reference);
- on the card in bf16 through the hand-written kernels (the JAX tool's
  accelerator decode with the ancestry kernel).

The output carries each side's aggregate WER and the per-sentence paired
deltas, so systematic drift separates from beam near-ties. One process
does both, since torch holds both devices. The JAX tool's third mode, the
physical cache reorder, has no counterpart: the port's beam search has
only the ancestry route.

    python -m modular_audio_pipeline_tpu_torch.evaluation.paired [--weights DIR] [--limit N]

prints one JSON line: ``aggregate_wer`` ({"cpu", "card"}), ``n_sentences``,
``card_minus_cpu`` (``mean``, ``n_worse``, ``n_better``, ``n_equal``,
``max_abs``, ``per_sentence``), ``per_sentence_wer`` and ``decode_s`` by
device.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models.whisper.decode import DecodeOptions, decode_windows
from ..ops.mel import log_mel
from ..training.synth_asr import SR, VOCAB, synth_sentence
from ..transcriber import WhisperTranscriber
from ..utils import SHIPPED_WEIGHTS, resolve_device
from .metrics import wer

logger = logging.getLogger(__name__)

__all__ = ["BUNDLE", "HELD_OUT_SEED", "build_eval_set", "decode_all", "paired_deltas", "evaluate",
           "main"]

BUNDLE = SHIPPED_WEIGHTS / "whisper-tiny-synth-proxy"
HELD_OUT_SEED = 500_000  # the held-out eval stream (training draws from seed 0)
_BATCH = 8


def build_eval_set(n: int) -> Tuple[List[Tuple[str, np.ndarray]], int]:
    """The first ``n`` held-out sentences: [(text, audio)], sample rate."""
    rng = np.random.default_rng(HELD_OUT_SEED)
    out = []
    for _ in range(n):
        k = int(rng.integers(12, 27))
        words = rng.integers(0, len(VOCAB), size=k)
        out.append((" ".join(VOCAB[w] for w in words), synth_sentence(list(words), rng)))
    return out, SR


def decode_all(weights: str, device, limit: int, data=None) -> Tuple[List[str], List[str]]:
    """Reference texts and beam-5 hypotheses of the first ``limit``
    held-out sentences on ``device`` (f32 on the CPU, bf16 on the card),
    decoded 8 windows at a time with the JAX tool's options (128 tokens,
    timestamps, int8 KV cache)."""
    device = resolve_device(device)
    data, sr = data if data is not None else build_eval_set(limit)
    tr = WhisperTranscriber("tiny", language="en", beam_size=5, weights_path=str(weights),
                            word_timestamps=False, max_decode_tokens=128, device=str(device))
    backend = tr._backend
    backend.compute_dtype = "float32" if device.type == "cpu" else "bfloat16"
    backend.load()
    tok = backend.tokenizer
    opts = DecodeOptions(language="en", beam_size=5, max_tokens=128, timestamps=True,
                         kv_int8=True)
    win = 30 * sr
    texts = []
    for i in range(0, len(data), _BATCH):
        batch = data[i:i + _BATCH]
        wins = np.zeros((len(batch), win), np.float32)
        for j, (_t, wav) in enumerate(batch):
            wins[j, :min(len(wav), win)] = wav[:win]
        mel = log_mel(torch.from_numpy(wins).to(device), n_mels=backend.dims.n_mels)
        res = decode_windows(backend.params, backend.dims, tok, mel, opts)
        for j in range(len(batch)):
            toks = [int(t) for t in res.tokens[j]
                    if int(t) < tok.timestamp_begin and int(t) != tok.eot]
            texts.append(tok.decode(toks).strip())
    return [t for t, _ in data], texts


def paired_deltas(per: Sequence[float], ref: Sequence[float]) -> dict:
    """Per-sentence WER deltas ``per - ref`` and their summary, with the
    JAX tool's keys and rounding."""
    deltas = [round(a - c, 4) for a, c in zip(per, ref)]
    return {
        "mean": round(float(np.mean(deltas)), 4),
        "n_worse": int(sum(d > 0 for d in deltas)),
        "n_better": int(sum(d < 0 for d in deltas)),
        "n_equal": int(sum(d == 0 for d in deltas)),
        "max_abs": round(float(np.max(np.abs(deltas))), 4),
        "per_sentence": deltas,
    }


def evaluate(weights: str = str(BUNDLE), limit: int = 48, devices=("cpu", "cuda")) -> dict:
    """The paired evaluation over ``devices`` (the first is the reference):
    ``aggregate_wer`` by device, ``n_sentences``, and for each other device
    ``<device>_minus_<reference>``, the per-sentence WERs and the decode
    seconds by device."""
    data = build_eval_set(limit)
    hyps, refs, seconds = {}, None, {}
    name = {"cpu": "cpu", "cuda": "card"}
    for dev in devices:
        logger.info("decoding %d sentences on %s", limit, dev)
        t0 = time.perf_counter()
        refs, hyps[dev] = decode_all(weights, dev, limit, data)
        seconds[name.get(dev, dev)] = round(time.perf_counter() - t0, 3)
    per = {name.get(d, d): [wer(r, h)["wer"] for r, h in zip(refs, hyps[d])] for d in devices}
    weights_by_len = [len(r.split()) for r in refs]
    out = {"aggregate_wer": {m: round(float(np.average(v, weights=weights_by_len)), 4)
                             for m, v in per.items()},
           "n_sentences": len(refs)}
    base = name.get(devices[0], devices[0])
    for m in list(per)[1:]:
        out[f"{m}_minus_{base}"] = paired_deltas(per[m], per[base])
    out["per_sentence_wer"] = per
    out["decode_s"] = seconds
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--weights", default=str(BUNDLE))
    ap.add_argument("--limit", type=int, default=48)
    ap.add_argument("--devices", default="cpu,cuda",
                    help="comma-separated torch devices, the reference first")
    args = ap.parse_args(argv)
    print(json.dumps(evaluate(args.weights, args.limit, tuple(args.devices.split(",")))))
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    sys.exit(main())
