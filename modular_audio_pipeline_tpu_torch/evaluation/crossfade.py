"""The serving path's hard cuts against crossfaded silence removal, in WER.

The port of the JAX package's ``tools/eval_crossfade.py``. The
stage-by-stage preprocessor crossfades 20 ms at every silence cut; the
serving path's device gather cuts hard on a 1 ms grid. This harness
synthesises long-form held-out streams with real pauses
(``longform.make_stream`` on ``default_rng(910_000)``), strips silence
two ways from the same detected ranges, 20 ms linear crossfades and hard
cuts, decodes both through the batched beam path on the shipped proxy
bundle and reports the paired WERs.

On the CPU (``--device cpu``) it decodes in f32 as the JAX tool does; on
the card (the default) in bf16 through the kernels::

    python -m modular_audio_pipeline_tpu_torch.evaluation.crossfade --minutes 2 --streams 3

prints one JSON line: ``minutes``, ``streams``, ``beam``, the mean
``crossfade_20ms`` and ``hard_cut`` WERs and ``max_abs_delta``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

from ..ops.silence import _FULL_SCALE, _crossfade_concat, detect_nonsilent_ranges
from ..training.synth_asr import SR
from .longform import make_stream, transcriber
from .metrics import wer
from .paired import BUNDLE

logger = logging.getLogger(__name__)

__all__ = ["SEED_CROSSFADE", "strip_silence", "evaluate", "main"]

SEED_CROSSFADE = 910_000


def strip_silence(x: np.ndarray, sr: int, crossfade_ms: int) -> np.ndarray:
    """``remove_silence``'s chunks (250 ms minimum silence, 40 dB under the
    clip's level, 100 ms kept each side) joined with ``crossfade_ms``
    crossfades."""
    spms = sr // 1000
    seg_len_ms = len(x) // spms
    sq = np.square(x.astype(np.float64) * _FULL_SCALE)
    mean_sq = sq.mean() if len(sq) else 0.0
    clip_dbfs = 10.0 * np.log10(mean_sq / _FULL_SCALE**2) if mean_sq > 0 else -np.inf
    ranges = detect_nonsilent_ranges(x, sr, 250, clip_dbfs - 40.0)
    if not ranges:
        return x
    chunks, xfs = [], []
    for i, (start_ms, end_ms) in enumerate(ranges):
        s = max(0, start_ms - 100)
        e = min(seg_len_ms, end_ms + 100)
        chunks.append(x[s * spms:e * spms])
        if i:
            xfs.append(crossfade_ms)
    return _crossfade_concat(chunks, xfs, sr)


def evaluate(minutes: float = 2.0, streams: int = 3, beam: int = 5, device=None) -> dict:
    rng = np.random.default_rng(SEED_CROSSFADE)
    tr = transcriber(str(BUNDLE), "tiny", beam, 224, device)
    rows = []
    for i in range(streams):
        audio, text, _starts = make_stream(minutes, rng)
        pair = {}
        for name, xf in (("crossfade_20ms", 20), ("hard_cut", 0)):
            out = tr._backend.transcribe_array(strip_silence(audio, SR, xf), SR)
            pair[name] = wer(text, out.get("text", ""))["wer"]
        rows.append(pair)
        logger.info("stream %d: crossfade=%.4f hard=%.4f", i, pair["crossfade_20ms"],
                    pair["hard_cut"])
    agg = {k: round(float(np.mean([r[k] for r in rows])), 4) for k in rows[0]}
    agg["max_abs_delta"] = round(max(abs(r["crossfade_20ms"] - r["hard_cut"]) for r in rows), 4)
    return {"minutes": minutes, "streams": streams, "beam": beam, **agg}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--minutes", type=float, default=2.0)
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(evaluate(args.minutes, args.streams, args.beam, args.device)))
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    sys.exit(main())
