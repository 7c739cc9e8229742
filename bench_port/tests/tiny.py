"""A cell of ``BENCHMARK.json`` cut to what a CPU test can hold: the port's
``test-tiny`` Whisper (its widths, its 51,865-token vocabulary and that
vocabulary's special tokens), a short recording, few decode steps and
small batches. Everything else (the traffic kind, the stages, the
checks, the cell's limits) is the cell's own."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import spec  # noqa: E402

TINY = {"d_model": 64, "encoder_layers": 2, "decoder_layers": 2, "encoder_attention_heads": 2,
        "decoder_attention_heads": 2, "encoder_ffn_dim": 256, "decoder_ffn_dim": 256,
        "num_mel_bins": 80, "vocab_size": 51865, "port_model": "test-tiny",
        "special_tokens": {"sot_sequence": [50258, 50259, 50359], "eot": 50257,
                           "no_timestamps": 50363, "timestamp_begin": 50364,
                           "no_speech": 50362}}


def cell(workload: str, seconds: float = 75.0, windows: int = 3) -> dict:
    c = copy.deepcopy(spec.cell(workload, spec.benchmark()))
    c["config"].update(copy.deepcopy(TINY))
    t = c["traffic"]
    if t["kind"] == "serve_closed_loop":
        t["generator"].update({"seconds": seconds, "pool": 2})
        t["decode"].update({"max_tokens": 24, "batch_size": 4})
        t["expect"] = {"windows": windows, "rows": 4, "decode_steps": 24,
                       "kept_s": [30.0 * (windows - 1), 30.0 * windows]}
    else:
        t["generator"].update({"batch": 2, "batches": 4, "seq_len": 32, "text_tokens": [10, 20]})
    return c
