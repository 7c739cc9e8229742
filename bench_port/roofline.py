"""The yardstick's arithmetic: the card's peaks, each kernel's least time
from its operations and bytes, and the model FLOPs of a request or a step.

The kernel bounds are copied from the port's kernel table (``PERF.md``,
rows 1, 1t and 2; ``kernel_times.py`` and ``chip_smoke.py`` compute them
the same way), so that a later change to the program cannot move them.
A bound is the larger of operations over the peak for their type, bytes
over the memory bandwidth and, for the flash kernel, its exponentials
over the special-function units; each input byte is counted once as read
and each output byte once as written.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA's data sheet of the H100 SXM (dense, at the full 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # the CUDA cores: TF32 would change the configured arithmetic
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
SMS = 132
SFU_EXP_PER_CLOCK = 16  # exponentials per clock per SM
MAX_SM_CLOCK_HZ = 1.98e9
EXP_RATE = SMS * SFU_EXP_PER_CLOCK * MAX_SM_CLOCK_HZ

_PEAKS = {"bfloat16": PEAK_BF16_FLOPS, "float16": PEAK_BF16_FLOPS, "float32": PEAK_F32_FLOPS}
_SIZES = {"bfloat16": 2, "float16": 2, "float32": 4}


def flash_bound_s(shape: Tuple[int, int, int, int], dtype: str) -> Tuple[float, str]:
    """Least seconds of one self-attention launch over ``[B, H, N, hd]``:
    QK and PV (4 B H N^2 hd operations), B H N^2 exponentials, q, k, v read
    and o written once. Returns (seconds, what bounds it)."""
    b, h, n, hd = shape
    t = {
        "operations": 4.0 * b * h * n * n * hd / _PEAKS[dtype],
        "exponentials": float(b * h * n * n) / EXP_RATE,
        "bytes": 4.0 * b * h * n * hd * _SIZES[dtype] / PEAK_BYTES,
    }
    what = max(t, key=t.get)
    return t[what], what


def ancestry_bytes(q_shape: Tuple[int, ...], q_itemsize: int, selected_rows: int, hd: int,
                   cache_itemsize: int, scales: bool, anc_numel: int, mask_numel: int) -> int:
    """Bytes one ancestry-attention launch must move: q read and y written
    once, and of its layer only the K and V rows (with their scales) that
    some hypothesis selects at the live positions, the ancestor table and
    the mask row. ``selected_rows`` counts distinct (beam row, position)
    pairs over windows and positions; a row holds every head."""
    numel_q = 1
    for s in q_shape:
        numel_q *= s
    heads = q_shape[1]
    row = heads * hd * cache_itemsize + (heads * 4 if scales else 0)
    return 2 * numel_q * q_itemsize + 2 * selected_rows * row + anc_numel * 4 + mask_numel * 4


def ancestry_bound_s(n_bytes: float) -> float:
    return n_bytes / PEAK_BYTES


def _enc_flops(d: int, n_mels: int, layers: int, frames: int = 3000) -> float:
    """One 30 s window through the encoder (multiply-adds count 2)."""
    t = frames // 2
    conv = 2.0 * frames * n_mels * 3 * d + 2.0 * t * d * 3 * d
    per_layer = 2.0 * t * (4 * d * d + 8 * d * d) + 4.0 * t * t * d
    return conv + layers * per_layer


def _dec_token_flops(d: int, layers: int, ctx: int, audio: int = 1500) -> float:
    """One decoder position over ``ctx`` cached positions, without the
    logits: self Q/K/V/O, cross Q/O, the MLP and both attentions."""
    per_layer = 2.0 * (4 * d * d + 2 * d * d + 8 * d * d) + 4.0 * ctx * d + 4.0 * audio * d
    return layers * per_layer


def _cross_kv_flops(d: int, layers: int, audio: int = 1500) -> float:
    return layers * 2.0 * 2 * audio * d * d


def serve_request_flops(dims: Dict[str, int], windows: int, beam: int, prefix: int,
                        steps: int, aligned_tokens: Iterable[int]) -> float:
    """Model FLOPs of one request: the encoder and the cross K/V over the
    kept windows, the beam decode (``beam`` rows a window, each step at its
    context, with the vocabulary product), and the word-alignment pass
    (teacher-forced, no logits) over each aligned window's tokens."""
    d, v = dims["d_model"], dims["vocab_size"]
    enc_l, dec_l, n_mels = dims["encoder_layers"], dims["decoder_layers"], dims["num_mel_bins"]
    total = windows * (_enc_flops(d, n_mels, enc_l) + _cross_kv_flops(d, dec_l))
    logits = 2.0 * d * v
    prompt = sum(_dec_token_flops(d, dec_l, p + 1) for p in range(prefix)) + logits
    decode = sum(_dec_token_flops(d, dec_l, prefix + i + 1) + logits for i in range(steps))
    total += windows * beam * (prompt + decode)
    for n in aligned_tokens:
        total += sum(_dec_token_flops(d, dec_l, p + 1) for p in range(prefix + n))
    return total


def train_sample_flops(dims: Dict[str, int], seq: int) -> float:
    """Three times one sample's forward FLOPs: encoder, cross K/V,
    teacher-forced decoder over ``seq`` positions and the logits."""
    d, v = dims["d_model"], dims["vocab_size"]
    enc_l, dec_l, n_mels = dims["encoder_layers"], dims["decoder_layers"], dims["num_mel_bins"]
    fwd = _enc_flops(d, n_mels, enc_l) + _cross_kv_flops(d, dec_l)
    fwd += sum(_dec_token_flops(d, dec_l, p + 1) for p in range(seq)) + seq * 2.0 * d * v
    return 3.0 * fwd
