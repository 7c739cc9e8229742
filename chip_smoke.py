#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. The card's name and power limit; the build of every CUDA kernel from
   ``modular_audio_pipeline_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together), timed.
2. The flash-attention kernel against its plain PyTorch version at the
   large-v3-turbo encoder shape [16, 20, 1500, 64] bf16, at bf16 sequence
   lengths of 1, 129, 300 and 1501 (ragged tiles; the whole tensor is
   compared, so a tail tile that spilt into the next head would show), at
   head dim 32 and in f32, each run twice for equal bits; with the kernel's,
   the plain version's and ``scaled_dot_product_attention``'s times (the
   latter only as a yardstick; the port never calls it) beside its three
   bounds (tensor-core operations, exponentials, bytes). Then the kernel's
   CUDA-core route in f32: at the edges of its 128-query tile ([1, 3, 127,
   32], [1, 3, 129, 64]), and at head dim 32 where SegmentationNet calls it,
   [32, 4, 1000, 32] and a ragged [2, 4, 1001, 32], within ``FLASH_TOL_F32``
   with equal bits twice, and timed at a 512-window chunk [512, 4, 1000,
   32] beside the plain version and ``scaled_dot_product_attention`` in
   f32, against a bound from the f32 CUDA-core peak.
3. The ancestry-attention kernel against its plain version at the decode
   shape (16 windows x 5 beams, 20 heads, ctx 448, hd 64), int8 and bf16
   caches, with this step's rows written at the last position: the output
   and the written cache are compared, two runs must give equal bits, and
   the kernel is timed on the device (CUDA-graph replays) and eagerly with
   its wrapper, at the 448 bucket and at a 64 bucket, with beams that pick
   rows at random and with beams that share their ancestry up to the last
   three positions, as real decoding does.
3b. The weight-only int8 product kernel against its plain version at the
   decode step's shapes (M = 80 rows; K x N of 1280 x 1280, 1280 x 5120,
   5120 x 1280 and the logits head 1280 x 51968), at the cross K/V shape
   (M = 24000, 1280 x 1280) and at a ragged shape (3 x 64 x 200), in the
   head's form (f32 out) and in ``_proj``'s (bf16 out, bias fused), each
   twice for equal bits and one launch per product, within a tolerance
   that two lower-precision controls are shown to fail; at 80-row shapes
   that make the plan split K over each cluster size 1-8, against the
   plain version and the emulation of the split; with the
   kernel's time, its eager time, the plain version's and, as a yardstick
   the port never calls, ``torch.matmul``'s in bf16 on a weight dequantised
   beforehand, beside the bound (one ``int8_matmul_shapes`` line).
4. End to end: ``WhisperTranscriber("large-v3-turbo", weights_path="random:0",
   beam_size=5, max_decode_tokens=224, device="cuda")`` with the no-speech
   gate off transcribes 8 minutes of voiced audio (16 windows, one batch),
   after one warm-up run. The kernels' launch counts are reset just before
   and read just after; the flash and ancestry kernels' must be non-zero.
4b. The same file through ``WhisperTranscriber.from_config`` with
   ``compute_type="int8"`` and ``word_timestamps=True``: all three kernels
   must launch, the int8 product at least 33 times per decode step, and
   segments carry words inside the file. The seconds of the
   word-alignment pass and the M of every int8 product are logged; under
   the profiler the int8 kernels' device launches must equal the
   wrapper's calls (one launch per product, no reduction kernel).
5. The shipped ``whisper-tiny-synth-proxy`` bundle transcribes two held-out
   synthetic sentences on the card, once through the kernels and once with
   the model's kernel calls bound to the plain versions; the agreement
   is printed and the kernel path must yield segments. Then, on the same
   bundle: the int8 decoder through its kernel against its plain version,
   word timestamps inside their segments, the temperature ladder walked to
   its last rung twice with equal results, and language detection.
6. The serving path, the main path: ``ServingPipeline.process`` at
   bench.py's configuration (large-v3-turbo, random weights, beam 5, 224
   tokens, batch 16, int8 KV cache, DTW words, no-speech gate off, the
   default denoise, shipped ConvVAD and diarization bundles) on the
   8-minute file as int16, one warm-up and one timed run (launch counts
   reset just before and read just after), then one profiled run. It
   fails unless the VAD is the ConvVAD and the diarizer holds ConvEmbedder
   + SegmentationNet, there are segments and turns, the decode covered
   ceil(kept / 30 s) windows, the mappings are monotone and inside the
   file, the flash kernel launched more often than the encoder alone
   would (segmentation ran it) and the ancestry kernel launched. Then
   ``run_file``'s JSON (the merged segments' keys), the proxy bundle's
   sentences in one file through the kernels and through the plain
   versions (equal keep intervals and turns, segments as in phase 5,
   ``original_start``/``original_end`` with merging off), and the ConvVAD
   and ConvEmbedder on the card against the CPU.
7. Bench config 4 of the JAX package (``tools/bench_configs.py``): the
   serving path with auto-detected vocal separation at full width and
   depth, large-v3 (32 encoder and 32 decoder layers), random weights,
   beam 5, 224 tokens, batch 8, DTW words, no-speech gate off, diarization
   off, otherwise the defaults, on bench config 4's 8-minute podcast (four
   synthetic voices under a repeating music loop), as int16. One warm-up and one timed ``process``
   (launch counts reset just before and read just after, the card's
   utilization sampled by ``nvidia-smi`` beside it), then ``run_file``. It
   fails unless auto-detect chose separation and the MaskUNet ran on the
   device (the host backend never resolved), there are segments, the
   decode covered ceil(kept / 30 s) windows, the mappings are monotone and
   inside the file, the flash kernel launched at least 32 times per batch
   and the ancestry kernel 32 times per decode step. Then, card against
   CPU: the MaskUNet stem of a 9 s clip, REPET's period and stems on 12 s,
   a random Silero VAD's probabilities over 60 s in three sections with
   the LSTM state carried, and the StatsEmbedder's turns without an embedding
   bundle; the MaskUNet's device time per 5-minute chunk beside its
   reckoned f32 operations; and the flash kernel at the large-v3 encoder
   shape [8, 20, 1500, 64] bf16, timed beside its bound.
8. Bench config 5 of the JAX package (a batch directory run with
   checkpoint/resume) cut to one card: three 4-minute files of four-voice
   speech from the port's voice model (a 16 kHz WAV, a 44.1 kHz stereo
   WAV, a FLAC encoded by ``tests/flac_ref.py``), large-v3-turbo at full
   width and depth with random weights, beam 5, 224 tokens, the int8 KV
   cache, the no-speech gate off, the ``PipelineConfig`` defaults
   otherwise (faster-whisper, denoise, the ConvVAD, diarization, words,
   redundancy removal, merging). First ``BatchDriver.run()`` in this
   process, ``AudioPipeline`` per file: each file's stage timings, wall
   time, realtime factor, kept seconds and VAD cut (device or host) are
   printed; the flash and ancestry kernels must launch (counts reset just
   before, read just after) and the native library must have loaded.
   Then ``python -m modular_audio_pipeline_tpu_torch --batch --serving``
   in a subprocess, as bench_batch.py drives main.py: SIGINT once the
   first ledger entry lands must exit 130, the rerun must skip the
   finished files and succeed on every file, and every output JSON must
   have the schema's keys. Last, the proxy bundle's file through
   ``AudioPipeline`` with the kernels and with the plain versions: equal
   segments and JSON.

9. The seek loop and the LM tier (on 60 s of phase 8's first voiced file):
   ``WhisperTranscriber(chunking="sequential")`` at large-v3-turbo, random
   weights, beam 5, 224 tokens, int8 KV cache, no-speech gate off; each
   window's seconds, prefix length and highest decode position are
   logged, and positions past 447 must be reached (the prompt is padded to
   223 tokens after the first window); the flash and ancestry kernels must
   launch (counts reset just before, read just after). A
   ``StreamingSession`` over the same audio in 7 s chunks must give the
   same segments. The proxy bundle's sentences sequentially, with the
   kernels and with the plain versions: equal segments. The flash kernel
   at the seek encoder's [1, 20, 1500, 64] and the ancestry kernel at one
   window (BK 5, ctx 448, int8) against their plain versions, timed beside
   their bounds and ``scaled_dot_product_attention``; a row past the
   context must land on position 447 with a guard layer untouched. Then
   ``LlamaLM`` at tinyllama-1.1b with random bf16 weights from a seeded
   generator on the card: a 1,536-token prompt and 256 greedy tokens twice
   (equal), the incremental logits within ``LM_TOL`` of the teacher-forced
   forward, prefill and per-token times beside the weight bytes per token
   over the memory rate, and test-small in f32 card against CPU. Last,
   ``AudioPipeline`` at phase 8's configuration with ``llm.enabled`` (the
   heuristic tier) and sequential chunking, then batched chunking, and
   ``compare_transcriptions`` between the two JSONs.
10. The training path. (a) Large-v3-turbo fine-tuning at full width and
   depth, f32, random weights from seed 0, through
   ``training.train.setup`` at its defaults (AdamW lr 1e-5, weight decay
   0.01, batch 8, seq-len 224) on 8 synthetic sentences: at step 0 the
   loss and every leaf's gradient through the kernels against the plain
   versions (``TRAIN_LOSS_RTOL``, ``TRAIN_GRAD_REL``), every encoder
   block's attention q/k weight gradient non-zero; one warm-up and 4 timed
   steps on the batch (launch counts reset just before and read just
   after: 32 flash launches a step), falling losses, ms per step, samples
   per second, peak memory; the checkpoint saved as ``params.npz``,
   reloaded, and one forward with equal bits. (c) The flash kernel at the
   training shape [8, 20, 1500, 64] f32 against its plain version, timed
   beside ``scaled_dot_product_attention`` in f32 and its f32 bound, the
   backward recompute's time; its autograd.Function's q/k/v gradients
   against autograd through the plain version there and at [2, 4, 1001,
   32] (``FLASH_GRAD_TOL``). (b) The ConvVAD, ConvEmbedder,
   SegmentationNet and MaskUNet trainers, 5 steps each on the card from
   their shipped bundles: finite losses, the step-0 loss within
   ``SMALL_LOSS_RTOL`` of one step on the CPU, the saved checkpoint
   reloaded into the module bit for bit, ms per step.
11. The integrity layer and the mesh. (a) ``checksum_device`` on the card
   equals ``host_checksum`` for int8, int16, int32, int64, float16, bfloat16
   and float32 at odd sizes; a zeroed device copy is refused
   (``FetchIntegrityError``); ``put_verified_tree`` of random large-v3-turbo
   bf16 parameters (807 M) is timed beside a plain upload, and the
   checksums of one decode batch's buffers; phase 6's timed ``process``
   must have made a verified fetch per batch. (b) A world of one rank over
   NCCL (no torchrun) and ``ServingPipeline(cfg, mesh=build_mesh(...))``
   with a mesh of size 1 at phase 6's configuration: the segments and
   turns of phase 6's timed run. (c) The flash kernel at the per-rank
   encoder shape of a model axis of 2, [16, 10, 1500, 64] bf16, and the
   ancestry kernel at 10 heads (BW 16, K 5, ctx 448, int8) against their
   plain versions, timed beside their bounds; then a world of two ranks
   of this script (``--mesh-rank``) sharing the card over gloo, killed at
   ``MESH_WORLD_S``: the proxy bundle's phase 5 sentences under ``{model:
   2}`` and ``{data: 2}``, bf16 and int8 (the int8 tree replicated), must
   give phase 5's segments; large-v3-turbo at phase 6's configuration
   under ``{model: 2}`` through ``_check_serving``, both ranks the same
   segments, the flash and ancestry kernels launched on each (counts reset
   just before, read just after); the first decode step's logits against
   the unsharded tree's within ``TP_LOGIT_TOL``; one decode step's time,
   its all-reduces and their time alone; one f32 training step at batch 8
   under ``--devices 2 --tp 2`` whose loss is within ``TP_LOSS_RTOL`` of
   phase 10's step-0 loss. Two ranks on one card show correctness at the
   tensor-parallel shapes, not scaling.

The profiled runs of phases 4 and 4b decode ``PROFILE_TOKENS`` tokens.
Float32 products run in full f32 (TF32 off for matmuls and cuDNN
convolutions). The last lines are the card, the per-kernel JSON line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PROXY = ROOT / "modular_audio_pipeline_tpu" / "weights" / "whisper-tiny-synth-proxy"
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
SR = 16000
# what a phase leaves for phase 11 to compare against (phases 5, 6 and 10)
SHARED: dict = {}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, reps: int = 5) -> float:
    """Mean device time of one call out of ``fns`` (a list of callables, run
    in order), from replays of a CUDA graph that captured them: no host
    time between the launches, so a kernel shorter than its wrapper's host
    work is timed on the device alone."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def bound(bytes_moved: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def exp_rate(torch) -> float:
    """Exponentials per second of the card's special-function units: 16 per
    clock per SM at the highest SM clock nvidia-smi reports."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 16 * mhz * 1e6


# -- phase 2 -----------------------------------------------------------------

FLASH_TOL = 1e-2  # bf16: one ulp at |y| in [1, 2) is 7.8e-3; the kernel rounds the
#                   unnormalised probabilities to bf16, the plain version the normalised
FLASH_TOL_F32 = 1e-4  # f32: fast exp and another summation order


def phase_flash(torch):
    import torch.nn.functional as F

    from modular_audio_pipeline_tpu_torch.ops.attention import attention_reference, flash_attention

    g = torch.Generator(device="cuda").manual_seed(0)

    def check(shape, dtype, tol):
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3))
        out, again = flash_attention(q, k, v), flash_attention(q, k, v)
        ref = attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()  # over every head: a tail tile
        same = torch.equal(out, again)                        # must not reach the next one
        log(f"flash {str(dtype)[6:]} {shape}: max_abs_err {err:.3e} (tol {tol}), "
            f"two runs bit-equal {same}")
        if not (err <= tol and same):
            raise AssertionError(f"flash_attention at {shape} {dtype}: err {err}, bit-equal {same}")
        return q, k, v, err

    for shape in [(2, 3, 1, 64), (2, 3, 129, 64), (2, 3, 300, 64), (2, 2, 1501, 64),
                  (1, 2, 1500, 32)]:
        check(shape, torch.bfloat16, FLASH_TOL)
    check((2, 4, 1500, 64), torch.float32, FLASH_TOL_F32)
    shape = (16, 20, 1500, 64)
    q, k, v, err = check(shape, torch.bfloat16, FLASH_TOL)

    # the pre-pass that scales k is part of the call, so it is in both times
    ms = graph_ms([lambda: flash_attention(q, k, v)] * 4)
    eager_ms = time_ms(lambda: flash_attention(q, k, v), 10)
    plain_ms = time_ms(lambda: attention_reference(q, k, v), 5)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    b, h, s, d = shape
    bound_ms, bound_by = bound(4 * q.numel() * q.element_size(), 4.0 * b * h * s * s * d)
    exp_ms = b * h * s * s / exp_rate(torch) * 1e3
    bytes_ms = 4 * q.numel() * q.element_size() / PEAK_BYTES * 1e3
    ops_ms = 4.0 * b * h * s * s * d / PEAK_BF16_FLOPS * 1e3
    binds = "exponentials" if exp_ms > bound_ms else bound_by
    log(f"flash: kernel {ms:.4f} ms on the device ({eager_ms:.4f} ms eager), plain {plain_ms:.3f} ms, "
        f"sdpa {lib_ms:.4f} ms; bounds: operations {ops_ms:.4f} ms, exponentials {exp_ms:.4f} ms, "
        f"bytes {bytes_ms:.4f} ms: {binds} bind")
    if exp_ms > bound_ms:  # the special-function unit's operations
        bound_ms, bound_by = exp_ms, "operations"
    del q, k, v
    torch.cuda.empty_cache()
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "modular_audio_pipeline_tpu_torch/csrc/flash_attention.cu",
        "replaces": "modular_audio_pipeline_tpu/ops/attention.py:60",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms,
        "segmentation": phase_flash_segmentation(torch, check),
    }


SEG_SHAPE = (512, 4, 1000, 32)  # SegmentationNet: a chunk of 512 windows, 4 heads of 32


def phase_flash_segmentation(torch, check):
    """The kernel's CUDA-core route in f32: against the plain version at
    the edges of its 128-query tile, and at head dim 32, where
    SegmentationNet calls it, at a 32-window chunk and at a ragged sequence
    length, equal bits twice; timed at a 512-window chunk beside
    the plain version and ``scaled_dot_product_attention`` in f32. Its
    bound takes the f32 CUDA-core peak (TF32 would change the arithmetic
    the JAX package does), the exponentials and the bytes."""
    import torch.nn.functional as F

    from modular_audio_pipeline_tpu_torch.ops.attention import attention_reference, flash_attention

    check((1, 3, 127, 32), torch.float32, FLASH_TOL_F32)
    check((1, 3, 129, 64), torch.float32, FLASH_TOL_F32)
    check((32, 4, 1000, 32), torch.float32, FLASH_TOL_F32)
    check((2, 4, 1001, 32), torch.float32, FLASH_TOL_F32)
    q, k, v, err = check(SEG_SHAPE, torch.float32, FLASH_TOL_F32)
    ms = graph_ms([lambda: flash_attention(q, k, v)] * 2, reps=3)
    plain_ms = time_ms(lambda: attention_reference(q, k, v), 2, warmup=1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 5)
    b, h, s, d = SEG_SHAPE
    n_bytes = 4 * q.numel() * q.element_size()
    ops_ms = 4.0 * b * h * s * s * d / PEAK_F32_FLOPS * 1e3
    exp_ms = b * h * s * s / exp_rate(torch) * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    bound_ms, bound_by = bound(n_bytes, 4.0 * b * h * s * s * d, PEAK_F32_FLOPS)
    if exp_ms > bound_ms:
        bound_ms, bound_by = exp_ms, "operations"
    log(f"flash f32 {SEG_SHAPE} (segmentation): kernel {ms:.3f} ms on the device, plain "
        f"{plain_ms:.3f} ms, sdpa f32 {lib_ms:.3f} ms; bounds: f32 operations {ops_ms:.3f} ms, "
        f"exponentials {exp_ms:.3f} ms, bytes {bytes_ms:.4f} ms")
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": list(SEG_SHAPE), "dtype": "float32", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


# -- phase 3 -----------------------------------------------------------------

ANC_TOL = 1e-2  # bf16 y: f32 sums in another order may move a rounded
#                 probability or y by one bf16 ulp (7.8e-3 at |y| in [1, 2))


def _anc_inputs(torch, quant: bool, g, ctx: int = 448, shared: bool = False, bw: int = 16,
                n_layers: int = 4, layer: int = 2, h: int = 20):
    """One decode step's inputs for layer ``layer`` of an ``n_layers`` cache
    of ``h`` heads, at the last position of a ``ctx`` bucket. ``shared``:
    every beam of a window follows beam 0's ancestry up to the last three
    positions, as real decoding does; else rows at random."""
    kq, hd = 5, 64
    bk, pos = bw * kq, ctx - 1
    dev = "cuda"
    q = (torch.randn((bk, h, 1, hd), generator=g, device=dev) * 0.125).to(torch.bfloat16)
    if quant:
        def codes(shape):
            return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

        def scales(shape):
            return torch.rand(shape, generator=g, device=dev) * 0.02 + 0.001

        cache = [codes((n_layers, bk, h, ctx, hd)), codes((n_layers, bk, h, ctx, hd)),
                 scales((n_layers, bk, h, ctx)), scales((n_layers, bk, h, ctx))]
        new = [codes((bk, h, 1, hd)), codes((bk, h, 1, hd)),
               scales((bk, h, 1)), scales((bk, h, 1))]
    else:
        cache = [torch.randn((n_layers, bk, h, ctx, hd), generator=g, device=dev)
                 .to(torch.bfloat16) for _ in range(2)] + [None, None]
        new = [torch.randn((bk, h, 1, hd), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(2)] + [None, None]
    for c in cache:
        if c is not None:
            c[layer, :, :, pos] = 0  # not yet written, as in the decode loop
    anc = torch.randint(0, kq, (bw, kq, ctx), generator=g, device=dev, dtype=torch.int32)
    if shared:
        anc[:, :, :-3] = anc[:, :1, :-3]
    anc[:, :, pos] = torch.arange(kq, device=dev, dtype=torch.int32)  # own-row claim
    mask = torch.zeros((ctx,), device=dev)  # every position live: the bucket's last step
    return q, cache, new, anc, mask, layer, pos


def _anc_bytes(q, cache, anc, mask, layer):
    """Bytes the step must move: q and y once, and of layer ``layer`` only
    the K/V rows (and scales) that some hypothesis selects."""
    bw, kq, ctx = anc.shape
    hd = q.shape[-1]
    h = q.shape[1]
    selected = int(sum(len(set(r.tolist())) for r in anc.permute(0, 2, 1).reshape(-1, kq).cpu()))
    row = h * hd * cache[0].element_size() + (h * 4 if cache[2] is not None else 0)
    return (2 * q.numel() * q.element_size() + 2 * selected * row
            + anc.numel() * 4 + mask.numel() * 4)


def _host_us(fn, n: int = 200) -> float:
    """Host microseconds of one call of ``fn``: ``n`` calls queued without a
    wait (fewer than the launch queue holds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def _anc_case(torch, g, quant: bool, ctx: int, shared: bool, **shape):
    """One step of the ancestry kernel against its plain version (y within
    ANC_TOL, equal cache rows, equal bits over two runs), then its device,
    eager and plain times beside its bound. Returns the numbers, the inputs
    and the kernel's cache."""
    from modular_audio_pipeline_tpu_torch.ops.ancestor_attention import (
        ancestor_attention,
        ancestor_attention_reference,
    )

    q, cache, new, anc, mask, layer, pos = _anc_inputs(torch, quant, g, ctx, shared, **shape)
    mine = [None if c is None else c.clone() for c in cache]
    plain = [None if c is None else c.clone() for c in cache]
    y = ancestor_attention(q, *mine, layer, anc, mask, *new, pos)
    y_ref = ancestor_attention_reference(q, *plain, layer, anc, mask, *new, pos)
    again = ancestor_attention(q, *mine, layer, anc, mask)
    torch.cuda.synchronize()
    err = (y.float() - y_ref.float()).abs().max().item()
    same = all(a is None or torch.equal(a, b) for a, b in zip(mine, plain))
    bits = torch.equal(y, again)
    name = (f"{'int8' if quant else 'bf16'} ctx {ctx} "
            f"{'shared ancestry' if shared else 'random ancestry'}"
            + "".join(f" {k} {v}" for k, v in shape.items()))
    log(f"ancestry {name}: max_abs_err {err:.3e} (tol {ANC_TOL}), cache rows equal {same}, "
        f"two runs bit-equal {bits}")
    if not (err <= ANC_TOL and same and bits):
        raise AssertionError(f"ancestor_attention ({name}) disagrees with its plain version")
    ms = graph_ms([lambda: ancestor_attention(q, *mine, layer, anc, mask)] * 8)
    eager_ms = time_ms(lambda: ancestor_attention(q, *mine, layer, anc, mask), 50)
    plain_ms = time_ms(lambda: ancestor_attention_reference(q, *plain, layer, anc, mask), 10)
    bound_ms, bound_by = bound(_anc_bytes(q, cache, anc, mask, layer),
                               4.0 * q.shape[0] * q.shape[1] * anc.shape[-1] * q.shape[-1])
    log(f"ancestry {name}: kernel {ms:.4f} ms on the device ({eager_ms:.4f} ms eager, with "
        f"its wrapper), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    numbers = {"max_abs_err": err, "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
    return numbers, (q, new, anc, mask, layer, pos), mine


def phase_ancestry(torch):
    from modular_audio_pipeline_tpu_torch.ops import ancestor_attention as anc_ops
    from modular_audio_pipeline_tpu_torch.ops.ancestor_attention import ancestor_attention

    g = torch.Generator(device="cuda").manual_seed(1)
    result = None
    # (cache type, context bucket, shared ancestry); the first is the kernels line's row
    cases = [(True, 448, False), (True, 448, True), (True, 64, False), (True, 64, True),
             (False, 448, False)]
    for quant, ctx, shared in cases:
        numbers, (q, new, anc, mask, layer, pos), mine = _anc_case(torch, g, quant, ctx, shared)
        if result is None:  # the main path's cache type at its longest bucket
            result = {
                "name": "ancestor_attention", "route": "cuda",
                "source": "modular_audio_pipeline_tpu_torch/csrc/ancestor_attention.cu",
                "replaces": "modular_audio_pipeline_tpu/ops/ancestor_attention.py:132",
                "max_abs_err": numbers["max_abs_err"], "ms": numbers["ms"],
                "plain_ms": numbers["plain_ms"], "bound_ms": numbers["bound_ms"],
                "bound_by": numbers["bound_by"], "library_ms": None,
            }
            sweep = {split: graph_ms(
                [lambda: ancestor_attention(q, *mine, layer, anc, mask, split=split)] * 8)
                for split in (1, 2, 4)}
            log("ancestry blocks per (window, head), 16 windows: "
                + ", ".join(f"{k}: {v:.4f} ms" for k, v in sweep.items()))
        if (quant, ctx, shared) == (True, 64, True):  # the device is short here: host time shows
            log(f"ancestry wrapper on the host: {_host_us(lambda: ancestor_attention(q, *mine, layer, anc, mask)):.1f} us "
                f"a call, of which its checks "
                f"{_host_us(lambda: anc_ops._check(q, *mine, layer, anc, mask)):.1f} us; with the "
                f"row store {_host_us(lambda: ancestor_attention(q, *mine, layer, anc, mask, *new, pos)):.1f} us")
        del mine
        torch.cuda.empty_cache()
    # one window (a file of up to 30 s): 20 (window, head) pairs for 132 SMs
    q, cache, new, anc, mask, layer, pos = _anc_inputs(torch, True, g, 448, True, bw=1)
    y1 = ancestor_attention(q, *cache, layer, anc, mask, split=1)
    sweep = {}
    for split in (1, 2, 4, 0):
        y = ancestor_attention(q, *cache, layer, anc, mask, split=split)
        if not (y.float() - y1.float()).abs().max().item() <= ANC_TOL:
            raise AssertionError(f"ancestor_attention: split {split} disagrees with split 1")
        sweep[split or "auto"] = graph_ms(
            [lambda: ancestor_attention(q, *cache, layer, anc, mask, split=split)] * 8)
    log("ancestry blocks per (window, head), 1 window: "
        + ", ".join(f"{k}: {v:.4f} ms" for k, v in sweep.items()))
    return result


# -- phase 3b ----------------------------------------------------------------

# (M, K, N): the decode step's projections and head, the cross K/V, a ragged case
INT8_SHAPES = [(80, 1280, 1280), (80, 1280, 5120), (80, 5120, 1280), (80, 1280, 51968),
               (24000, 1280, 1280), (3, 64, 200)]
INT8_HEAD = (80, 1280, 51968)
INT8_ROUTES = {0: "generic", 1: "decode", 2: "wide"}


L2_BYTES = 50e6  # H100: weights re-read within this many bytes come from the cache


# (K, N) at which the decode kernel's plan takes each cluster size at 80 rows
INT8_CLUSTER_SHAPES = {1: (1280, 8448), 2: (1280, 5120), 3: (192, 1280), 4: (1280, 2560),
                       5: (640, 1280), 6: (384, 1280), 7: (1280, 1280), 8: (5120, 1280)}


def _int8_tol(torch, x, wq, ws, ref, out_dtype):
    """Per element: the kernel and the plain version add the same exact f32
    products (bf16 x int8) in another order, and rounding errors that add
    like a random walk stay within 2 sqrt(K) 2^-24 of the sum of the terms'
    magnitudes, times the column's scale (sound runs measured below a tenth
    of it; an output or accumulator rounded to bf16 is far outside, as
    ``_int8_controls`` shows); plus one f32 rounding of the biased value,
    and in bf16 one bf16 spacing (2^-7 of the value at most)."""
    terms = x.to(torch.bfloat16).float().abs() @ wq.float().abs()
    tol = 2 * wq.shape[0] ** 0.5 * 2.0 ** -24 * terms * ws + 2.0 ** -23 * ref.abs()
    return tol + 2.0 ** -7 * ref.abs() if out_dtype == torch.bfloat16 else tol


def _int8_check(torch, x, wq, ws, bias, out_dtype):
    """One product through the kernel, twice, against the plain version ->
    (max abs error, worst error / tolerance, output, tolerance). Raises unless within ``_int8_tol``
    at every element, finite, one launch per call and equal bits twice."""
    from modular_audio_pipeline_tpu_torch.ops.quant import int8_matmul, int8_matmul_reference

    before = int8_matmul.launches
    out = int8_matmul(x, wq, ws, bias, out_dtype)
    again = int8_matmul(x, wq, ws, bias, out_dtype)
    torch.cuda.synchronize()
    ref = int8_matmul_reference(x, wq, ws, bias, torch.float32)
    tol = _int8_tol(torch, x, wq, ws, ref, out_dtype)
    diff = (out.float() - ref).abs()
    err, ratio = diff.max().item(), (diff / tol).max().item()
    ok = (bool((diff <= tol).all()) and bool(torch.isfinite(out).all())
          and torch.equal(out, again) and int8_matmul.launches == before + 2)
    if not ok:
        raise AssertionError(f"int8_matmul disagrees with its plain version at {tuple(x.shape)} x "
                             f"{tuple(wq.shape)}, {out_dtype}, bias {bias is not None}: err {err} "
                             f"(worst error / tolerance {ratio:.3g}), "
                             f"bit-equal {torch.equal(out, again)}")
    return err, ratio, out, tol


def _int8_controls(torch, x, wq, ws, tol) -> str:
    """Products that keep less than f32, held to the f32 tolerance: the
    plain version rounded to bf16, and the JAX package's other branch (code
    x scale rounded to bf16 before the sum). Raises if either passes."""
    from modular_audio_pipeline_tpu_torch.ops.quant import int8_matmul_reference

    ref = int8_matmul_reference(x, wq, ws)
    controls = {"bf16_rounded": ref.to(torch.bfloat16).float(),
                "bf16_weights": x.to(torch.bfloat16).float()
                @ (wq.float() * ws).to(torch.bfloat16).float()}
    worst = {}
    for name, c in controls.items():
        worst[name] = ((c - ref).abs() / tol).max().item()
        if worst[name] <= 1:
            raise AssertionError(f"int8_matmul's tolerance passes the {name} control")
    return ", ".join(f"{k} {v:.1f}x" for k, v in worst.items())


def phase_int8(torch):
    """Kernel 3 against its plain version at every main-path shape, in the
    head's form (f32 out, no bias) and in ``_proj``'s (bf16 out, bf16 bias
    added in f32 before the one rounding), with controls that keep less
    than f32 shown to fail the tolerance; then at each cluster size the
    decode kernel can take, against the plain version and the emulation of
    its split.

    Times are device times from CUDA-graph replays (the decode step's
    launches are shorter than their wrapper's host work), over enough
    distinct copies of the weight to exceed the L2 cache: the decode loop
    walks 158 MB of codes per step, so it finds each weight cold. The
    eager time, host work included, is logged beside them."""
    from modular_audio_pipeline_tpu_torch.ops.quant import (
        int8_matmul,
        int8_matmul_reference,
        int8_matmul_split_emulation,
        plan,
    )

    g = torch.Generator(device="cuda").manual_seed(2)
    result, table = None, []
    for m, k, n in INT8_SHAPES:
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
        ws = torch.rand((n,), generator=g, device="cuda") * 0.002 + 1e-4  # |w| <= ~0.25
        bias = (torch.randn((n,), generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        err, ratio, out, tol = _int8_check(torch, x, wq, ws, None, torch.float32)
        controls = _int8_controls(torch, x, wq, ws, tol)
        err_proj, _, _, _ = _int8_check(torch, x, wq, ws, bias, torch.bfloat16)
        p = plan(m, k, n)
        del out, tol

        copies = 1 if m > 1000 else min(64, int(L2_BYTES // (k * n)) + 2)
        wqs = [wq] + [wq.clone() for _ in range(copies - 1)]
        # dequantised beforehand, twice the bytes: the yardstick the port never calls
        w_bf16 = [(w.float() * ws).to(torch.bfloat16) for w in wqs]
        ms = graph_ms([lambda w=w: int8_matmul(x, w, ws) for w in wqs])
        proj_ms = graph_ms([lambda w=w: int8_matmul(x, w, ws, bias, torch.bfloat16) for w in wqs])
        plain_ms = graph_ms([lambda w=w: int8_matmul_reference(x, w, ws) for w in wqs], reps=2)
        lib_ms = graph_ms([lambda w=w: torch.matmul(x, w) for w in w_bf16])
        eager_ms = time_ms(lambda: int8_matmul(x, wq, ws), 5 if m > 1000 else 50)
        bytes_moved = k * n + m * k * x.element_size() + n * 4 + m * n * 4
        bound_ms, bound_by = bound(bytes_moved, 2.0 * m * k * n)
        row = {"m": m, "k": k, "n": n, "route": INT8_ROUTES[p["route"]], "cluster": p["cluster"],
               "ms": ms, "proj_bf16_bias_ms": proj_ms, "eager_ms": eager_ms,
               "plain_ms": plain_ms, "bf16_matmul_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "max_abs_err": err, "err_over_tol": ratio,
               "proj_max_abs_err": err_proj, "launches_per_product": 1}
        log(f"int8_matmul M {m} K {k} N {n} ({row['route']}, cluster {p['cluster']}): max_abs_err "
            f"{err:.3e} (worst error / tolerance {ratio:.3f}; controls fail it by {controls}), "
            f"bf16+bias {err_proj:.3e}, two runs bit-equal; "
            f"kernel {ms:.4f} ms (bf16 out + bias {proj_ms:.4f} ms; eager, with its wrapper: "
            f"{eager_ms:.4f} ms), plain {plain_ms:.4f} ms, bf16 matmul {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {copies} weight copies")
        table.append(row)
        if (m, k, n) == INT8_HEAD:
            result = {
                "name": "int8_matmul", "route": "cuda",
                "source": "modular_audio_pipeline_tpu_torch/csrc/int8_matmul.cu",
                "replaces": "modular_audio_pipeline_tpu/ops/quant.py:39",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
            }
        del x, wq, ws, wqs, w_bf16
        torch.cuda.empty_cache()
    log(json.dumps({"int8_matmul_shapes": table}))
    # each cluster size the decode kernel's plan can take, reached through
    # the shape: the plain version, and the emulation of the split element
    # by element
    for cluster, (k, n) in INT8_CLUSTER_SHAPES.items():
        p = plan(80, k, n)
        if p["route"] != 1 or p["cluster"] != cluster:
            raise AssertionError(f"int8_matmul: plan {p} at 80 x {k} x {n}, not cluster {cluster}")
        x = torch.randn((80, k), generator=g, device="cuda").to(torch.bfloat16)
        wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
        ws = torch.rand((n,), generator=g, device="cuda") * 0.002 + 1e-4
        bias = (torch.randn((n,), generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        err, ratio, out, tol = _int8_check(torch, x, wq, ws, bias, torch.float32)
        emu = int8_matmul_split_emulation(x, wq, ws, bias, torch.float32, k_slice=p["k_slice"])
        emu_err = (out - emu).abs()
        if not bool((emu_err <= tol).all()):
            raise AssertionError(f"int8_matmul at cluster {cluster} disagrees with its emulation")
        log(f"int8_matmul cluster {cluster} (80 x {k} x {n}, K slice {p['k_slice']}): max_abs_err "
            f"{err:.3e} (worst error / tolerance {ratio:.3f}), against the emulation "
            f"{emu_err.max().item():.3e}, two runs bit-equal")
    return result


# -- phase 4 -----------------------------------------------------------------

def bench_audio(seconds: float) -> np.ndarray:
    """The voiced signal bench.py times (its make_audio), as int16 PCM
    delivers it."""
    rng = np.random.default_rng(0)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = 130 + 40 * np.sin(2 * np.pi * 0.4 * t)
    sig = sum((0.3 / k) * np.sin(2 * np.pi * k * np.cumsum(f0) / SR) for k in range(1, 5))
    env = (np.sin(2 * np.pi * 1.3 * t) > -0.5).astype(np.float32)
    out = (sig * env * 0.3).astype(np.float32)
    out += 0.002 * rng.standard_normal(n).astype(np.float32)
    return np.clip(out * 32768.0, -32768, 32767).astype(np.int16).astype(np.float32) / 32768.0


def _reset_launches():
    from modular_audio_pipeline_tpu_torch.ops.ancestor_attention import ancestor_attention
    from modular_audio_pipeline_tpu_torch.ops.attention import flash_attention
    from modular_audio_pipeline_tpu_torch.ops.quant import int8_matmul

    wrappers = {"flash_attention": flash_attention, "ancestor_attention": ancestor_attention,
                "int8_matmul": int8_matmul}
    for w in wrappers.values():
        w.launches = 0
    return wrappers


@contextlib.contextmanager
def record_int8_shapes(shapes: dict):
    """Count the (M, K, N) of every int8 product the model makes."""
    from modular_audio_pipeline_tpu_torch.models.whisper import model

    real = model.int8_matmul

    def spy(x, wq, ws, *args, **kw):
        key = (x.numel() // x.shape[-1], *wq.shape)
        shapes[key] = shapes.get(key, 0) + 1
        return real(x, wq, ws, *args, **kw)

    model.int8_matmul = spy
    try:
        yield
    finally:
        model.int8_matmul = real


def _timed_run(torch, tr, wav: Path, seconds: float, label: str, warmup=contextlib.nullcontext):
    """Warm-up run (inside ``warmup()``), then one run with every kernel's
    launch count set to 0 just before and read just after -> (result, wall
    seconds, launches)."""
    t0 = time.perf_counter()
    with warmup():
        tr.transcribe(str(wav))
    torch.cuda.synchronize()
    log(f"{label}: warm-up run {time.perf_counter() - t0:.2f} s")

    wrappers = _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tr.transcribe(str(wav))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    stats = tr._backend.last_stats
    log(f"{label}: wall {wall:.3f} s, realtime x{seconds / wall:.1f}, "
        f"segments {len(out['segments'])}, windows {stats['windows']}, "
        f"decode tokens {stats['decode_tokens']}, launches {launches}")
    if stats["windows"] != 16 or stats["decode_tokens"] <= 0:
        raise AssertionError(f"{label}: unexpected decode workload {stats}")
    for s in out["segments"]:
        if not (0.0 <= s["start"] <= s["end"] <= seconds and np.isfinite(s["confidence"])
                and isinstance(s["text"], str)):
            raise AssertionError(f"{label}: malformed segment {s}")
    return out, wall, launches


def phase_end_to_end(torch, wav: Path, seconds: float):
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    t0 = time.perf_counter()
    tr = WhisperTranscriber(
        "large-v3-turbo", language="en", weights_path="random:0", beam_size=5,
        max_decode_tokens=224, word_timestamps=False, device="cuda", lazy_load=False,
    )
    tr._backend.no_speech_threshold = None  # as bench.py: every window is parsed
    torch.cuda.synchronize()
    log(f"e2e: random large-v3-turbo loaded in {time.perf_counter() - t0:.1f} s")
    out, wall, launches = _timed_run(torch, tr, wav, seconds, "e2e")

    # the encoder's share: encoder + cross K/V of one 16-window batch
    from modular_audio_pipeline_tpu_torch.models.whisper.decode import encode_audio_kv

    b = tr._backend
    mel = torch.randn((16, b.dims.n_mels, 3000), device="cuda")
    encode_s = time_ms(lambda: encode_audio_kv(b.params, b.dims, mel), 2, warmup=1) / 1e3
    log(f"e2e: encoder + cross K/V {encode_s:.3f} s of the wall time")
    if launches["flash_attention"] != 32 or launches["ancestor_attention"] <= 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if launches["int8_matmul"] != 0:
        raise AssertionError(f"the bf16 path launched the int8 kernel: {launches}")
    stats = dict(b.last_stats)  # the timed run's, before the profiled run replaces them
    with first_steps(b):
        busy, top, _ = device_breakdown(torch, lambda: tr.transcribe(str(wav)), "e2e")
    return launches, {"wall_s": wall, "realtime_x": seconds / wall,
                      "segments": len(out["segments"]),
                      "decode_tokens": stats["decode_tokens"], "encode_s": encode_s,
                      "device_busy_share": busy, "top_kernels_ms": top}


def phase_end_to_end_int8(torch, wav: Path, seconds: float):
    """This slice's path at full width: the int8 decoder and DTW words,
    built the way a configuration file builds it."""
    from modular_audio_pipeline_tpu_torch.config import PipelineConfig
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    cfg = PipelineConfig(lazy_load_models=False)
    tc = cfg.transcription
    tc.model, tc.language, tc.weights_path = "large-v3-turbo", "en", "random:0"
    tc.beam_size, tc.max_decode_tokens, tc.batch_size = 5, 224, 16
    tc.compute_type, tc.word_timestamps = "int8", True
    tc.no_speech_threshold = None  # every window is parsed
    t0 = time.perf_counter()
    tr = WhisperTranscriber.from_config(cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"e2e int8: random large-v3-turbo loaded and quantised in "
        f"{time.perf_counter() - t0:.1f} s")
    dec = tr._backend.params["decoder"]
    if dec["logits_wq"].dtype != torch.int8 or "q_w" in dec["blocks"]["attn"]:
        raise AssertionError("compute_type=int8 left the decoder unquantised")
    shapes = {}
    out, wall, launches = _timed_run(torch, tr, wav, seconds, "e2e int8",
                                     warmup=lambda: record_int8_shapes(shapes))
    stats = tr._backend.last_stats
    log(f"e2e int8: word alignment {stats['align_s']:.3f} s of the wall time")
    # M of each int8 product in one run: 80 (decode steps), the prompt pass,
    # 16 x 1500 (cross K/V) and the alignment pass (windows x tokens)
    by_m = {}
    for (m, k, n), c in shapes.items():
        by_m.setdefault(m, []).append(f"{k}x{n} x{c}")
    log("e2e int8: int8 products by M: " + "; ".join(
        f"M {m}: {', '.join(v)}" for m, v in sorted(by_m.items())))

    steps = launches["ancestor_attention"] // tr._backend.dims.n_text_layer
    if launches["flash_attention"] != 32 or steps <= 0:
        raise AssertionError(f"the int8 path skipped a kernel: {launches}")
    if launches["int8_matmul"] < 33 * steps:
        raise AssertionError(f"fewer than 33 int8 launches per decode step: {launches}, "
                             f"{steps} steps")
    # Random weights attend nowhere in particular, so the DTW may place no
    # word's midpoint inside some segment, which then carries none (as in
    # the JAX package): every segment has text, the words that are attached
    # are well formed, and the batch as a whole carries words.
    n_words = with_words = 0
    for s in out["segments"]:
        if not s["text"]:
            raise AssertionError(f"e2e int8: segment without text: {s}")
        words = s.get("words", [])
        for w in words:
            if not (0.0 <= w["start"] <= w["end"] <= seconds and w["word"]):
                raise AssertionError(f"e2e int8: malformed word {w}")
        n_words += len(words)
        with_words += bool(words)
    log(f"e2e int8: {with_words} of {len(out['segments'])} segments carry words "
        f"({n_words} words)")
    if not with_words:
        raise AssertionError("e2e int8: no segment carries words")
    from modular_audio_pipeline_tpu_torch.models.whisper.decode import encode_audio_kv

    b = tr._backend
    mel = torch.randn((16, b.dims.n_mels, 3000), device="cuda")
    encode_s = time_ms(lambda: encode_audio_kv(b.params, b.dims, mel), 2, warmup=1) / 1e3
    log(f"e2e int8: encoder + cross K/V {encode_s:.3f} s of the wall time")
    wrappers = _reset_launches()
    with first_steps(b):
        busy, top, mine = device_breakdown(torch, lambda: tr.transcribe(str(wav)), "e2e int8")
    # one device launch per product: the kernel's launches on the device
    # equal the wrapper's calls, and no other int8 kernel (a reduction) ran
    on_device = mine["int8_matmul"][1]
    log(f"e2e int8 (profiled): {wrappers['int8_matmul'].launches} int8_matmul calls, "
        f"{on_device} int8 kernel launches on the device")
    if on_device != wrappers["int8_matmul"].launches:
        raise AssertionError("int8_matmul made other than one device launch per product")
    return launches, {"wall_s": wall, "realtime_x": seconds / wall, "encode_s": encode_s,
                      "segments": len(out["segments"]), "words": n_words,
                      "decode_tokens": stats["decode_tokens"], "decode_steps": steps,
                      "align_s": stats["align_s"], "device_busy_share": busy,
                      "top_kernels_ms": top, "int8_kernel_ms": mine["int8_matmul"][0],
                      "int8_products_by_m": {str(m): sum(c for (mm, _, _), c in shapes.items()
                                                         if mm == m) for m in by_m}}


PROFILE_TOKENS = 16  # decode steps of a profiled run (of 224): the post-processing of a
#                     whole run's trace took ~70 s per phase


@contextlib.contextmanager
def first_steps(backend):
    """Cap the decode budget at ``PROFILE_TOKENS`` for a profiled run: the
    whole batch still goes through the encoder, the prompt pass and (with
    words) the alignment pass, with the first decode steps of every window."""
    saved = backend.max_decode_tokens
    backend.max_decode_tokens = PROFILE_TOKENS
    try:
        yield
    finally:
        backend.max_decode_tokens = saved


def device_breakdown(torch, fn, label: str, top: int = 8):
    """Device busy share, the kernels with the most device time over one
    run of ``fn``, and (ms, launches) of each of the port's kernels, from
    torch.profiler. The profiler slows the host, so the busy share it gives
    is a lower bound; None when it saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(
        ((e.key, getattr(e, "self_device_time_total", 0) / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in rows)
    for name, ms, n in rows[:top]:
        log(f"  device {ms:9.1f} ms  x{n:<6d} {name[:90]}")
    mine = {}
    for kernel in ("flash_fwd_tc", "flash_fwd_fma", "scale_rows", "ancestor_attention_kernel",
                   "int8_matmul_decode",
                   "int8_matmul_wide", "int8_matmul_generic", "int8_matmul"):
        hits = [(ms, n) for name, ms, n in rows if kernel in name]
        mine[kernel] = (sum(h[0] for h in hits), sum(h[1] for h in hits))
        if hits:
            log(f"  {label}: {kernel} {mine[kernel][0]:.1f} ms over {mine[kernel][1]} launches")
    log(f"{label} (profiled): wall {wall:.3f} s, device busy {busy_ms / 1e3:.3f} s")
    if busy_ms <= 0:
        return None, [], mine
    return busy_ms / 1e3 / wall, [[name[:90], ms, n] for name, ms, n in rows[:top]], mine


# -- phase 5 -----------------------------------------------------------------

_VOCAB = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel", "india",
    "juliett", "kilo", "lima", "mike", "november", "oscar", "papa", "quebec", "romeo",
    "sierra", "tango", "uniform", "victor", "whiskey", "zulu",
]


def _synth_sentence(words, rng) -> np.ndarray:
    """The proxy's held-out speech: training/synth_asr.synth_sentence of
    the JAX package, copied (this script imports nothing of it)."""
    bank_a, bank_b, bank_c = [320.0, 440.0, 600.0, 810.0], [1100.0, 1450.0, 1900.0], [2500.0, 3200.0]

    def word(idx):
        n = int(0.35 * SR)
        seg = n // 3
        t = np.arange(seg) / SR
        out = np.zeros(n, dtype=np.float32)
        freqs = (bank_a[idx % 4], bank_b[(idx // 4) % 3], bank_c[(idx // 12) % 2])
        for k, f in enumerate(freqs):
            f = f * rng.uniform(0.985, 1.015)
            tone = np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
            tone += 0.25 * np.sin(2 * np.pi * 2 * f * t + rng.uniform(0, 2 * np.pi))
            env = np.minimum(1.0, np.minimum(np.arange(seg), seg - np.arange(seg)) / (0.01 * SR))
            out[k * seg:(k + 1) * seg] = tone * env
        out *= rng.uniform(0.25, 0.6)
        out += rng.uniform(0.002, 0.01) * rng.standard_normal(n).astype(np.float32)
        return out.astype(np.float32)

    gap = np.zeros(int(0.12 * SR), dtype=np.float32)
    parts = [np.zeros(int(rng.uniform(0.05, 0.2) * SR), np.float32)]
    for w in words:
        parts += [word(w), gap]
    return np.concatenate(parts)


@contextlib.contextmanager
def plain_kernels():
    """Bind the models' kernel calls (Whisper's three, SegmentationNet's
    flash attention) to their plain versions."""
    from modular_audio_pipeline_tpu_torch.models.diarization import segmentation
    from modular_audio_pipeline_tpu_torch.models.whisper import model
    from modular_audio_pipeline_tpu_torch.ops.ancestor_attention import ancestor_attention_reference
    from modular_audio_pipeline_tpu_torch.ops.attention import attention_reference
    from modular_audio_pipeline_tpu_torch.ops.quant import int8_matmul_reference

    saved = (model.flash_attention, model.ancestor_attention, model.int8_matmul,
             segmentation.flash_attention)
    model.flash_attention, model.ancestor_attention = attention_reference, ancestor_attention_reference
    model.int8_matmul = int8_matmul_reference
    segmentation.flash_attention = attention_reference
    try:
        yield
    finally:
        (model.flash_attention, model.ancestor_attention, model.int8_matmul,
         segmentation.flash_attention) = saved


def _agreement(kernel, plain) -> float:
    """Share of segments (text, start, end) equal between two runs."""
    key = lambda s: (s["text"], s["start"], s["end"])  # noqa: E731
    pairs = [(key(a), key(b)) for ka, kb in zip(kernel, plain) for a, b in zip(ka, kb)]
    n = max(sum(len(s) for s in kernel), sum(len(s) for s in plain))
    return sum(a == b for a, b in pairs) / max(n, 1)


def phase_proxy(torch, tmp: Path):
    from modular_audio_pipeline_tpu_torch import transcriber as transcriber_mod
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav
    from modular_audio_pipeline_tpu_torch.models.whisper.tokenizer import LANGUAGES
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    rng = np.random.default_rng(500_000)  # the proxy's held-out stream
    paths = []
    for i in range(2):
        k = int(rng.integers(12, 27))
        words = rng.integers(0, len(_VOCAB), size=k)
        path = tmp / f"eval_{i}.wav"
        write_wav(str(path), _synth_sentence(list(words), rng), SR)
        paths.append((str(path), " ".join(_VOCAB[w] for w in words)))

    def proxy(**kw):
        kw.setdefault("language", "en")
        kw.setdefault("word_timestamps", False)
        return WhisperTranscriber("tiny", beam_size=5, weights_path=str(PROXY),
                                  max_decode_tokens=128, device="cuda", **kw)

    tr = proxy()
    kernel = [tr.transcribe(p)["segments"] for p, _ in paths]
    SHARED["proxy"] = {"paths": [p for p, _ in paths], "bf16": kernel}
    with plain_kernels():
        plain = [tr.transcribe(p)["segments"] for p, _ in paths]
    agree = _agreement(kernel, plain)
    for (path, text), segs in zip(paths, kernel):
        log(f"proxy: ref '{text}'")
        log(f"proxy: got '{' '.join(s['text'] for s in segs)}'")
    log(f"proxy: segment agreement kernel vs plain {agree:.3f} "
        f"({sum(len(s) for s in kernel)} vs {sum(len(s) for s in plain)} segments)")
    if not all(kernel):
        raise AssertionError("the kernel path produced no segments on the proxy bundle")

    # the int8 decoder through its kernel, then through its plain version
    tr8 = proxy()
    tr8._backend.compute_dtype = "int8"
    wrappers = _reset_launches()
    kernel8 = [tr8.transcribe(p)["segments"] for p, _ in paths]
    SHARED["proxy"]["int8"] = kernel8
    n_int8 = wrappers["int8_matmul"].launches
    with plain_kernels():
        plain8 = [tr8.transcribe(p)["segments"] for p, _ in paths]
    agree8 = _agreement(kernel8, plain8)
    log(f"proxy int8: got '{' '.join(s['text'] for s in kernel8[0])}'")
    log(f"proxy int8: segment agreement kernel vs plain {agree8:.3f}, agreement with the "
        f"bf16 decoder {_agreement(kernel8, kernel):.3f}, int8 launches {n_int8}")
    if not all(kernel8) or n_int8 <= 0:
        raise AssertionError("the int8 kernel path produced no segments on the proxy bundle")

    # DTW words lie inside their segments
    trw = proxy(word_timestamps=True)
    n_words = 0
    for p, _ in paths:
        segs = trw.transcribe(p)["segments"]
        if not segs:
            raise AssertionError("word_timestamps=True produced no segments")
        for s in segs:
            words = s.get("words")
            if not words:
                raise AssertionError(f"segment without words: {s}")
            for w in words:
                if not s["start"] <= w["start"] <= w["end"] <= s["end"]:
                    raise AssertionError(f"word {w} outside its segment {s['start']}-{s['end']}")
            n_words += len(words)
    log(f"proxy words: {n_words} words inside their segments; first segment "
        f"{[(w['word'], w['start'], w['end']) for w in segs[0]['words'][:4]]}")

    # the temperature ladder: no decode reaches an average log-probability
    # of 10, so every window walks to the last rung; twice, with equal results
    trl = proxy()
    trl._backend.logprob_threshold = 10.0
    trl._backend.no_speech_threshold = None
    rungs = []
    real_decode = transcriber_mod.decode_windows

    def spy(params, dims, tok, mel, opts, rng=None, audio_kv=None):
        rungs.append(opts.temperature)
        return real_decode(params, dims, tok, mel, opts, rng=rng, audio_kv=audio_kv)

    transcriber_mod.decode_windows = spy
    try:
        first = [trl.transcribe(p) for p, _ in paths]
        walked = list(rungs)
        second = [trl.transcribe(p) for p, _ in paths]
    finally:
        transcriber_mod.decode_windows = real_decode
    log(f"proxy ladder: temperatures {walked}; last-rung text '{first[0]['text'][:80]}'")
    if walked != [0.0, 0.2, 0.4, 0.6, 0.8, 1.0] * 2:
        raise AssertionError(f"the ladder did not walk to its last rung: {walked}")
    if not all(r["segments"] for r in first):
        raise AssertionError("the ladder's last rung returned no segments")
    if first != second:
        raise AssertionError("the ladder is not reproducible: two runs differ")

    # language detection returns a code the tokenizer knows
    lang = proxy(language="auto").transcribe(paths[0][0])["language"]
    log(f"proxy language: detected '{lang}'")
    if lang not in LANGUAGES:
        raise AssertionError(f"detected language {lang!r} is not a language code")
    return {"segment_agreement": agree, "int8_segment_agreement": agree8, "words": n_words,
            "ladder_rungs": walked[:6], "language": lang}


# -- phase 6 -----------------------------------------------------------------

VAD_TOL = 1e-5  # ConvVAD probabilities, the CPU tests' tolerance (f32, TF32 off)
EMB_TOL = 1e-5  # ConvEmbedder embeddings, likewise


def proxy_file(rng) -> np.ndarray:
    """The proxy's two held-out sentences in one file: 1 s of silence, a
    sentence, 2 s of silence, the other sentence, 1 s of silence (as
    tests/test_torch_serving.py builds it)."""
    gap = np.zeros(2 * SR, np.float32)
    edge = np.zeros(SR, np.float32)
    sentences = []
    for _ in range(2):
        k = int(rng.integers(12, 27))
        sentences.append(_synth_sentence(list(rng.integers(0, len(_VOCAB), size=k)), rng))
    return np.concatenate([edge, sentences[0], gap, sentences[1], edge])


def serving_config(model: str, weights: str, tokens: int, words: bool):
    from modular_audio_pipeline_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig(lazy_load_models=False)
    t = cfg.transcription
    t.model, t.language, t.weights_path = model, "en", weights
    t.beam_size, t.max_decode_tokens, t.batch_size = 5, tokens, 16
    t.kv_cache_dtype, t.word_timestamps = "int8", words
    t.no_speech_threshold = None  # every window is parsed, as bench.py
    return cfg


def _check_serving(result, seconds: float, label: str) -> None:
    """The mappings are monotone and inside the file, the decode covered
    every 30 s of the kept timeline, segments are well formed."""
    import math

    kept = result["kept_duration"]
    if not 0.0 < kept <= seconds:
        raise AssertionError(f"{label}: kept {kept} s of {seconds} s")
    if result["decode_stats"]["n_windows"] != math.ceil(kept / 30.0):
        raise AssertionError(f"{label}: {result['decode_stats']} for {kept} s kept")
    prev_p, prev_o = 0.0, 0.0
    for m in result["timestamp_mappings"]:
        if not (abs(m.processed_start - prev_p) < 1e-6 and prev_o <= m.original_start
                < m.original_end <= seconds + 1e-6):
            raise AssertionError(f"{label}: mapping out of order or outside the file: {m}")
        prev_p, prev_o = m.processed_end, m.original_end
    if abs(prev_p - kept) > 1e-3:
        raise AssertionError(f"{label}: mappings cover {prev_p} s of {kept} s kept")
    # A segment ends inside the kept audio, but its words may carry it
    # further: the word times of the last window's DTW path can run into
    # the window's zero padding, and the segment takes its words' bounds
    # (the JAX package's _apply_words): bound those by the decoded windows.
    grid = 30.0 * result["decode_stats"]["n_windows"]
    for s in result["segments"]:
        end_bound = grid if s.get("words") else kept
        if not (0.0 <= s["start"] <= min(s["end"], kept + 1e-6) and s["end"] <= end_bound + 1e-6
                and isinstance(s["text"], str)):
            raise AssertionError(f"{label}: malformed segment {s}")
    for d in result["diarization"]:
        if not (d["speaker"].startswith("SPEAKER_") and 0.0 <= d["start"] < d["end"] <= kept + 1e-6):
            raise AssertionError(f"{label}: malformed turn {d}")


def phase_serving(torch, tmp: Path, seconds: float):
    """The main path: ServingPipeline.process at full width (bench.py's
    configuration) on the 8-minute file as int16, with the trained ConvVAD
    and diarization stack; then run_file's JSON, the proxy file through the
    kernels and the plain versions, and the ConvVAD and ConvEmbedder on the
    card against the CPU."""
    from modular_audio_pipeline_tpu_torch.models.diarization.embedding import ConvEmbedder
    from modular_audio_pipeline_tpu_torch.models.diarization.segmentation import SegmentationNet
    from modular_audio_pipeline_tpu_torch.models.vad_net import ConvVAD
    from modular_audio_pipeline_tpu_torch.serving import ServingPipeline

    audio = np.round(bench_audio(seconds) * 32768.0).astype(np.int16)
    t0 = time.perf_counter()
    pipe = ServingPipeline(serving_config("large-v3-turbo", "random:0", 224, True), device="cuda")
    pipe.backend.load()
    torch.cuda.synchronize()
    log(f"serving: random large-v3-turbo loaded in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pipe.process(audio, SR)
    torch.cuda.synchronize()
    log(f"serving: warm-up run {time.perf_counter() - t0:.2f} s")

    from modular_audio_pipeline_tpu_torch.runtime import integrity

    wrappers = _reset_launches()
    fetches = integrity.counts["fetch"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = pipe.process(audio, SR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    fetches = integrity.counts["fetch"] - fetches
    SHARED["serving"] = result
    stages = dict(pipe.last_timings)
    ds = result["decode_stats"]
    log(f"serving: wall {wall:.3f} s, realtime x{seconds / wall:.1f}, kept "
        f"{result['kept_duration']:.3f} s, decode {ds}, segments {len(result['segments'])}, "
        f"turns {len(result['diarization'])}, launches {launches}, host seconds by stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    if not isinstance(pipe._vad_model, ConvVAD):
        raise AssertionError(f"serving: the VAD resolved to {pipe._vad_model!r}, not the ConvVAD")
    dz = pipe._diarizer
    if (dz is None or dz._use_noop or not isinstance(dz._embedder, ConvEmbedder)
            or not isinstance(dz._segmentation, SegmentationNet)):
        raise AssertionError("serving: the diarizer did not load ConvEmbedder + SegmentationNet")
    if not result["segments"] or not result["diarization"]:
        raise AssertionError("serving: no segment or no diarization turn")
    _check_serving(result, seconds, "serving")
    n_batches = len(range(0, ds["n_windows"], pipe.backend.batch_size))
    if fetches < n_batches:
        raise AssertionError(f"serving: {fetches} verified fetches for {n_batches} batches")
    log(f"serving: {fetches} verified decode fetches for {n_batches} batch(es)")
    encoder = pipe.backend.dims.n_audio_layer * n_batches
    if launches["flash_attention"] <= encoder:
        raise AssertionError(f"serving: {launches['flash_attention']} flash launches, the encoder's "
                             f"alone are {encoder}: segmentation did not run the kernel")
    if launches["ancestor_attention"] <= 0:
        raise AssertionError(f"serving: the ancestry kernel was not launched: {launches}")
    log(f"serving: flash launches {launches['flash_attention']} = encoder {encoder} + "
        f"segmentation {launches['flash_attention'] - encoder}")
    busy, top, mine = device_breakdown(torch, lambda: pipe.process(audio, SR), "serving")

    # run_file: the JSON the JAX package writes, key for key
    wav = tmp / "serving.wav"
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav

    write_wav(str(wav), audio.astype(np.float32) / 32768.0, SR)
    out = pipe.run_file(str(wav), str(tmp / "results"))
    if not out.success:
        raise AssertionError(f"serving: run_file failed: {out.error}")
    doc = json.loads(Path(out.output_file).read_text())
    if set(doc["metadata"]["config"]) != {"model", "language", "vad_provider",
                                          "transcription_backend"} or not doc["segments"]:
        raise AssertionError(f"serving: run_file JSON metadata {doc['metadata']}")
    for seg in doc["segments"]:  # merged segments: speaker, start, end, track, text
        if set(seg) != {"speaker", "start", "end", "track", "text"} or not seg["text"]:
            raise AssertionError(f"serving: run_file segment {seg}")
    log(f"serving: run_file wrote {len(doc['segments'])} merged segments in "
        f"{out.metadata['wall_time_s']} s")

    proxy = phase_serving_proxy(torch, tmp)
    return launches, {"wall_s": wall, "realtime_x": seconds / wall,
                      "kept_duration": result["kept_duration"], "decode_stats": ds,
                      "segments": len(result["segments"]), "turns": len(result["diarization"]),
                      "host_s_by_stage": stages, "device_busy_share": busy,
                      "top_kernels_ms": top, "flash_fma_ms": mine["flash_fwd_fma"][0],
                      "run_file_segments": len(doc["segments"]), "proxy": proxy,
                      "verified_fetches": fetches}


def phase_serving_proxy(torch, tmp: Path):
    """The proxy bundle's file through ServingPipeline (word timestamps
    off, segment merging off) once with the kernels and once with the
    plain versions: equal keep intervals and turns, segments as in phase
    5; run_file's segments carry original_start/original_end (merging
    drops them, in both packages). Then the ConvVAD's probabilities and the
    ConvEmbedder's embeddings on the card against the CPU."""
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav
    from modular_audio_pipeline_tpu_torch.serving import ServingPipeline

    audio = proxy_file(np.random.default_rng(500_000))
    seconds = len(audio) / SR
    cfg = serving_config("tiny", str(PROXY), 128, False)
    cfg.segment_merging.enabled = False
    pipe = ServingPipeline(cfg, device="cuda")
    kernel = pipe.process(audio, SR)
    with plain_kernels():
        plain = pipe.process(audio, SR)
    for key in ("timestamp_mappings", "diarization", "kept_duration"):
        if kernel[key] != plain[key]:
            raise AssertionError(f"serving proxy: {key} differs between kernels and plain versions")
    agree = _agreement([kernel["segments"]], [plain["segments"]])
    log(f"serving proxy: {seconds:.2f} s, kept {kernel['kept_duration']:.3f} s, "
        f"{len(kernel['segments'])} segments, {len(kernel['diarization'])} turns; segment "
        f"agreement kernels vs plain {agree:.3f}; text '{kernel['text'][:80]}'")
    if not kernel["segments"] or not kernel["diarization"]:
        raise AssertionError("serving proxy: no segment or no turn")
    _check_serving(kernel, seconds, "serving proxy")

    wav = tmp / "proxy.wav"
    write_wav(str(wav), audio, SR)
    out = pipe.run_file(str(wav), str(tmp / "results"))
    if not out.success or not out.segments:
        raise AssertionError(f"serving proxy: run_file failed: {out.error}")
    for seg in out.segments:
        if not (set(seg) == {"speaker", "start", "end", "text", "original_start", "original_end"}
                and 0.0 <= seg["original_start"] <= seg["original_end"] <= seconds + 1e-6):
            raise AssertionError(f"serving proxy: run_file segment {seg}")

    # the f32 convolutions on the card (TF32 off) against the CPU
    from modular_audio_pipeline_tpu_torch.models.vad_net import ConvVAD
    from modular_audio_pipeline_tpu_torch.vad import load_vad_model

    gpu_vad, _ = load_vad_model(device="cuda")
    cpu_vad, _ = load_vad_model(device="cpu")
    x = torch.from_numpy(bench_audio(60.0))
    feats = ConvVAD.features(x)
    p_gpu = gpu_vad(feats.cuda()).cpu()
    p_cpu = cpu_vad(feats)
    vad_err = (p_gpu - p_cpu).abs().max().item()
    emb_gpu = pipe._diarizer._embedder
    from modular_audio_pipeline_tpu_torch.models.diarization.embedding import ConvEmbedder
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import unflatten_tree

    with np.load(ROOT / "modular_audio_pipeline_tpu/weights/diarization-embedding/params.npz") as z:
        emb_cpu = ConvEmbedder(unflatten_tree({k: z[k] for k in z.files}), device="cpu")
    spans = x[: 32 * 24000].reshape(32, 24000)
    emb_err = float(np.abs(emb_gpu.embed(spans.cuda()) - emb_cpu.embed(spans)).max())
    log(f"serving: ConvVAD card vs CPU max_abs_err {vad_err:.2e} (tol {VAD_TOL}), "
        f"ConvEmbedder {emb_err:.2e} (tol {EMB_TOL})")
    if not (vad_err <= VAD_TOL and emb_err <= EMB_TOL):
        raise AssertionError("serving: ConvVAD or ConvEmbedder on the card disagrees with the CPU")
    return {"segment_agreement": agree, "kept_duration": kernel["kept_duration"],
            "segments": len(kernel["segments"]), "turns": len(kernel["diarization"]),
            "conv_vad_max_abs_err": vad_err, "conv_embedder_max_abs_err": emb_err}


# -- phase 7 -----------------------------------------------------------------

STEM_TOL = 1e-5  # MaskUNet stem, card vs CPU: f32 convolutions (TF32 off) whose
#                 cuDNN algorithms sum in other orders, as the CPU tests hold it to JAX
REPET_TOL = 1e-5  # REPET stems: the same period and median model, FFTs rounded apart
SILERO_TOL = 1e-5  # Silero probabilities: f32 convolutions and LSTM, TF32 off


def voiced_speech(seconds: float, seed: int = 1) -> np.ndarray:
    """Continuous speech of four synthetic voices (the port's copy of the
    JAX package's voice model): tools/bench_configs.voiced_speech, copied,
    since that module loads the JAX package."""
    from modular_audio_pipeline_tpu_torch.training.voices import sample_voice, synth_utterance

    rng = np.random.default_rng(seed)
    voices = [sample_voice(rng) for _ in range(4)]
    n = int(seconds * SR)
    out = np.zeros(n, dtype=np.float32)
    pos = 0
    while pos < n:
        utt = synth_utterance(voices[rng.integers(len(voices))], float(rng.uniform(2.5, 5.0)),
                              rng, pause_prob=0.15)
        take = min(len(utt), n - pos)
        out[pos : pos + take] = utt[:take]
        pos += take + int(rng.uniform(0.08, 0.35) * SR)  # inter-utterance gap
    return out


def music_podcast(seconds: float) -> np.ndarray:
    """Bench config 4's audio: the voiced speech under a repeating music
    loop (tools/bench_configs.music_podcast, copied). Its speech survives
    the MaskUNet (the bundle was trained on such voices); bench_audio's
    harmonic bed would not: after separation the ConvVAD keeps almost
    none of it, and the decode would shrink to one window."""
    speech = voiced_speech(seconds)
    t = np.arange(len(speech)) / SR
    loop = (0.25 * np.sin(2 * np.pi * 98 * t) + 0.15 * np.sin(2 * np.pi * 196.5 * t)
            + 0.1 * np.sin(2 * np.pi * 294 * t))
    return (speech + loop.astype(np.float32)).astype(np.float32)


def silero_state_dict(seed: int = 0) -> dict:
    """A random Silero v5 state_dict (fan-in scaled weights, a DFT basis),
    as tests/test_torch_silero.py builds it: no Silero weights ship."""
    from modular_audio_pipeline_tpu_torch.models.silero_convert import EXPECTED_SHAPES

    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in EXPECTED_SHAPES.items():
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        sd[key] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
    k, n = np.arange(129)[:, None], np.arange(256)[None, :]
    sd["_model.stft.forward_basis_buffer"] = np.concatenate(
        [np.cos(2 * np.pi * k * n / 256), -np.sin(2 * np.pi * k * n / 256)]
    )[:, None, :].astype(np.float32)
    return sd


def two_voices(seconds: float, seed: int) -> np.ndarray:
    """Two synthetic voices taking turns every 4 s (as
    tests/test_torch_diarization.py makes them)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    out = np.zeros(n)
    for i, (f, tilt) in enumerate([(110.0, 0.6), (230.0, 0.25)]):
        f0 = f + 12 * np.sin(2 * np.pi * 0.5 * t + i)
        sig = sum((tilt ** j) * np.sin(2 * np.pi * (j + 1) * np.cumsum(f0) / SR) for j in range(6))
        turn = ((t // 4) % 2 == i) & ((t % 4) < 3.4)
        out += 0.3 * sig * turn * (0.6 + 0.4 * (np.sin(2 * np.pi * 3 * t) > -0.5))
    return (out + 0.002 * rng.standard_normal(n)).astype(np.float32)


def masknet_operations(net, n_samples: int):
    """(padded [F, T], f32 operations) of one MaskUNet call over a chunk of
    ``n_samples``: 2 * in * out * kh * kw per output position of each
    convolution, per input position of each transposed one."""
    f, t = 2048 // 2 + 1, n_samples // 512 + 1
    h, w = f + (-f) % 16, t + (-t) % 16
    ops, size = 0.0, (h, w)
    for lvl in range(4):
        cout, cin, kh, kw = getattr(net, f"down{lvl}_w").shape
        size = (size[0] // 2, size[1] // 2)
        ops += 2.0 * cin * cout * kh * kw * size[0] * size[1]
    cout, cin, kh, kw = net.mid_w.shape
    ops += 2.0 * cin * cout * kh * kw * size[0] * size[1]
    for lvl in reversed(range(4)):
        cout, cin, kh, kw = getattr(net, f"up{lvl}_w").shape
        ops += 2.0 * cin * cout * kh * kw * size[0] * size[1]
        size = (size[0] * 2, size[1] * 2)
    ops += 2.0 * net.head_w.shape[1] * size[0] * size[1]
    return (h, w), ops


@contextlib.contextmanager
def count_beam_steps(counter: list):
    """Count the beam decode's steps: its decoder calls with an ancestry
    table (the prefill and the word alignment pass none)."""
    from modular_audio_pipeline_tpu_torch.models.whisper import decode

    real = decode.decoder_forward

    def spy(*args, **kw):
        counter[0] += kw.get("anc") is not None
        return real(*args, **kw)

    decode.decoder_forward = spy
    try:
        yield
    finally:
        decode.decoder_forward = real


@contextlib.contextmanager
def utilization(samples: list):
    """The card's utilization.gpu (the share of each sample period in which
    a kernel ran), sampled by nvidia-smi every 100 ms inside the block."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
        samples.extend(float(v) / 100.0 for v in out.split() if v.strip().isdigit())


def phase_separation(torch, tmp: Path, seconds: float):
    """Bench config 4 through ServingPipeline on the card, then the
    separation, Silero and StatsEmbedder numerics card against CPU, the
    flash kernel at the large-v3 encoder's batch-8 shape and the ancestry
    kernel at its decode step's (BK = 40, last layer of 32)."""
    import math

    from modular_audio_pipeline_tpu_torch.models.separation.unet import MaskUNet
    from modular_audio_pipeline_tpu_torch.ops.bucketing import bucket_length
    from modular_audio_pipeline_tpu_torch.ops.music import analyze_audio_content
    from modular_audio_pipeline_tpu_torch.serving import ServingPipeline

    mix = music_podcast(seconds)
    audio = np.clip(np.round(mix * 32768.0), -32768, 32767).astype(np.int16)
    analysis = analyze_audio_content(audio.astype(np.float32) / 32768.0, SR, "cuda")
    log(f"separation: music analysis {analysis}")
    cfg = serving_config("large-v3", "random:0", 224, True)
    cfg.transcription.batch_size = 8
    cfg.diarization.enabled = False
    cfg.vocal_separation.enabled = True
    cfg.vocal_separation.auto_detect = True
    t0 = time.perf_counter()
    pipe = ServingPipeline(cfg, device="cuda")
    pipe.backend.load()
    torch.cuda.synchronize()
    log(f"separation: random large-v3 loaded in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pipe.process(audio, SR)
    torch.cuda.synchronize()
    log(f"separation: warm-up run {time.perf_counter() - t0:.2f} s")

    busy: list = []
    steps_seen = [0]
    wrappers = _reset_launches()
    torch.cuda.synchronize()
    with utilization(busy), count_beam_steps(steps_seen):
        t0 = time.perf_counter()
        result = pipe.process(audio, SR)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    stages = dict(pipe.last_timings)
    ds = result["decode_stats"]
    busy_share = sum(busy) / len(busy) if busy else None
    log(f"separation: wall {wall:.3f} s, realtime x{seconds / wall:.1f}, kept "
        f"{result['kept_duration']:.3f} s, decode {ds}, segments {len(result['segments'])}, "
        f"launches {launches}, card utilization {busy_share} over {len(busy)} samples, host "
        "seconds by stage " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    if not (analysis["has_music"] and analysis["confidence"] > 0.5 and result["vocal_separation"]):
        raise AssertionError(f"separation: auto-detect did not choose separation: {analysis}")
    if not isinstance(pipe._separation_net, MaskUNet) or pipe._separation_fn is not None:
        raise AssertionError("separation: the device MaskUNet did not run (host backend resolved)")
    if not result["segments"]:
        raise AssertionError("separation: no segment")
    _check_serving(result, seconds, "separation")
    n_batches = math.ceil(ds["n_windows"] / pipe.backend.batch_size)
    layers = pipe.backend.dims.n_text_layer
    steps = steps_seen[0]
    enc_layers = pipe.backend.dims.n_audio_layer
    if launches["flash_attention"] < enc_layers * n_batches:
        raise AssertionError(f"separation: {launches['flash_attention']} flash launches for "
                             f"{n_batches} batches of a {enc_layers}-layer encoder")
    if steps <= 0 or launches["ancestor_attention"] != layers * steps:
        raise AssertionError(f"separation: {launches['ancestor_attention']} ancestry launches "
                             f"over {steps} decode steps, not {layers} per step")
    log(f"separation: {n_batches} batches, flash {launches['flash_attention']} launches, "
        f"ancestry {launches['ancestor_attention']} = {layers} x {steps} decode steps")

    wav = tmp / "podcast.wav"
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav

    write_wav(str(wav), audio.astype(np.float32) / 32768.0, SR)
    out = pipe.run_file(str(wav), str(tmp / "results"))
    if not out.success or not out.segments:
        raise AssertionError(f"separation: run_file failed: {out.error}")
    log(f"separation: run_file wrote {len(out.segments)} merged segments in "
        f"{out.metadata['wall_time_s']} s")

    chunk = int(cfg.vocal_separation.chunk_minutes * 60 * SR)
    padded, ops = masknet_operations(pipe._separation_net, chunk)
    n_chunks = math.ceil(bucket_length(len(audio), SR) / chunk)
    net = pipe._separation_net
    seg = torch.from_numpy(mix[:chunk].copy()).cuda()
    mag = torch.ones((1, 1025, padded[1]), device="cuda")
    chunk_ms = time_ms(lambda: net.separate_device(seg), 3, warmup=1)
    forward_ms = time_ms(lambda: net(mag), 3, warmup=1)
    del seg, mag
    log(f"separation: MaskUNet over {n_chunks} chunks of {chunk} samples, each a padded "
        f"{list(padded)} spectrogram and {ops / 1e12:.3f} TFLOP of f32 convolutions "
        f"(at least {ops / PEAK_F32_FLOPS * 1e3:.1f} ms at the f32 peak): the network "
        f"{forward_ms:.1f} ms ({ops / forward_ms / 1e9:.1f} TFLOP/s), STFT + mask + iSTFT of a "
        f"chunk {chunk_ms:.1f} ms")
    checks = separation_card_vs_cpu(torch, pipe._separation_net, tmp)
    del pipe, net
    torch.cuda.empty_cache()
    encoder = flash_at(torch, (8, 20, 1500, 64))
    # one decode step of the last layer of the 32-layer int8 cache at BK = 40
    g = torch.Generator(device="cuda").manual_seed(3)
    ancestry, _, _ = _anc_case(torch, g, True, 448, False, bw=8, n_layers=layers, layer=layers - 1)
    torch.cuda.empty_cache()
    return launches, {"wall_s": wall, "realtime_x": seconds / wall,
                      "energy_cv": analysis["energy_cv"], "confidence": analysis["confidence"],
                      "kept_duration": result["kept_duration"], "decode_stats": ds,
                      "segments": len(result["segments"]), "decode_steps": steps,
                      "masknet_padded_spectrogram": list(padded),
                      "masknet_tflop_per_chunk": ops / 1e12, "masknet_chunks": n_chunks,
                      "masknet_forward_ms": forward_ms, "masknet_chunk_ms": chunk_ms,
                      "host_s_by_stage": stages, "card_utilization": busy_share,
                      "utilization_samples": len(busy),
                      "run_file_s": out.metadata["wall_time_s"], "card_vs_cpu": checks,
                      "flash_encoder_batch8": encoder, "ancestry_batch8": ancestry}


def separation_card_vs_cpu(torch, net_gpu, tmp: Path) -> dict:
    """The MaskUNet stem, REPET's period and stems, a random Silero VAD's
    sectioned probabilities and the StatsEmbedder's turns, each on the
    card against the CPU."""
    import os

    from modular_audio_pipeline_tpu_torch.diarizer import SpeakerDiarizer
    from modular_audio_pipeline_tpu_torch.models.diarization.embedding import StatsEmbedder
    from modular_audio_pipeline_tpu_torch.models.separation import repet
    from modular_audio_pipeline_tpu_torch.models.separation.unet import MaskUNet
    from modular_audio_pipeline_tpu_torch.models.silero_convert import convert_state_dict
    from modular_audio_pipeline_tpu_torch.models.vad_net import SileroVAD
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import load_params
    from modular_audio_pipeline_tpu_torch.ops.bucketing import bucket_length, tile_to_length
    from modular_audio_pipeline_tpu_torch.ops.stft import stft
    from modular_audio_pipeline_tpu_torch.serving import _silero_section
    from modular_audio_pipeline_tpu_torch.utils import SHIPPED_WEIGHTS

    x = torch.from_numpy(music_podcast(9.0))
    net_cpu = MaskUNet(load_params(str(SHIPPED_WEIGHTS / "separation-htdemucs")), device="cpu")
    stem = net_gpu.separate_device(x.cuda()).cpu()
    stem_err = (stem - net_cpu.separate_device(x)).abs().max().item()

    clip = music_podcast(12.0)
    tiled = torch.from_numpy(tile_to_length(clip, bucket_length(len(clip), SR)))  # as REPET tiles
    periods = [repet.find_repeating_period(
        stft(tiled.to(d), n_fft=2048, hop=512).abs().cpu().numpy() ** 2, SR)
        for d in ("cuda", "cpu")]
    (gv, gm), (cv, cm) = (repet.repet_separate(clip, SR, device=d) for d in ("cuda", "cpu"))
    repet_err = float(max(np.abs(gv - cv).max(), np.abs(gm - cm).max()))

    tree = convert_state_dict(silero_state_dict())
    vad_gpu, vad_cpu = SileroVAD(tree, device="cuda"), SileroVAD(tree, device="cpu")
    speech = bench_audio(60.0)
    want = vad_cpu.speech_probs(speech, SR)
    h = c = torch.zeros(SileroVAD.HID, device="cuda")
    tail = torch.zeros(SileroVAD.CONTEXT, device="cuda")
    one = torch.ones((), device="cuda")
    parts = []
    section = 37 * 12800  # 29.6 s: a multiple of the 512-sample chunk, as serving's sections
    for s0 in range(0, len(speech), section):  # three sections, the state carried
        p, h, c, tail = _silero_section(vad_gpu, torch.from_numpy(speech[s0:s0 + section]).cuda(),
                                        one, h, c, tail)
        parts.append(p)
    got = torch.cat(parts).cpu().numpy()
    silero_err = float(np.abs(got - want).max())

    root = tmp / "weights"
    root.mkdir(exist_ok=True)
    (root / "diarization-segmentation").symlink_to(SHIPPED_WEIGHTS / "diarization-segmentation")
    timeline = np.zeros(40 * SR, np.float32)
    timeline[: 30 * SR] = two_voices(30.0, 3)
    saved = os.environ.get("MAP_TPU_WEIGHTS")
    os.environ["MAP_TPU_WEIGHTS"] = str(root)
    def turns(device):
        dz = SpeakerDiarizer(device=device)
        segs, _ = dz.diarize_device_timeline(torch.from_numpy(timeline).to(device), 30 * SR, SR,
                                             1, 5)
        if not isinstance(dz._embedder, StatsEmbedder) or dz._segmentation is None:
            raise AssertionError("separation: the diarizer did not take the StatsEmbedder")
        return [(t.speaker, t.start, t.end) for t in segs]

    try:
        gpu_turns, cpu_turns = turns("cuda"), turns("cpu")
    finally:
        if saved is None:
            del os.environ["MAP_TPU_WEIGHTS"]
        else:
            os.environ["MAP_TPU_WEIGHTS"] = saved
    log(f"separation: card vs CPU: MaskUNet stem {stem_err:.2e} (tol {STEM_TOL}); REPET periods "
        f"{periods}, stems {repet_err:.2e} (tol {REPET_TOL}); Silero over three sections "
        f"{silero_err:.2e} (tol {SILERO_TOL}); StatsEmbedder turns {len(gpu_turns)} on the "
        f"card, equal {gpu_turns == cpu_turns}")
    if not (stem_err <= STEM_TOL and periods[0] == periods[1] and repet_err <= REPET_TOL
            and silero_err <= SILERO_TOL and gpu_turns == cpu_turns and cpu_turns):
        raise AssertionError("separation: the card disagrees with the CPU")
    return {"masknet_stem_max_abs_err": stem_err, "repet_period": periods[0],
            "repet_max_abs_err": repet_err, "silero_max_abs_err": silero_err,
            "stats_embedder_turns": len(gpu_turns)}


def flash_at(torch, shape) -> dict:
    """The flash kernel against its plain version at ``shape`` (bf16), and
    its device time beside the plain version's, the library's and the
    bound (as phase 2 computes it)."""
    import torch.nn.functional as F

    from modular_audio_pipeline_tpu_torch.ops.attention import attention_reference, flash_attention

    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    out, ref = flash_attention(q, k, v).float(), attention_reference(q, k, v).float()
    err = (out - ref).abs().max().item()
    if not err <= FLASH_TOL:
        raise AssertionError(f"flash_attention at {shape}: err {err}")
    ms = graph_ms([lambda: flash_attention(q, k, v)] * 4)
    plain_ms = time_ms(lambda: attention_reference(q, k, v), 5)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    b, h, s, d = shape
    bound_ms, bound_by = bound(4 * q.numel() * q.element_size(), 4.0 * b * h * s * s * d)
    exp_ms = b * h * s * s / exp_rate(torch) * 1e3
    if exp_ms > bound_ms:
        bound_ms, bound_by = exp_ms, "operations"
    log(f"flash {shape} bf16: max_abs_err {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": list(shape), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


# -- phase 8 -----------------------------------------------------------------

BATCH_FILES = ("a_meeting.wav", "b_panel_44k_stereo.wav", "c_interview.flac")
JSON_CONFIG_KEYS = {"model", "language", "vad_provider", "transcription_backend"}


def batch_directory(media: Path, seconds: float) -> list:
    """Bench config 5's directory cut to one card and the smoke's time:
    three files of continuous four-voice speech from the port's voice
    model (``voiced_speech`` with seeds 11, 12, 13), as a 16 kHz mono WAV,
    a 44.1 kHz stereo WAV (the right channel at 0.8 of the left; it takes
    the media handler's resample path) and a 16 kHz 16-bit FLAC encoded by
    ``tests/flac_ref.py``. Returns the paths in ``BATCH_FILES`` order."""
    import wave
    from math import gcd

    from scipy.signal import resample_poly

    from modular_audio_pipeline_tpu_torch.audio_io import write_wav

    sys.path.insert(0, str(ROOT / "tests"))
    from flac_ref import encode_flac

    media.mkdir(parents=True, exist_ok=True)
    paths = [media / name for name in BATCH_FILES]
    write_wav(str(paths[0]), voiced_speech(seconds, seed=11), SR)

    g = gcd(44100, SR)
    left = resample_poly(voiced_speech(seconds, seed=12), 44100 // g, SR // g)
    stereo = np.stack([left, 0.8 * left], axis=1)
    pcm = np.clip(np.round(stereo * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(str(paths[1]), "wb") as wf:
        wf.setnchannels(2)
        wf.setsampwidth(2)
        wf.setframerate(44100)
        wf.writeframes(pcm.tobytes())

    pcm = np.clip(np.round(voiced_speech(seconds, seed=13) * 32767.0), -32768, 32767)
    paths[2].write_bytes(encode_flac(pcm.astype(np.int64), SR))
    return paths


def batch_config(media: Path, results: Path):
    """Bench config 5's settings: large-v3-turbo at full width and depth,
    random weights from seed 0, beam 5, 224 tokens, the int8 KV cache, the
    no-speech gate off (as bench.py), the PipelineConfig defaults
    otherwise (faster-whisper, denoise, the Silero-provider VAD on the
    shipped ConvVAD bundle, diarization on the shipped bundles, word
    timestamps, redundancy removal and merging)."""
    from modular_audio_pipeline_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig(media_dir=str(media), results_dir=str(results))
    t = cfg.transcription
    t.model, t.language, t.weights_path = "large-v3-turbo", "en", "random:0"
    t.beam_size, t.max_decode_tokens, t.kv_cache_dtype = 5, 224, "int8"
    t.no_speech_threshold = None
    return cfg


def _check_output_json(path: str, label: str) -> int:
    """The JAX package's output schema; returns the segment count."""
    doc = json.loads(Path(path).read_text(encoding="utf-8"))
    meta = doc.get("metadata", {})
    if set(meta.get("config", {})) != JSON_CONFIG_KEYS or "source_file" not in meta:
        raise AssertionError(f"{label}: metadata {meta} lacks the schema's keys")
    for s in doc["segments"]:
        if not ({"speaker", "start", "end", "text"} <= set(s) and s["start"] <= s["end"]):
            raise AssertionError(f"{label}: segment {s} lacks the schema's keys")
    return len(doc["segments"])


def phase_batch(torch, tmp: Path, seconds: float):
    """Bench config 5: BatchDriver.run() over the directory in this process
    (AudioPipeline per file), then the CLI's serving batch in a subprocess,
    interrupted after its first ledger entry and run again, then the proxy
    bundle's sentences through AudioPipeline with kernels and with plain
    versions."""
    from collections import Counter

    from modular_audio_pipeline_tpu_torch import pipeline as pipeline_mod
    from modular_audio_pipeline_tpu_torch.audio_io import wav_info
    from modular_audio_pipeline_tpu_torch.parallel.batch import BatchDriver
    from modular_audio_pipeline_tpu_torch.runtime import native_lib

    t0 = time.perf_counter()
    media = tmp / "batch"
    paths = batch_directory(media, seconds)
    log(f"batch: made {len(paths)} files of {seconds:.0f} s in {time.perf_counter() - t0:.1f} s")

    results = tmp / "batch_results"
    runs = []
    real_run = pipeline_mod.AudioPipeline.run

    def spy(self, input_file=None):
        out = real_run(self, input_file)
        runs.append((out, getattr(self.vad, "last_cut", None)))
        return out

    wrappers = _reset_launches()
    torch.cuda.synchronize()
    pipeline_mod.AudioPipeline.run = spy
    try:
        t0 = time.perf_counter()
        summary = BatchDriver(batch_config(media, results), device="cuda").run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipeline_mod.AudioPipeline.run = real_run
    launches = {name: w.launches for name, w in wrappers.items()}
    cuts = Counter(cut for _, cut in runs)
    per_file = []
    for out, cut in runs:
        if not out.success:
            raise AssertionError(f"batch: {out.input_file} failed: {out.error}")
        stem = Path(out.output_file).name[: -len("_transcription.json")]
        voiced = sorted(results.glob(f"{stem}*_voice.wav"))
        kept = wav_info(str(voiced[0]))["duration"] if voiced else None
        n_segments = _check_output_json(out.output_file, "batch")
        m = out.metadata
        per_file.append({"file": Path(out.input_file).name, "wall_time_s": m["wall_time_s"],
                         "audio_duration_s": m["audio_duration_s"], "rtf": m["rtf"],
                         "kept_s": kept, "segments": n_segments, "vad_cut": cut,
                         "stage_timings": m["stage_timings"]})
        log(f"batch: {per_file[-1]}")
    log(f"batch: AudioPipeline over {len(runs)} files in {wall:.3f} s, summary {summary}, "
        f"launches {launches}, VAD cuts {dict(cuts)}, native library loaded "
        f"{native_lib._lib is not None}")
    if summary["succeeded"] != len(paths) or summary["failed"] or len(runs) != len(paths):
        raise AssertionError(f"batch: {summary}")
    if launches["flash_attention"] <= 0 or launches["ancestor_attention"] <= 0:
        raise AssertionError(f"batch: AudioPipeline skipped a kernel: {launches}")
    if not native_lib.have_native():
        raise AssertionError("batch: the native library did not load")
    torch.cuda.empty_cache()

    serving = phase_batch_cli(tmp, media)
    proxy = phase_batch_proxy(torch, tmp)
    audio_s = sum(f["audio_duration_s"] for f in per_file)
    return launches, {"files": per_file, "wall_s": wall, "summary": summary,
                      "audio_hours_per_card_hour": audio_s / wall, "vad_cuts": dict(cuts),
                      "serving_cli": serving, "proxy": proxy}


def phase_batch_cli(tmp: Path, media: Path) -> dict:
    """``python -m modular_audio_pipeline_tpu_torch --batch --serving`` over
    the directory in a subprocess, as bench_batch.py drives main.py: SIGINT
    once the first ledger entry lands must exit 130; the rerun must skip
    the finished files and succeed on every file."""
    import re
    import signal

    out_dir = tmp / "serving_results"
    config = tmp / "batch_config.json"
    batch_config(media, out_dir).to_json(str(config))
    cmd = [sys.executable, "-m", "modular_audio_pipeline_tpu_torch", "--batch", "--serving",
           "--config", str(config), "--media-dir", str(media), "--output-dir", str(out_dir)]
    status = out_dir / "batch_status.json"

    def ledger() -> dict:
        try:
            return json.loads(status.read_text())
        except (OSError, ValueError):
            return {}

    log_1 = tmp / "cli_interrupted.log"
    t0 = time.perf_counter()
    with open(log_1, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None and not ledger():
                if time.perf_counter() - t0 > 240:
                    raise AssertionError("batch cli: no ledger entry within 240 s")
                time.sleep(0.05)
            first_entry_s = time.perf_counter() - t0
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    done_before = ledger()
    log(f"batch cli: first ledger entry after {first_entry_s:.1f} s, SIGINT -> exit code {rc}, "
        f"{len(done_before)} of {len(BATCH_FILES)} files in the ledger")
    if rc != 130:
        raise AssertionError(f"batch cli: interrupted run exited {rc}, not 130:\n"
                             + log_1.read_text()[-3000:])

    t0 = time.perf_counter()
    rerun = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    rerun_s = time.perf_counter() - t0
    done = ledger()
    if rerun.returncode != 0:
        raise AssertionError(f"batch cli: rerun exited {rerun.returncode}:\n"
                             + rerun.stdout[-3000:] + rerun.stderr[-2000:])
    skipped = [k for k, v in done_before.items()
               if v.get("success") and done[k]["finished_at"] == v["finished_at"]]
    said = re.search(r"'skipped': (\d+)", rerun.stdout)
    if len(done) != len(BATCH_FILES) or not all(v["success"] for v in done.values()):
        raise AssertionError(f"batch cli: ledger after the rerun {done}")
    if not skipped or said is None or int(said.group(1)) != len(skipped):
        raise AssertionError(f"batch cli: rerun skipped {skipped}, said {said and said.group(0)}")
    n_segments = [_check_output_json(v["output_file"], "batch cli") for v in done.values()]
    ran = [v for k, v in done.items() if k not in skipped]
    ran_audio = sum(v["audio_duration_s"] for v in ran)
    ran_wall = sum(v["wall_time_s"] for v in ran)
    log(f"batch cli: rerun exit 0 in {rerun_s:.1f} s, skipped {len(skipped)}, ran {len(ran)} "
        f"files: {ran_audio:.1f} s of audio in {ran_wall:.3f} s of run_file "
        f"({ran_audio / ran_wall:.1f} audio-hours per card-hour), segments {n_segments}")
    return {"first_entry_s": first_entry_s, "interrupt_rc": rc, "rerun_s": rerun_s,
            "skipped": len(skipped), "ran": len(ran), "ledger": done,
            "audio_hours_per_card_hour": ran_audio / ran_wall}


def phase_batch_proxy(torch, tmp: Path) -> dict:
    """The proxy bundle's file through AudioPipeline (word timestamps off,
    merging off) with the kernels and with the plain versions: equal
    segments and JSON, back-mapped times inside the file."""
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav
    from modular_audio_pipeline_tpu_torch.pipeline import AudioPipeline

    media = tmp / "proxy_media"
    media.mkdir()
    audio = proxy_file(np.random.default_rng(500_000))
    seconds = len(audio) / SR
    wav = media / "proxy.wav"
    write_wav(str(wav), audio, SR)
    cfg = serving_config("tiny", str(PROXY), 128, False)
    cfg.media_dir, cfg.temp_dir, cfg.results_dir = str(media), None, None
    cfg.segment_merging.enabled = False
    cfg.__post_init__()
    pipe = AudioPipeline(cfg, device="cuda")
    kernel = pipe.run(str(wav))
    doc_kernel = Path(kernel.output_file).read_text()
    with plain_kernels():
        plain = pipe.run(str(wav))
    doc_plain = Path(plain.output_file).read_text()
    log(f"batch proxy: {seconds:.2f} s, {len(kernel.segments)} segments, text "
        f"'{' '.join(s['text'] for s in kernel.segments)[:80]}', kernels vs plain: segments "
        f"equal {kernel.segments == plain.segments}, JSON equal {doc_kernel == doc_plain}")
    if not (kernel.success and plain.success and kernel.segments):
        raise AssertionError(f"batch proxy: {kernel.error or plain.error or 'no segment'}")
    if kernel.segments != plain.segments or doc_kernel != doc_plain:
        raise AssertionError("batch proxy: AudioPipeline differs between kernels and plain versions")
    for s in kernel.segments:
        if not 0.0 <= s["original_start"] <= s["original_end"] <= seconds + 1e-6:
            raise AssertionError(f"batch proxy: segment {s}")
    return {"segments": len(kernel.segments), "stage_timings": kernel.metadata["stage_timings"]}


# -- phase 9 -----------------------------------------------------------------

SEEK_SECONDS = 60.0  # phase 8's first voiced file (seed 11), cut to 60 s
SEEK_CHUNK_S = 7  # the streaming session's chunk
LM_PROMPT, LM_NEW = 1536, 256
LM_TOL = 0.1  # bf16 incremental vs teacher-forced logits: max |diff| over max |logit|. The
#               two sum the same products in other orders (GEMV against GEMM), and a
#               1-ulp difference of a bf16 activation (2^-8 relative) moves on through
#               22 layers; 0.1 leaves room for that and fails a wrong cache or position
LM_F32_TOL = 1e-4  # test-small in f32, card against CPU (TF32 off)
SEEK_CONF_TOL = 1e-3  # a segment's mean token log-probability in bf16: the ancestry kernel
#                       differs from its plain version by 1-2 bf16 ulp (ROADMAP.md §C);
#                       the proxy's segments read 1.0e-4 apart on an H100 (PERF.md, PR 8)


@contextlib.contextmanager
def seek_probe(backend, windows: list):
    """Per seek window: its seconds, the prefix length (the prefill's tokens)
    and the highest decode position, from the backend's seek step and the
    decode loop's decoder calls."""
    from modular_audio_pipeline_tpu_torch.models.whisper import decode

    real_step, real_fwd = backend.seek_decode_step, decode.decoder_forward

    def fwd(params, dims, tokens, xa_k, xa_v, cache, *a, **kw):
        w = windows[-1]
        w.setdefault("prefix", int(tokens.shape[1]))
        w["max_pos"] = max(w.get("max_pos", 0), cache.pos + int(tokens.shape[1]) - 1)
        return real_fwd(params, dims, tokens, xa_k, xa_v, cache, *a, **kw)

    def step(chunk, seek, opts, all_tokens):
        import torch

        windows.append({"seek_s": seek / SR})
        t0 = time.perf_counter()
        out = real_step(chunk, seek, opts, all_tokens)
        torch.cuda.synchronize()
        windows[-1].update(seconds=time.perf_counter() - t0, advance_s=out[1] / SR,
                           segments=len(out[0]))
        return out

    backend.seek_decode_step, decode.decoder_forward = step, fwd
    try:
        yield
    finally:
        del backend.seek_decode_step
        decode.decoder_forward = real_fwd


def _seek_segments_ok(segments, seconds: float, label: str) -> None:
    for s in segments:
        if not (0.0 <= s["start"] <= s["end"] <= seconds + 1e-6 and np.isfinite(s["confidence"])
                and isinstance(s["text"], str) and s["text"]):
            raise AssertionError(f"{label}: malformed segment {s}")


def phase_seek(torch, tmp: Path):
    """Phase 9: the seek loop and a streaming session at full width, the
    proxy sentences sequentially through kernels and plain versions, the
    kernels at the seek shapes, the Llama LM at tinyllama-1.1b, and
    AudioPipeline with the LLM tier and sequential chunking."""
    from modular_audio_pipeline_tpu_torch.audio_io import read_wav_raw_int16, write_wav
    from modular_audio_pipeline_tpu_torch.streaming import StreamingSession
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    audio = voiced_speech(SEEK_SECONDS, seed=11)
    wav = tmp / "seek.wav"
    write_wav(str(wav), audio, SR)
    tr = WhisperTranscriber("large-v3-turbo", language="en", weights_path="random:0",
                            beam_size=5, max_decode_tokens=224, word_timestamps=False,
                            chunking="sequential", device="cuda", lazy_load=False)
    b = tr._backend
    b.no_speech_threshold = None  # random weights: every window is parsed

    # 1. the seek loop through WhisperTranscriber
    windows: list = []
    wrappers = _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with seek_probe(b, windows):
        offline = tr.transcribe(str(wav))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    max_pos = max(w["max_pos"] for w in windows)
    for i, w in enumerate(windows):
        log(f"seek window {i}: at {w['seek_s']:.2f} s, {w['seconds']:.3f} s, prefix "
            f"{w['prefix']}, last position {w['max_pos']}, advance {w['advance_s']:.2f} s, "
            f"{w['segments']} segments")
    log(f"seek: {len(windows)} windows, {len(offline['segments'])} segments in {wall:.2f} s "
        f"({SEEK_SECONDS / wall:.1f}x realtime), positions past 447 reached "
        f"{max_pos > 447} (highest {max_pos}), launches {launches}")
    if max_pos <= 447:
        raise AssertionError(f"seek: no window decoded past position 447 (highest {max_pos})")
    if not offline["segments"] or len(windows) < 2:
        raise AssertionError(f"seek: {len(windows)} windows, {len(offline['segments'])} segments")
    _seek_segments_ok(offline["segments"], SEEK_SECONDS, "seek")
    if launches["flash_attention"] <= 0 or launches["ancestor_attention"] <= 0:
        raise AssertionError(f"seek: the seek path skipped a kernel: {launches}")

    # 2. a streaming session over the same audio in 7 s chunks, fed the
    # int16 PCM the file holds, as a capture delivers it
    pcm, _ = read_wav_raw_int16(str(wav))
    t0 = time.perf_counter()
    session = StreamingSession(b)
    emitted = []
    n = SEEK_CHUNK_S * SR
    for start in range(0, len(pcm), n):
        emitted.extend(session.feed(pcm[start : start + n], SR))
    streamed = session.finish()
    stream_s = time.perf_counter() - t0
    same = streamed["segments"] == offline["segments"]
    log(f"streaming: {len(streamed['segments'])} segments ({len(emitted)} before finish) in "
        f"{stream_s:.2f} s, equal to the offline run {same}")
    if not same or streamed["text"] != offline["text"]:
        raise AssertionError("streaming: the session's segments differ from the offline seek loop")
    if emitted != streamed["segments"][: len(emitted)]:
        raise AssertionError("streaming: a segment emitted mid-stream was revised")
    del tr, b, session
    torch.cuda.empty_cache()

    # 3. the proxy bundle's sentences sequentially, kernels against plain versions
    proxy_audio = proxy_file(np.random.default_rng(500_000))
    proxy_wav = tmp / "proxy_seek.wav"
    write_wav(str(proxy_wav), proxy_audio, SR)
    ptr = WhisperTranscriber("tiny", language="en", beam_size=5, weights_path=str(PROXY),
                             max_decode_tokens=128, word_timestamps=False,
                             chunking="sequential", device="cuda")
    kernel = ptr.transcribe(str(proxy_wav))["segments"]
    with plain_kernels():
        plain = ptr.transcribe(str(proxy_wav))["segments"]
    key = lambda segs: [(s["text"], s["start"], s["end"]) for s in segs]  # noqa: E731
    conf = max((abs(a["confidence"] - b["confidence"]) for a, b in zip(kernel, plain)),
               default=0.0)
    log(f"seek proxy: {len(kernel)} segments '{' '.join(s['text'] for s in kernel)[:80]}', "
        f"kernels vs plain: text and times equal {key(kernel) == key(plain)}, confidence "
        f"max diff {conf:.2e} (tol {SEEK_CONF_TOL})")
    if not kernel or key(kernel) != key(plain) or conf > SEEK_CONF_TOL:
        raise AssertionError(f"seek proxy: kernels {kernel} against plain {plain}")
    del ptr

    # 4. the two kernels at the seek shapes
    flash_seek = flash_at(torch, (1, 20, 1500, 64))
    anc_seek = ancestry_at_seek(torch)
    n_win = len(windows)
    flash_seek["launches_per_window"] = launches["flash_attention"] / n_win
    anc_seek["launches_per_window"] = launches["ancestor_attention"] / n_win

    # 5. the Llama LM at tinyllama-1.1b
    lm = phase_lm(torch)

    # 6. AudioPipeline with the LLM tier and sequential chunking
    pipeline = seek_pipeline(torch, tmp, audio)
    return launches, {
        "audio_s": SEEK_SECONDS, "windows": windows, "wall_s": wall,
        "realtime_x": SEEK_SECONDS / wall, "segments": len(offline["segments"]),
        "max_position": max_pos, "streaming_s": stream_s, "streaming_equal": same,
        "proxy_segments": len(kernel), "flash_seek": flash_seek, "ancestry_seek": anc_seek,
        "lm": lm, "pipeline": pipeline,
    }


def ancestry_at_seek(torch) -> dict:
    """The ancestry kernel at the seek loop's decode step (1 window x 5
    beams, 20 heads, ctx 448, int8, shared ancestry): against its plain
    version with time and bound (``_anc_case``), beside
    ``scaled_dot_product_attention`` over K/V rows gathered and dequantised
    beforehand (a yardstick: no library call reads rows by ancestry). Then
    a position past the context, as the seek loop's last steps give it: the
    row must land on position 447 of the last layer, as the plain version
    writes it, and a guard layer past the cache must stay as it was."""
    import torch.nn.functional as F

    from modular_audio_pipeline_tpu_torch.ops.ancestor_attention import (
        ancestor_attention,
        ancestor_attention_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(9)
    numbers, (q, new, anc, mask, layer, pos), mine = _anc_case(
        torch, g, True, 448, True, bw=1, n_layers=4, layer=2)
    bk, h, _, hd = q.shape
    rows = (anc.long() + 0).reshape(bk, -1)  # one window: the row index is the beam
    idx = rows[:, None, :, None].expand(bk, h, rows.shape[1], hd)
    k_sel = (torch.gather(mine[0][layer], 0, idx).float()
             * torch.gather(mine[2][layer], 0, idx[..., 0])[..., None]).to(torch.bfloat16)
    v_sel = (torch.gather(mine[1][layer], 0, idx).float()
             * torch.gather(mine[3][layer], 0, idx[..., 0])[..., None]).to(torch.bfloat16)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k_sel, v_sel, scale=1.0), 50)

    # past the context: a 4-layer cache inside a 5-layer buffer whose last
    # layer is a guard; the row goes to layer 3 at position 447
    q2, cache, new2, anc2, mask2, _, _ = _anc_inputs(torch, True, g, 448, True, bw=1,
                                                     n_layers=5, layer=3)
    guard = [c[4].clone() for c in cache]
    mine2 = [c[:4] for c in cache]
    plain2 = [c[:4].clone() for c in cache]
    y = ancestor_attention(q2, *mine2, 3, anc2, mask2, *new2, 451)
    y_ref = ancestor_attention_reference(q2, *plain2, 3, anc2, mask2, *new2, 451)
    torch.cuda.synchronize()
    err = (y.float() - y_ref.float()).abs().max().item()
    rows_ok = all(torch.equal(a, b) for a, b in zip(mine2, plain2))
    guard_ok = all(torch.equal(c[4], gd) for c, gd in zip(cache, guard))
    at_447 = torch.equal(mine2[0][3, :, :, 447], new2[0][:, :, 0])
    log(f"ancestry past the context (pos 451 of 448): max_abs_err {err:.3e}, cache equal to "
        f"the plain version's {rows_ok}, row at 447 {at_447}, guard layer untouched {guard_ok}; "
        f"sdpa on gathered rows {lib_ms:.4f} ms")
    if not (err <= ANC_TOL and rows_ok and guard_ok and at_447):
        raise AssertionError("ancestor_attention: a row past the context was not clamped to 447")
    return {**numbers, "shape": "BW 1, K 5, H 20, ctx 448, hd 64, int8, shared ancestry",
            "library_ms": None, "sdpa_on_gathered_rows_ms": lib_ms,
            "past_context_max_abs_err": err}


def lm_weight_bytes(params, cfg) -> int:
    """Bytes of the weights one decode step reads: every block, the final
    norm, the head, and one row of the token embedding."""
    n = sum(t.numel() * t.element_size() for t in params["blocks"].values())
    n += params["final_norm"].numel() * params["final_norm"].element_size()
    n += params["lm_head"].numel() * params["lm_head"].element_size()
    return n + cfg.d_model * params["tok_emb"].element_size()


def phase_lm(torch) -> dict:
    """LlamaLM at tinyllama-1.1b (22 layers, d 2048, 32/4 heads, ff 5632,
    vocab 32000), bf16, random weights from a seeded generator on the card:
    a 1,536-token seeded prompt and 256 greedy tokens twice (equal tokens),
    the incremental logits against one teacher-forced forward over the same
    tokens (``LM_TOL``), prefill and per-token times beside the weight bytes
    per token over the card's memory rate; then test-small in f32, card
    against CPU."""
    from modular_audio_pipeline_tpu_torch.models.lm import LLAMA_CONFIGS, LlamaLM
    from modular_audio_pipeline_tpu_torch.models.lm.llama import LMCache, forward, init_params

    cfg = LLAMA_CONFIGS["tinyllama-1.1b"]
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, torch.bfloat16, "cuda")
    lm = LlamaLM(cfg, params=params, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["tok_emb"], params["final_norm"], params["lm_head"],
                                       *params["blocks"].values()])
    log(f"lm: tinyllama-1.1b, {n_params / 1e9:.3f} B parameters initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = np.random.default_rng(21).integers(3, cfg.vocab_size, size=LM_PROMPT).astype(np.int32)
    ctx = min(cfg.max_seq, LM_PROMPT + LM_NEW + 1)

    def prefill():
        cache = LMCache.zeros(cfg, 1, ctx, torch.bfloat16, "cuda")
        return forward(params, cfg, torch.from_numpy(prompt).long().cuda()[None], cache)

    prefill()
    prefill_ms = time_ms(prefill, 3, warmup=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = lm.generate(prompt, max_new_tokens=LM_NEW, temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    again = lm.generate(prompt, max_new_tokens=LM_NEW, temperature=0.0)
    per_token_ms = (gen_s * 1e3 - prefill_ms) / (len(toks) - 1)
    bound_ms = lm_weight_bytes(params, cfg) / PEAK_BYTES * 1e3

    # the incremental logits against the teacher-forced forward
    seq = torch.from_numpy(np.concatenate([prompt, toks[:-1]])).long().cuda()[None]
    full, _ = forward(params, cfg, seq, LMCache.zeros(cfg, 1, ctx, torch.bfloat16, "cuda"))
    teacher = full[0, LM_PROMPT - 1 :]
    logits, cache = prefill()
    steps = [logits[0, -1]]
    for t in toks[:-1]:
        logits, cache = forward(params, cfg, torch.tensor([[int(t)]], device="cuda"), cache)
        steps.append(logits[0, -1])
    inc = torch.stack(steps)
    rel = ((inc - teacher).abs().max() / teacher.abs().max()).item()
    argmax_same = (inc.argmax(-1) == teacher.argmax(-1)).float().mean().item()
    greedy_same = bool((inc.argmax(-1).cpu().numpy() == toks).all())
    del full, teacher, inc, cache, logits
    log(f"lm: prefill {LM_PROMPT} tokens {prefill_ms:.2f} ms, {len(toks)} greedy tokens in "
        f"{gen_s:.2f} s, {per_token_ms:.3f} ms per token against a bound of {bound_ms:.4f} ms "
        f"(weight bytes per token over {PEAK_BYTES / 1e12:.2f} TB/s); two runs equal "
        f"{np.array_equal(toks, again)}; incremental vs teacher-forced logits: max diff "
        f"{rel:.4f} of the largest logit (tol {LM_TOL}), argmax equal at {argmax_same:.3f} of "
        f"the positions, the incremental argmax is the generated token {greedy_same}")
    if not (np.array_equal(toks, again) and len(toks) == LM_NEW and rel <= LM_TOL
            and greedy_same):
        raise AssertionError("lm: tinyllama-1.1b generation is not reproducible or drifts")
    del lm, params
    torch.cuda.empty_cache()

    # test-small in f32: the card against the CPU
    small = LLAMA_CONFIGS["test-small"]
    cpu = init_params(small, torch.Generator().manual_seed(4), torch.float32, "cpu")
    card_p = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict) else v.cuda())
              for k, v in cpu.items()}
    toks_in = torch.arange(5, 37)[None]
    want, _ = forward(cpu, small, toks_in, LMCache.zeros(small, 1, 64, torch.float32))
    got, _ = forward(card_p, small, toks_in.cuda(), LMCache.zeros(small, 1, 64, torch.float32,
                                                                 "cuda"))
    err = (got.cpu() - want).abs().max().item()
    p = np.arange(8, dtype=np.int32)
    g_cpu = LlamaLM(small, params=cpu).generate(p, max_new_tokens=24, temperature=0.0)
    g_card = LlamaLM(small, params=card_p, device="cuda").generate(p, max_new_tokens=24,
                                                                   temperature=0.0)
    log(f"lm test-small f32: card vs CPU logits max_abs_err {err:.3e} (tol {LM_F32_TOL}), "
        f"greedy tokens equal {np.array_equal(g_cpu, g_card)}")
    if not (err <= LM_F32_TOL and np.array_equal(g_cpu, g_card)):
        raise AssertionError("lm: test-small differs between the card and the CPU")
    return {"config": "tinyllama-1.1b", "parameters": n_params, "prompt": LM_PROMPT,
            "new_tokens": len(toks), "prefill_ms": prefill_ms, "generate_s": gen_s,
            "ms_per_token": per_token_ms, "bound_ms_per_token": bound_ms,
            "incremental_vs_teacher_rel": rel, "argmax_equal_share": argmax_same,
            "test_small_f32_max_abs_err": err}


def seek_pipeline(torch, tmp: Path, audio: np.ndarray) -> dict:
    """AudioPipeline at phase 8's configuration with chunking="sequential"
    and llm.enabled (no OpenAI key, no local model: the heuristic tier),
    then the same file with batched chunking; compare_transcriptions
    between the two JSONs."""
    import os
    import shutil

    from modular_audio_pipeline_tpu_torch.audio_io import write_wav
    from modular_audio_pipeline_tpu_torch.evaluation import compare_transcriptions
    from modular_audio_pipeline_tpu_torch.pipeline import AudioPipeline

    media, results = tmp / "seek_media", tmp / "seek_results"
    media.mkdir()
    wav = media / "meeting.wav"
    write_wav(str(wav), audio, SR)
    os.environ.pop("OPENAI_API_KEY", None)
    docs = {}
    for chunking in ("sequential", "batched"):
        cfg = batch_config(media, results)
        cfg.transcription.chunking = chunking
        cfg.llm.enabled = True
        pipe = AudioPipeline(cfg, device="cuda")
        info = pipe.llm_processor.get_backend_info()
        out = pipe.run(str(wav))
        if not out.success:
            raise AssertionError(f"seek pipeline ({chunking}): {out.error}")
        n = _check_output_json(out.output_file, f"seek pipeline {chunking}")
        doc = json.loads(Path(out.output_file).read_text(encoding="utf-8"))
        docs[chunking] = tmp / f"seek_{chunking}.json"
        shutil.copy(out.output_file, docs[chunking])
        log(f"seek pipeline {chunking}: {n} segments, llm {info}, llm_analysis in the JSON "
            f"{'llm_analysis' in doc}, stage timings {out.metadata['stage_timings']}")
        if info["backend"] != "heuristic" or "llm_analysis" not in doc or not n:
            raise AssertionError(f"seek pipeline ({chunking}): llm {info}, {n} segments")
        del pipe
        torch.cuda.empty_cache()
    cmp = compare_transcriptions(str(docs["batched"]), str(docs["sequential"]))
    log(f"seek pipeline: sequential against batched {json.dumps(cmp)}")
    return {"compare_sequential_to_batched": cmp}


# -- phase 10 ----------------------------------------------------------------

TRAIN_LOSS_RTOL = 1e-5  # step-0 loss, kernels vs plain versions, f32
TRAIN_GRAD_REL = 1e-3  # step-0 gradient of each leaf, kernels vs plain versions: the norm of
#   the difference over the norm of the plain gradient. The kernel's f32 output differs from
#   the plain version's by under FLASH_TOL_F32 per element; 32 encoder layers carry that into
#   every gradient behind the first attention
SMALL_LOSS_RTOL = 1e-4  # a small trainer's step-0 loss, card vs CPU: f32 (TF32 off) FFTs,
#   convolutions and, for the segmentation network, the flash route in another order
FLASH_GRAD_TOL = FLASH_TOL_F32  # q/k/v gradients through the kernel's autograd.Function vs
#   autograd through the plain version, over the largest |gradient|: the backward is the same
#   recompute; only the forward saved for nothing differs
TRAIN_SHAPE = (8, 20, 1500, 64)  # the turbo encoder's attention at train.py's batch 8
TRAIN_STEPS = 4  # timed steps after one warm-up step


@contextlib.contextmanager
def plain_recompute():
    """Bind the Whisper model's flash calls to the plain version under
    activation checkpointing: the plain forward, and in the backward the
    recompute the kernel's autograd.Function makes. Without it the plain
    version would keep the [8, 20, 1500, 1500] f32 probabilities of all 32
    layers for the backward, 46 GB."""
    from torch.utils.checkpoint import checkpoint

    from modular_audio_pipeline_tpu_torch.models.whisper import model
    from modular_audio_pipeline_tpu_torch.ops.attention import attention_reference

    saved = model.flash_attention
    model.flash_attention = lambda q, k, v: checkpoint(attention_reference, q, k, v,
                                                       use_reentrant=False)
    try:
        yield
    finally:
        model.flash_attention = saved


def _leaf_names(tree, prefix=""):
    out = []
    for k, v in tree.items():
        out += _leaf_names(v, f"{prefix}/{k}") if isinstance(v, dict) else [f"{prefix}/{k}"]
    return out


def train_whisper(torch, tmp: Path) -> tuple:
    """Phase 10a: large-v3-turbo fine-tuning at full width through
    ``training.train``'s setup (f32, AdamW lr 1e-5, weight decay 0.01,
    batch 8, seq-len 224) on 8 synthetic sentences."""
    from modular_audio_pipeline_tpu_torch.models.vad_net import no_tf32
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import (
        load_params, params_from_numpy, params_to_numpy, save_params)
    from modular_audio_pipeline_tpu_torch.ops.attention import flash_attention
    from modular_audio_pipeline_tpu_torch.training import synth_asr, train
    from modular_audio_pipeline_tpu_torch.training.whisper_train import _forward_loss, tree_leaves

    manifest, _ = synth_asr.make_dataset(str(tmp / "asr"), n_train=8, n_eval=1, seed=0)
    SHARED["train_manifest"] = manifest
    out = tmp / "finetuned"
    args = train.parse_args(["--manifest", manifest, "--model", "large-v3-turbo",
                             "--weights", "random:0", "--out", str(out)])
    t0 = time.perf_counter()
    backend, dataset, state, train_step = train.setup(args, device="cuda")
    batch = train.to_device(train.pad_batch(*next(dataset.batches(epoch=0)), 1), backend.device)
    torch.cuda.synchronize()
    dims, params = backend.dims, state.params
    names, leaves = _leaf_names(params), tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    log(f"train: random {args.model} f32 ({n_params / 1e6:.1f} M parameters) and a batch of "
        f"{batch[0].shape[0]} x {batch[1].shape[1]} tokens ready in {time.perf_counter() - t0:.1f} s")

    def loss_and_grads():
        with no_tf32():
            loss = _forward_loss(params, dims, *batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    # step 0: the loss and every leaf's gradient through the kernel, then
    # through the plain version
    wrappers = _reset_launches()
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    grad_launches = wrappers["flash_attention"].launches
    with plain_recompute():
        loss_p, grads_p = loss_and_grads()
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    worst, worst_name = 0.0, ""
    for name, gk, gp in zip(names, grads_k, grads_p):
        rel = ((gk - gp).norm() / gp.norm().clamp_min(1e-30)).item()
        if not rel <= TRAIN_GRAD_REL:
            raise AssertionError(f"train: gradient of {name} {rel:.3e} from the plain version's "
                                 f"(bound {TRAIN_GRAD_REL})")
        if rel > worst:
            worst, worst_name = rel, name
    grads = dict(zip(names, grads_k))
    plain = dict(zip(names, grads_p))
    for leaf in ("q_w", "k_w"):  # the guard against a graph cut at the kernel
        key = f"/encoder/blocks/attn/{leaf}"
        for layer in range(dims.n_audio_layer):
            gk, gp = grads[key][layer], plain[key][layer]
            rel = ((gk - gp).norm() / gp.norm().clamp_min(1e-30)).item()
            if not (gk.abs().max().item() > 0 and rel <= TRAIN_GRAD_REL):
                raise AssertionError(f"train: encoder block {layer} {leaf} gradient "
                                     f"max {gk.abs().max().item():.3e}, {rel:.3e} from plain")
    log(f"train step 0: loss {loss_k.item():.6f} (plain {loss_p.item():.6f}, rel {loss_rel:.2e}, "
        f"tol {TRAIN_LOSS_RTOL}); worst leaf gradient {worst:.2e} from plain ({worst_name}, "
        f"bound {TRAIN_GRAD_REL}); every encoder block's attn q_w/k_w gradient non-zero; "
        f"{grad_launches} flash launches")
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_launches == dims.n_audio_layer):
        raise AssertionError(f"train step 0: loss rel {loss_rel}, launches {grad_launches}")
    SHARED["train_loss0"] = loss_k.item()
    del grads_k, grads_p, grads, plain
    torch.cuda.empty_cache()

    # one warm-up step, then TRAIN_STEPS timed steps on the same batch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, loss = train_step(state, *batch)
    losses = [loss]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    wrappers = _reset_launches()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, loss = train_step(state, *batch)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = {name: w.launches for name, w in wrappers.items()}
    losses = [x.item() for x in losses]
    peak = torch.cuda.max_memory_allocated()
    n = batch[0].shape[0]
    log(f"train: warm-up step {warm_s:.2f} s; {step_s * 1e3:.1f} ms per step, "
        f"{n / step_s:.2f} samples/s; losses {[round(x, 5) for x in losses]}; peak memory "
        f"{peak / 2**30:.2f} GiB; launches over {TRAIN_STEPS} steps {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses}")
    if launches["flash_attention"] != dims.n_audio_layer * TRAIN_STEPS:
        raise AssertionError(f"train: {launches['flash_attention']} flash launches in "
                             f"{TRAIN_STEPS} steps, not {dims.n_audio_layer} per step")

    # the checkpoint: params.npz in the JAX layout, reloaded, one forward
    t0 = time.perf_counter()
    save_params(params_to_numpy(state.params), str(out))
    reloaded = params_from_numpy(load_params(str(out)), "cuda", torch.float32)
    with torch.no_grad(), no_tf32():
        a = _forward_loss(state.params, dims, *batch)
        b = _forward_loss(reloaded, dims, *batch)
    same = torch.equal(a, b)
    log(f"train: params.npz saved, reloaded and run in {time.perf_counter() - t0:.1f} s; "
        f"loss {a.item():.6f} before and {b.item():.6f} after, bit-equal {same}")
    if not same:
        raise AssertionError("train: the reloaded checkpoint computes other bits")
    del state, backend, reloaded, batch, params, leaves
    torch.cuda.empty_cache()
    return launches, {"step_ms": step_s * 1e3, "samples_per_s": n / step_s, "warmup_s": warm_s,
                      "losses": losses, "peak_memory_bytes": peak, "parameters": n_params,
                      "step0_loss_rel": loss_rel, "step0_worst_grad_rel": worst,
                      "step0_worst_grad_leaf": worst_name, "encoder_layers": dims.n_audio_layer}


def flash_training_shape(torch) -> dict:
    """Phase 10c, and the kernel at the training shape: the f32 CUDA-core route
    at [8, 20, 1500, 64] against its plain version, timed beside
    ``scaled_dot_product_attention`` in f32 and its f32 bound; the backward
    recompute's time; the autograd.Function's q/k/v gradients against
    autograd through the plain version there and at a ragged [2, 4, 1001, 32]."""
    import torch.nn.functional as F

    from modular_audio_pipeline_tpu_torch.ops.attention import attention_reference, flash_attention

    g = torch.Generator(device="cuda").manual_seed(10)

    def grads_of(fn, q, k, v, go):
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = fn(qs, ks, vs)
        return out.detach(), torch.autograd.grad(out, (qs, ks, vs), go)

    grad_errs = {}
    for shape in (TRAIN_SHAPE, (2, 4, 1001, 32)):
        q, k, v, go = (torch.randn(shape, generator=g, device="cuda") for _ in range(4))
        before = flash_attention.launches
        out, gk = grads_of(flash_attention, q, k, v, go)
        if flash_attention.launches != before + 1:
            raise AssertionError("flash gradient: the forward did not launch the kernel once")
        ref, gp = grads_of(attention_reference, q, k, v, go)
        err = (out - ref).abs().max().item()
        gerr = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(gk, gp))
        log(f"flash gradient f32 {shape}: output max_abs_err {err:.3e} (tol {FLASH_TOL_F32}), "
            f"q/k/v gradients {gerr:.3e} of the largest (tol {FLASH_GRAD_TOL})")
        if not (err <= FLASH_TOL_F32 and gerr <= FLASH_GRAD_TOL):
            raise AssertionError(f"flash gradient at {shape}: err {err}, gradient {gerr}")
        grad_errs[str(list(shape))] = gerr
        del q, k, v, go, out, gk, ref, gp
        torch.cuda.empty_cache()

    q, k, v, go = (torch.randn(TRAIN_SHAPE, generator=g, device="cuda") for _ in range(4))
    err = (flash_attention(q, k, v) - attention_reference(q, k, v)).abs().max().item()
    ms = graph_ms([lambda: flash_attention(q, k, v)] * 2, reps=3)
    plain_ms = time_ms(lambda: attention_reference(q, k, v), 2, warmup=1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 5)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    backward_ms = time_ms(lambda: torch.autograd.grad(attention_reference(qs, ks, vs),
                                                      (qs, ks, vs), go), 2, warmup=1)
    b, h, s, d = TRAIN_SHAPE
    n_bytes = 4 * q.numel() * q.element_size()
    bound_ms, bound_by = bound(n_bytes, 4.0 * b * h * s * s * d, PEAK_F32_FLOPS)
    exp_ms = b * h * s * s / exp_rate(torch) * 1e3
    if exp_ms > bound_ms:
        bound_ms, bound_by = exp_ms, "operations"
    log(f"flash f32 {TRAIN_SHAPE} (training): kernel {ms:.3f} ms on the device, plain "
        f"{plain_ms:.3f} ms, sdpa f32 {lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); "
        f"the backward recompute {backward_ms:.3f} ms")
    if not err <= FLASH_TOL_F32:
        raise AssertionError(f"flash_attention at {TRAIN_SHAPE} f32: err {err}")
    del q, k, v, go, qs, ks, vs
    torch.cuda.empty_cache()
    return {"shape": list(TRAIN_SHAPE), "dtype": "float32", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "backward_recompute_ms": backward_ms,
            "grad_max_rel_err": grad_errs}


def small_trainers(torch, tmp: Path) -> tuple:
    """Phase 10b: the VAD, embedder, segmentation and separation trainers,
    5 steps each on the card from their shipped bundles, the step-0 loss
    against one step on the CPU, the saved checkpoint reloaded bit for bit."""
    from modular_audio_pipeline_tpu_torch.models.diarization.embedding import ConvEmbedder
    from modular_audio_pipeline_tpu_torch.models.diarization.segmentation import SegmentationNet
    from modular_audio_pipeline_tpu_torch.models.separation.unet import MaskUNet
    from modular_audio_pipeline_tpu_torch.models.vad_net import ConvVAD
    from modular_audio_pipeline_tpu_torch.models.whisper.convert import load_params
    from modular_audio_pipeline_tpu_torch.training import diarization, separation, vad
    from modular_audio_pipeline_tpu_torch.utils import SHIPPED_WEIGHTS

    # (trainer, bundle, module, where the checkpoint lands, arguments)
    runs = {
        "vad": (vad.train_vad, "vad-silero", ConvVAD, "vad-silero",
                dict(n_train_clips=64, eval_clips=16)),
        "embedder": (diarization.train_embedder, "diarization-embedding", ConvEmbedder, "", {}),
        "segmentation": (diarization.train_segmentation, "diarization-segmentation",
                         SegmentationNet, "", {}),
        "separation": (separation.train_separator, "separation-htdemucs", MaskUNet, "", {}),
    }
    out, launches = {}, {}
    for name, (fn, bundle, cls, sub, kw) in runs.items():
        stamps, losses = [], []

        def on_step(i, loss):
            losses.append(loss.item())
            stamps.append(time.perf_counter())

        wrappers = _reset_launches()
        t0 = time.perf_counter()
        fn(str(tmp / "small" / name), steps=5, params=str(SHIPPED_WEIGHTS / bundle),
           device="cuda", on_step=on_step, **kw)
        total_s = time.perf_counter() - t0
        launches[name] = wrappers["flash_attention"].launches
        cpu_losses = []
        fn(str(tmp / "small_cpu" / name), steps=1, params=str(SHIPPED_WEIGHTS / bundle),
           device="cpu", on_step=lambda i, loss: cpu_losses.append(loss.item()), **kw)
        rel = abs(losses[0] - cpu_losses[0]) / abs(cpu_losses[0])
        saved = load_params(str(tmp / "small" / name / sub))
        back = cls(saved, device="cuda").numpy_params()
        same = _trees_equal(back, saved)
        step_ms = (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3
        log(f"train {name}: losses {[round(x, 5) for x in losses]}; step 0 {losses[0]:.6f} on the "
            f"card, {cpu_losses[0]:.6f} on the CPU (rel {rel:.2e}, tol {SMALL_LOSS_RTOL}); "
            f"{step_ms:.1f} ms per step after the first (host data synthesis included), "
            f"{total_s:.1f} s in all; flash launches {launches[name]}; reloaded bit-equal {same}")
        if not (all(np.isfinite(losses)) and len(losses) == 5 and rel <= SMALL_LOSS_RTOL
                and same):
            raise AssertionError(f"train {name}: losses {losses}, CPU {cpu_losses}, "
                                 f"reloaded equal {same}")
        out[name] = {"losses": losses, "cpu_step0_loss": cpu_losses[0], "step0_rel": rel,
                     "step_ms": step_ms, "total_s": total_s}
    if launches["segmentation"] != 5 * SegmentationNet.LAYERS:
        raise AssertionError(f"train segmentation: {launches['segmentation']} flash launches")
    return launches, out


def _trees_equal(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    return all(_trees_equal(a[k], b[k]) if isinstance(a[k], dict)
               else np.array_equal(a[k], np.asarray(b[k], np.float32)) for k in a)


def phase_training(torch, tmp: Path):
    """Phase 10: the training path."""
    t0 = time.perf_counter()
    launches, whisper = train_whisper(torch, tmp)
    log(f"phase 10a done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    flash = flash_training_shape(torch)
    flash["launches_per_step"] = launches["flash_attention"] // TRAIN_STEPS
    whisper["backward_recompute_share"] = (flash["backward_recompute_ms"]
                                           * whisper["encoder_layers"] / whisper["step_ms"])
    log(f"phase 10c done in {time.perf_counter() - t0:.1f} s; the backward recompute is "
        f"{whisper['backward_recompute_share']:.3f} of a step")
    t0 = time.perf_counter()
    small_launches, small = small_trainers(torch, tmp)
    log(f"phase 10b done in {time.perf_counter() - t0:.1f} s")
    return launches, {"whisper_turbo": whisper, "small": small, "flash_train": flash,
                      "segmentation_flash_launches": small_launches["segmentation"]}


# -- phase 11 ----------------------------------------------------------------

CHECKSUM_DTYPES = ("int8", "int16", "int32", "int64", "float16", "bfloat16", "float32")
TP_LOGIT_TOL = 0.1  # bf16 logits, unsharded vs the model axis of 2: max |diff| over max |logit|.
#   The split moves the one rounding to bf16 of 76 row-parallel outputs (32 encoder layers x 2,
#   4 decoder layers x 3) from a bf16 product to an f32 sum of two f32 halves; at random weights
#   those one-ulp differences (2^-8 relative) carry through 36 residual layers. The same bound
#   as LM_TOL, which holds two evaluation orders of one bf16 model's logits.
TP_LOSS_RTOL = 1e-3  # f32 loss, the model axis of 2 vs phase 10's unsharded step 0
MESH_WORLD_S = 480  # wall-clock limit of the two-rank world (ranks killed after it)


def integrity_on_card(torch) -> dict:
    """Phase 11a: the device checksum on the card against the host's for
    every dtype the port uploads or fetches, at odd sizes; a zeroed device
    copy refused; the verified upload of large-v3-turbo's bf16 parameters,
    timed; the checksum of one decode batch's buffers, timed."""
    from modular_audio_pipeline_tpu_torch.exceptions import FetchIntegrityError
    from modular_audio_pipeline_tpu_torch.models.whisper.config import WHISPER_DIMS
    from modular_audio_pipeline_tpu_torch.models.whisper.model import init_params
    from modular_audio_pipeline_tpu_torch.runtime.integrity import (
        checksum_device,
        fetch_verified_many,
        host_checksum,
        put_verified_tree,
    )

    g = torch.Generator(device="cuda").manual_seed(11)
    for name in CHECKSUM_DTYPES:
        for n in (1, 3, 7, 1001, (1 << 22) + 5):
            x = (torch.randn(n, generator=g, device="cuda") * 1000).to(getattr(torch, name))
            host = x.cpu().contiguous().view(torch.uint8).numpy()
            if int(checksum_device([x]).cpu()[0]) != int(host_checksum(host)):
                raise AssertionError(f"integrity: device checksum of {name}[{n}] != host's")
    x = torch.arange(1, 100_001, device="cuda", dtype=torch.int32)
    try:
        fetch_verified_many([x], checksum_device([torch.zeros_like(x)]), ["x"], retries=1)
        raise AssertionError("integrity: a zeroed device copy verified")
    except FetchIntegrityError:
        pass
    log(f"integrity: device checksums equal the host's for {', '.join(CHECKSUM_DTYPES)} "
        "at 5 sizes each; a zeroed copy is refused")

    dims = WHISPER_DIMS["large-v3-turbo"]
    tree = init_params(dims, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16, "cuda")

    def to_host(t):
        return {k: to_host(v) if isinstance(v, dict) else v.cpu() for k, v in t.items()}

    host = to_host(tree)
    del tree
    torch.cuda.empty_cache()
    n_params = sum(v.numel() for v in _leaves_of(host))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = put_verified_tree(host, "cuda", name="whisper")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = [h.to("cuda") for h in _leaves_of(host)]
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del dev, plain, host
    torch.cuda.empty_cache()
    log(f"integrity: verified upload of random large-v3-turbo bf16 ({n_params / 1e6:.1f} M "
        f"parameters) {upload_s:.2f} s, a plain upload {plain_s:.2f} s")

    # one decode batch of phase 6 (16 windows x 5 beams, 224 tokens): its
    # checksums on the device, timed
    bufs = [torch.randint(0, 51865, (80, 224), generator=g, device="cuda"),
            torch.randn(80, generator=g, device="cuda"),
            torch.randint(0, 51865, (16, 5, 224), generator=g, device="cuda"),
            torch.randn((16, 5), generator=g, device="cuda"), torch.rand(16, device="cuda")]
    chk_ms = time_ms(lambda: checksum_device(bufs), 20)
    log(f"integrity: checksums of one decode batch's five buffers {chk_ms:.3f} ms")
    return {"parameters": n_params, "verified_upload_s": upload_s, "plain_upload_s": plain_s,
            "checksum_ms_per_batch": chk_ms}


def _leaves_of(tree):
    for v in tree.values():
        yield from (_leaves_of(v) if isinstance(v, dict) else [v])


def _seg_keys(segments):
    return [(s["start"], s["end"], s["text"]) for s in segments]


def world_of_one(torch, audio) -> dict:
    """Phase 11b: a world of one rank over NCCL (no torchrun) and a mesh of
    size 1 under phase 6's configuration: the segments and turns of
    phase 6's timed run."""
    from modular_audio_pipeline_tpu_torch.config import TPUConfig
    from modular_audio_pipeline_tpu_torch.parallel.mesh import build_mesh
    from modular_audio_pipeline_tpu_torch.serving import ServingPipeline

    mesh = build_mesh(TPUConfig(mesh_shape={"data": 1}), "cuda")
    backend = torch.distributed.get_backend()
    pipe = ServingPipeline(serving_config("large-v3-turbo", "random:0", 224, True),
                           device="cuda", mesh=mesh)
    t0 = time.perf_counter()
    result = pipe.process(audio, SR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = SHARED["serving"]
    same_segments = _seg_keys(result["segments"]) == _seg_keys(ref["segments"])
    same_turns = result["diarization"] == ref["diarization"]
    log(f"mesh of one ({backend}): process {wall:.2f} s (first run in a new pipeline), "
        f"{len(result['segments'])} segments equal to phase 6's {same_segments}, "
        f"{len(result['diarization'])} turns equal {same_turns}")
    if backend != "nccl" or not (same_segments and same_turns):
        raise AssertionError("mesh of one: the result differs from the unmeshed run's")
    del pipe
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return {"backend": backend, "wall_s": wall, "segments": len(result["segments"]),
            "turns": len(result["diarization"])}


def mesh_world(torch, tmp: Path) -> dict:
    """Phase 11c: two ranks of this script on the one card over gloo (NCCL
    refuses a card twice), started together and killed at MESH_WORLD_S.
    Each runs :func:`mesh_rank`; the results are held here."""
    import os

    out = tmp / "mesh_world"
    out.mkdir()
    spec = {"store": f"file://{out / 'store'}", "out": str(out), "tmp": str(tmp),
            "proxy": SHARED["proxy"]["paths"], "manifest": SHARED["train_manifest"]}
    (out / "spec.json").write_text(json.dumps(spec))
    gc.collect()
    torch.cuda.empty_cache()
    # both ranks on cuda:0; their training steps peak together
    env = dict(os.environ, LOCAL_RANK="0", PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = []
    for r in range(2):
        with open(out / f"rank{r}.log", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                 str(out / "spec.json"), str(r)], env=env, stdout=subprocess.DEVNULL, stderr=err))
    t0 = time.perf_counter()
    end = time.monotonic() + MESH_WORLD_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [p for p in procs if p.poll() is None]
        for p in late:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for r in range(2):
        for line in (out / f"rank{r}.log").read_text().splitlines()[-60:]:
            log(f"  rank {r}: {line}")
    if late or any(p.returncode != 0 for p in procs):
        raise AssertionError(f"mesh world: ranks {[p.returncode for p in procs]} "
                             f"({'killed at the limit' if late else 'failed'})")
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    ref = SHARED["proxy"]
    for r, res in enumerate(ranks):
        for key, want in (("proxy_model2", ref["bf16"]), ("proxy_data2", ref["bf16"]),
                          ("proxy_int8_data2", ref["int8"]), ("proxy_int8_model2", ref["int8"])):
            got = res[key]
            if [_seg_keys(s) for s in got] != [_seg_keys(s) for s in want]:
                raise AssertionError(f"mesh world rank {r}: {key} segments {got} != {want}")
    if ranks[0]["serving_segments"] != ranks[1]["serving_segments"]:
        raise AssertionError("mesh world: the two model ranks assembled other segments")
    r0 = ranks[0]
    rel = r0["logits_max_abs_diff"] / r0["logits_max_abs"]
    loss_rel = abs(r0["train_loss"] - SHARED["train_loss0"]) / abs(SHARED["train_loss0"])
    log(f"mesh world: wall {wall:.1f} s; proxy tokens and segments under model=2, data=2 and "
        f"int8 equal phase 5's; turbo TP serving {r0['serving_wall_s']:.2f} / "
        f"{ranks[1]['serving_wall_s']:.2f} s per rank, {r0['serving_n_segments']} segments, "
        f"launches {r0['serving_launches']}; first-step logits max |diff| "
        f"{r0['logits_max_abs_diff']:.4f} of max |logit| {r0['logits_max_abs']:.3f} "
        f"({rel:.4f}, bound {TP_LOGIT_TOL}); decode step {r0['step_ms']:.2f} ms with "
        f"{r0['all_reduces_per_step']} all-reduces taking {r0['collective_ms']:.2f} ms "
        f"({r0['collective_ms'] / r0['step_ms']:.3f} of a step); train step loss "
        f"{r0['train_loss']:.6f} vs phase 10's {SHARED['train_loss0']:.6f} (rel {loss_rel:.2e}, "
        f"bound {TP_LOSS_RTOL}), {r0['train_step_s']:.2f} s, peak {r0['train_peak_gib']:.1f} GiB "
        "a rank")
    if not rel <= TP_LOGIT_TOL:
        raise AssertionError(f"mesh world: first-step logits {rel} from the unmeshed run's")
    if not loss_rel <= TP_LOSS_RTOL:
        raise AssertionError(f"mesh world: TP training loss {loss_rel} from phase 10's")
    for name in ("flash_attention", "ancestor_attention"):
        if any(res["serving_launches"][name] <= 0 for res in ranks):
            raise AssertionError(f"mesh world: {name} did not launch under the model axis")
    if any(res["train_flash_launches"] <= 0 for res in ranks):
        raise AssertionError("mesh world: the TP training step did not launch the flash kernel")
    return {"wall_s": wall, "ranks": ranks, "logits_rel": rel, "train_loss_rel": loss_rel}


def mesh_rank(spec_path: str, rank: int) -> int:
    """One rank of phase 11c (``chip_smoke.py --mesh-rank SPEC RANK``)."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from modular_audio_pipeline_tpu_torch.config import TPUConfig
    from modular_audio_pipeline_tpu_torch.models.whisper.decode import (
        _quantize_cross_kv,
        build_initial_tokens,
        encode_audio_kv,
    )
    from modular_audio_pipeline_tpu_torch.models.whisper.model import (
        KVCache,
        decoder_forward,
        init_params,
        local_heads,
    )
    from modular_audio_pipeline_tpu_torch.ops.mel import log_mel
    from modular_audio_pipeline_tpu_torch.parallel import sharding
    from modular_audio_pipeline_tpu_torch.parallel.mesh import build_mesh, init_distributed
    from modular_audio_pipeline_tpu_torch.serving import ServingPipeline
    from modular_audio_pipeline_tpu_torch.training import train
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    spec = json.loads(Path(spec_path).read_text())
    init_distributed("cuda", backend="gloo", init_method=spec["store"], rank=rank,
                     world_size=2, timeout_s=120.0)
    out = {}

    # first, while the card holds least: one f32 training step at batch 8
    # under --devices 2 --tp 2 (phase 10's data)
    args = train.parse_args(["--manifest", spec["manifest"], "--model", "large-v3-turbo",
                             "--weights", "random:0", "--out", str(Path(spec["tmp"]) / "tp_out"),
                             "--devices", "2", "--tp", "2"])
    backend, dataset, state, train_step = train.setup(args, device="cuda")
    batch = train.to_device(train.local_batch(train.pad_batch(
        *next(dataset.batches(epoch=0)), 1), backend.mesh), backend.device)
    torch.cuda.reset_peak_memory_stats()
    wrappers = _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = train_step(state, *batch)
    torch.cuda.synchronize()
    out["train_step_s"] = time.perf_counter() - t0
    out["train_loss"] = loss.item()
    out["train_flash_launches"] = wrappers["flash_attention"].launches
    out["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del backend, dataset, state, train_step, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    log(f"rank {rank}: TP train step {out['train_step_s']:.2f} s, loss {out['train_loss']:.6f}, "
        f"peak {out['train_peak_gib']:.1f} GiB, flash launches {out['train_flash_launches']}")

    # the proxy bundle under each axis, bf16 and int8 (phase 5's sentences)
    meshes = {"model2": build_mesh(TPUConfig(mesh_shape={"model": 2}), "cuda"),
              "data2": build_mesh(TPUConfig(mesh_shape={"data": 2}), "cuda")}
    for name, mesh in meshes.items():
        for dtype in ("bf16", "int8"):
            tr = WhisperTranscriber("tiny", beam_size=5, weights_path=str(PROXY),
                                    max_decode_tokens=128, device="cuda", language="en",
                                    word_timestamps=False, mesh=mesh)
            if dtype == "int8":
                tr._backend.compute_dtype = "int8"
            key = f"proxy_{name}" if dtype == "bf16" else f"proxy_int8_{name}"
            out[key] = [tr.transcribe(p)["segments"] for p in spec["proxy"]]
    log(f"rank {rank}: proxy runs done")

    # large-v3-turbo at phase 6's configuration under the model axis
    mesh = meshes["model2"]
    pipe = ServingPipeline(serving_config("large-v3-turbo", "random:0", 224, True),
                           device="cuda", mesh=mesh)
    pipe.backend.load()
    audio = np.round(bench_audio(8 * 60.0) * 32768.0).astype(np.int16)
    wrappers = _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = pipe.process(audio, SR)
    torch.cuda.synchronize()
    out["serving_wall_s"] = time.perf_counter() - t0
    out["serving_launches"] = {n: w.launches for n, w in wrappers.items()}
    _check_serving(result, 8 * 60.0, f"rank {rank} TP serving")
    out["serving_segments"] = _seg_keys(result["segments"])
    out["serving_n_segments"] = len(result["segments"])
    log(f"rank {rank}: TP serving {out['serving_wall_s']:.2f} s, "
        f"{len(result['segments'])} segments, {len(result['diarization'])} turns, "
        f"launches {out['serving_launches']}")

    # the first decode step's logits (16 windows x 5 beams), then one step's
    # time and its all-reduces
    backend = pipe.backend
    params, dims = backend.params, backend.dims
    wins = torch.from_numpy(audio[: 16 * 480_000].astype(np.float32) / 32768.0).to("cuda")
    mel = log_mel(wins.reshape(16, -1), n_mels=dims.n_mels)
    initial, _ = build_initial_tokens(backend.tokenizer, backend._decode_options("en"))
    init = torch.tensor(initial, device="cuda")[None].expand(80, -1)

    def prefill(p):
        xa = _quantize_cross_kv(*encode_audio_kv(p, dims, mel))
        cache = KVCache.zeros(dims, 80, torch.bfloat16, ctx=448, quant=True, device="cuda",
                              heads=local_heads(dims.n_text_head, p))
        logits, cache = decoder_forward(p, dims, init, *xa, cache)
        return logits[:, -1].float(), xa, cache

    with torch.no_grad():
        tp_logits, xa, cache = prefill(params)
        if rank == 0:
            whole = init_params(dims, torch.Generator(device="cuda").manual_seed(0),
                                torch.bfloat16, "cuda")
            ref_logits = prefill(whole)[0]
            out["logits_max_abs_diff"] = (tp_logits - ref_logits).abs().max().item()
            out["logits_max_abs"] = ref_logits.abs().max().item()
            del whole
        tok = tp_logits.argmax(-1)[:, None]
        anc = torch.arange(5, device="cuda", dtype=torch.int32)[None, :, None].expand(
            16, 5, 448).contiguous()
        p0 = cache.pos

        def step():
            cache.pos = p0
            decoder_forward(params, dims, tok, *xa, cache, anc=anc)

        shapes = []
        real = torch.distributed.all_reduce

        def record(t, *a, **kw):
            shapes.append((tuple(t.shape), t.dtype))
            return real(t, *a, **kw)

        step()
        torch.distributed.all_reduce = record
        before = sharding.all_reduce_count[0]
        step()
        torch.distributed.all_reduce = real
        out["all_reduces_per_step"] = sharding.all_reduce_count[0] - before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        group = sharding.model_group(params).group
        bufs = [torch.zeros(s, dtype=d, device="cuda") for s, d in shapes]
        t0 = time.perf_counter()
        for _ in range(20):
            for b in bufs:
                real(b, group=group)
        torch.cuda.synchronize()
        out["collective_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        out["collective_shapes"] = [list(s) for s, _ in shapes]
    log(f"rank {rank}: decode step {out['step_ms']:.2f} ms, {out['all_reduces_per_step']} "
        f"all-reduces {out['collective_ms']:.2f} ms")
    (Path(spec["out"]) / f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


def phase_mesh(torch, tmp: Path):
    """Phase 11: the integrity layer and the mesh."""
    t0 = time.perf_counter()
    integrity = integrity_on_card(torch)
    log(f"phase 11a done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    audio = np.round(bench_audio(8 * 60.0) * 32768.0).astype(np.int16)
    one = world_of_one(torch, audio)
    log(f"phase 11b done in {time.perf_counter() - t0:.1f} s")
    # the kernels at the model axis's per-rank shapes: turbo's 20 heads over 2
    t0 = time.perf_counter()
    flash_tp = flash_at(torch, (16, 10, 1500, 64))
    numbers, _, _ = _anc_case(torch, torch.Generator(device="cuda").manual_seed(12), True, 448,
                              False, h=10)
    anc_tp = {**numbers, "shape": "BW 16, K 5, H 10, ctx 448, hd 64, int8, random ancestry",
              "library_ms": None}
    torch.cuda.empty_cache()
    world = mesh_world(torch, tmp)
    launches = world["ranks"][0]["serving_launches"]
    flash_tp["launches"] = launches["flash_attention"]
    anc_tp["launches"] = launches["ancestor_attention"]
    log(f"phase 11c done in {time.perf_counter() - t0:.1f} s")
    return {"integrity": integrity, "world_of_one": one, "world_of_two": world,
            "flash_tp2": flash_tp, "ancestry_tp2": anc_tp}


def main() -> int:
    try:
        import torch
    except ImportError:
        log("torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("no CUDA device: this smoke test runs only on a GPU")
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from modular_audio_pipeline_tpu_torch.ops import _build
    except ImportError as exc:
        log(f"the port's package is missing next to this script: {exc}")
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = card()
    log(f"card: {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    kernels = [phase_flash(torch), phase_ancestry(torch), phase_int8(torch)]
    log(f"phases 2-3b done in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as d:
        from modular_audio_pipeline_tpu_torch.audio_io import write_wav

        seconds = 8 * 60.0
        wav = Path(d) / "bench.wav"
        write_wav(str(wav), bench_audio(seconds), SR)
        t0 = time.perf_counter()
        launches, e2e = phase_end_to_end(torch, wav, seconds)
        torch.cuda.empty_cache()
        log(f"phase 4 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches_int8, e2e_int8 = phase_end_to_end_int8(torch, wav, seconds)
        torch.cuda.empty_cache()
        log(f"phase 4b done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        proxy = phase_proxy(torch, Path(d))
        log(f"phase 5 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches_serving, serving = phase_serving(torch, Path(d), seconds)
        torch.cuda.empty_cache()
        log(f"phase 6 done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches_sep, separation = phase_separation(torch, Path(d), seconds)
        torch.cuda.empty_cache()
        separation["phase_s"] = time.perf_counter() - t0
        log(f"phase 7 done in {separation['phase_s']:.1f} s")
        t0 = time.perf_counter()
        launches_batch, batch = phase_batch(torch, Path(d), 4 * 60.0)
        torch.cuda.empty_cache()
        batch["phase_s"] = time.perf_counter() - t0
        log(f"phase 8 done in {batch['phase_s']:.1f} s")
        t0 = time.perf_counter()
        launches_seek, seek = phase_seek(torch, Path(d))
        torch.cuda.empty_cache()
        seek["phase_s"] = time.perf_counter() - t0
        log(f"phase 9 done in {seek['phase_s']:.1f} s")
        t0 = time.perf_counter()
        launches_train, training = phase_training(torch, Path(d))
        torch.cuda.empty_cache()
        training["phase_s"] = time.perf_counter() - t0
        log(f"phase 10 done in {training['phase_s']:.1f} s")
        t0 = time.perf_counter()
        mesh = phase_mesh(torch, Path(d))
        mesh["phase_s"] = time.perf_counter() - t0
        log(f"phase 11 done in {mesh['phase_s']:.1f} s")
    # each kernel's count from the main path that brings it: phase 6 (the
    # serving path) for the flash and ancestry kernels, phase 4b (the one
    # path with compute_type="int8") for the int8 product; each must also
    # have launched in phase 4 (flash, ancestry) or 4b (all three)
    for k in kernels:
        name = k["name"]
        k["launches"] = launches_int8[name] if name == "int8_matmul" else launches_serving[name]
        if k["launches"] <= 0 or launches_int8[name] <= 0:
            raise AssertionError(f"{name} was not launched on its main path")
        if name != "int8_matmul" and launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the bf16 window path")
        if name != "int8_matmul" and launches_sep[name] <= 0:
            raise AssertionError(f"{name} was not launched on the separation path")
        k["launches_separation_path"] = launches_sep[name]
        if name != "int8_matmul" and launches_batch[name] <= 0:
            raise AssertionError(f"{name} was not launched by AudioPipeline")
        k["launches_audio_pipeline"] = launches_batch[name]
        if name == "flash_attention":
            k["large_v3_encoder_batch8"] = separation["flash_encoder_batch8"]
            k["seek_encoder_batch1"] = seek["flash_seek"]
        if name == "ancestor_attention":
            k["large_v3_batch8"] = separation["ancestry_batch8"]
            k["seek_bw1"] = seek["ancestry_seek"]
        if name != "int8_matmul":
            if launches_seek[name] <= 0:
                raise AssertionError(f"{name} was not launched on the seek path")
            k["launches_seek_path"] = launches_seek[name]
        if name == "flash_attention":  # the one kernel of the training path
            if launches_train[name] <= 0:
                raise AssertionError(f"{name} was not launched on the training path")
            k["launches_training_path"] = launches_train[name]
            k["f32_training_encoder"] = training["flash_train"]
        # the model axis's per-rank shapes (phase 11; mesh_world fails unless
        # both kernels launched on every rank)
        if name == "flash_attention":
            k["tp2_encoder_batch16"] = mesh["flash_tp2"]
        if name == "ancestor_attention":
            k["tp2_bk80_h10"] = mesh["ancestry_tp2"]
    log(json.dumps({"end_to_end": e2e, "end_to_end_int8": e2e_int8,
                    "launches_bf16_path": launches, "proxy": proxy, "serving": serving,
                    "separation": separation, "batch": batch, "seek": seek,
                    "training": training, "mesh": mesh}))

    print(name_power)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-rank":  # one rank of phase 11c
        sys.exit(mesh_rank(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
