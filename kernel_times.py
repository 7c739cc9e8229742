#!/usr/bin/env python3
"""Device times of the port's kernels, for comparing two trees.

    python3 kernel_times.py [ROOT] [--e2e] [--fma-shapes] [--mla-only]

imports ``modular_audio_pipeline_tpu_torch`` from ROOT (default: this
file's directory), builds its kernels and prints one JSON line with the
flash kernel's time at the large-v3-turbo encoder shape (bf16, the
tensor-core route), at SegmentationNet's (f32 [512, 4, 1000, 32], a
512-window chunk) and at the turbo encoder's training shape (f32 [8, 20,
1500, 64], batch 8), the last two on the f32 route (the training one
also through the log-sum-exp forward that a training step launches),
the f32 backward at both f32 shapes (the backward kernel with its
pre-pass, beside the recompute through the plain version that it
replaced, its bound from 10 B H S^2 D operations at 67 TFLOP/s, B H S^2
exponentials and 8 tensors of bytes, and ptxas's registers and spill
bytes of each instantiation), the ancestry
kernel's at the decode shape (16 windows x 5 beams x 20 heads, int8
cache), at a 448 and a 64 context bucket, with random and with shared
ancestry, and the int8 product's at the five main-path shapes and at 16
rows: the
kernel alone (``int8_matmul(x, wq, ws)``, f32 out) beside its plain
version (``int8_matmul_reference``) and its bound (bytes over 3.35 TB/s or
multiply-adds over 989 TFLOP/s, the larger), and, for the four
projection shapes, the model's ``_proj`` with a bf16 bias and bf16
activations (the kernel plus whatever bias add and cast the tree does
after it) with the number of int8 kernel launches it makes (the
wrapper's launch counter, read around one call; torch.profiler's count of
device kernels is logged beside it as a cross-check), beside bf16
``torch.matmul`` on a dequantised weight. The int8
times cycle over enough copies of the weight to exceed the 50 MB L2, as
the decode loop finds its weights cold. Times are means over CUDA-graph
replays, so the wrappers' host work is not in them; that is timed apart,
as the host microseconds of one call of ``int8_matmul`` and of ``_proj``
at the 80-row shapes (calls queued without a wait), beside one bf16
``torch.matmul``'s as a yardstick of the host's load (also taken before
the first kernel runs and, with ``--e2e``, after the last). ``--e2e`` adds the
int8 + words path of ``chip_smoke.py`` phase 4b: random large-v3-turbo
built through ``from_config`` with ``compute_type="int8"`` and
``word_timestamps=True`` transcribes the same 8 minutes of audio, and
so does the same model in bf16 as the control (it runs no int8 product):
one warm-up run each, then three timed runs each in turns (wall and
word-alignment seconds of every run). ``--fma-shapes`` builds the flash
kernel's CUDA-core route (``launch_fma`` in ROOT's
``csrc/flash_attention.cu``; a tree without it is skipped) at each
register-tile shape of ``FMA_SHAPES`` through a small shim compiled into
ROOT's ``_build/``, checks each against the plain version and times it at
the f32 shape of its head dim, as ``fma_<shape>_ms`` and its registers and
spill bytes from the ptxas log. The MLA decode kernel (``ops/mla_decode``,
a kernel of the port that replaces no Pallas kernel; its case was added
when the kernel replaced the DeepSeek-V2 decode step's f32 widening chain)
is timed at DeepSeek-V2-Lite's decode over the ``notes_16k`` context
(batch 1, 16 heads, 16,512 positions, rank 512, rope 64, bf16, every
position attended) on eight layers' worth of distinct caches and weights
(beyond the L2, as the step finds them), beside the plain chain it
replaced (``_absorbed_attention``) on the same inputs, with its bound (f32
FMAs at 67 TFLOP/s, bytes at 3.35 TB/s), its largest difference from the
plain chain, its device launches a layer and ptxas's registers and spill
bytes of each of its three kernels (the tensor-core attention at this
shape); ``--mla-only`` times that case alone,
and a tree without the kernel prints the plain chain only. It uses only
calls that every version of the port since the int8 kernel has, so the
same script times a checkout of an earlier commit unpacked elsewhere: run
both in one job on one card and compare within that job.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
ROOT = Path(ARGS[0]).resolve() if ARGS else HERE
E2E = "--e2e" in sys.argv[1:]
FMA = "--fma-shapes" in sys.argv[1:]
MLA_ONLY = "--mla-only" in sys.argv[1:]
sys.path.insert(0, str(ROOT))


# the five main-path shapes, then 16 rows (language detection's width):
# what a product costs with next to no arithmetic
INT8_SHAPES = [(80, 1280, 1280), (80, 1280, 5120), (80, 5120, 1280), (80, 1280, 51968),
               (24000, 1280, 1280), (16, 1280, 1280)]
L2_BYTES = 50e6
# register-tile shapes of the flash kernel's CUDA-core route: (type, head
# dim, queries a block, queries x keys a thread, blocks an SM for the
# register budget), and the f32 shape each head dim is timed at
FMA_SHAPES = {
    "f32_hd32_64q_4x4": ("float", 32, 64, 4, 4, 2),
    "f32_hd32_64q_4x8": ("float", 32, 64, 4, 8, 3),
    "f32_hd32_128q_4x8": ("float", 32, 128, 4, 8, 2),
    "f32_hd32_128q_8x8": ("float", 32, 128, 8, 8, 2),
    "f32_hd64_64q_4x4": ("float", 64, 64, 4, 4, 2),
    "f32_hd64_64q_8x4": ("float", 64, 64, 8, 4, 2),
    "f32_hd64_128q_4x4": ("float", 64, 128, 4, 4, 1),
    "f32_hd64_128q_8x4": ("float", 64, 128, 8, 4, 1),
}
FMA_AT = {32: (512, 4, 1000, 32), 64: (8, 20, 1500, 64)}
FMA_SHIM = """#include "flash_attention.cu"
extern "C" int fma_shape(const void* q, const void* k, const void* v, void* o, int bh, int s,
                         float scale, void* stream) {
  return launch_fma<CFG_T, CFG_HD, CFG_BQ, CFG_TQ, CFG_TK, CFG_MB>(
      q, k, v, o, bh, s, scale, static_cast<cudaStream_t>(stream));
}
"""


def graph_ms(torch, fn, calls: int = 8, reps: int = 10) -> float:
    """Mean time of one call: ``fn`` is a callable run ``calls`` times per
    replay, or a list of callables run in turn."""
    fns = fn if isinstance(fn, list) else [fn] * calls
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def host_us(torch, fn, n: int = 200, reps: int = 5) -> float:
    """Median over ``reps`` of the host microseconds of one call of ``fn``,
    ``n`` calls queued without a wait (fewer than the launch queue holds)."""
    import statistics
    import time

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def e2e_int8_words(torch, out: dict) -> None:
    """chip_smoke.py phase 4b's transcription, without its checks, in int8
    and in bf16: one warm-up run each, then three timed runs each in turns."""
    import importlib.util
    import tempfile
    import time

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from modular_audio_pipeline_tpu_torch.audio_io import write_wav
    from modular_audio_pipeline_tpu_torch.config import PipelineConfig
    from modular_audio_pipeline_tpu_torch.transcriber import WhisperTranscriber

    trs = {}
    for compute_type in ("int8", "bfloat16"):
        cfg = PipelineConfig(lazy_load_models=False)
        tc = cfg.transcription
        tc.model, tc.language, tc.weights_path = "large-v3-turbo", "en", "random:0"
        tc.beam_size, tc.max_decode_tokens, tc.batch_size = 5, 224, 16
        tc.compute_type, tc.word_timestamps = compute_type, True
        tc.no_speech_threshold = None
        trs[compute_type] = WhisperTranscriber.from_config(cfg, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        wav = Path(d) / "bench.wav"
        write_wav(str(wav), smoke.bench_audio(480.0), smoke.SR)
        for tr in trs.values():
            tr.transcribe(str(wav))
        for _ in range(3):
            for compute_type, tr in trs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.transcribe(str(wav))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                name = "int8" if compute_type == "int8" else "bf16"
                out.setdefault(f"e2e_{name}_words_wall_s", []).append(wall)
                out.setdefault(f"e2e_{name}_words_align_s", []).append(
                    tr._backend.last_stats["align_s"])


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def wrapper_launches(torch, wrapper, fn) -> int:
    """Kernel launches the wrapper counts over one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    before = wrapper.launches
    fn()
    torch.cuda.synchronize()
    return wrapper.launches - before


def device_launches(torch, fn) -> int:
    """Kernels one call of ``fn`` puts on the device (torch.profiler; it
    can miss a kernel, so only a cross-check)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def event_ms(torch, fn, n: int = 2, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``n`` calls between two CUDA events
    (for work that allocates as it goes, such as an autograd pass)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def flash_backward(torch, out: dict) -> None:
    """The f32 gradient at the training encoder's and SegmentationNet's
    shapes: the backward kernel (on a gradient laid out as the encoder hands
    it back, a view of [B, S, H, D] storage) beside the recompute through
    the plain version, its largest difference from the recompute's
    gradients over their largest, and the bound."""
    import re

    from modular_audio_pipeline_tpu_torch.ops import _build
    from modular_audio_pipeline_tpu_torch.ops import attention as attn

    g = torch.Generator(device="cuda").manual_seed(2)
    for name, shape in (("training", (8, 20, 1500, 64)), ("segmentation", (512, 4, 1000, 32))):
        b, h, s, d = shape
        t = {"operations": 10.0 * b * h * s * s * d / 67e12,
             "exponentials": float(b * h * s * s) / (132 * 16 * 1.98e9),
             "bytes": 8.0 * b * h * s * d * 4 / 3.35e12}
        bound_by = max(t, key=t.get)
        out[f"flash_backward_{name}_bound_ms"] = t[bound_by] * 1e3
        out[f"flash_backward_{name}_bound_by"] = bound_by
        q, k, v, go = (torch.randn(shape, generator=g, device="cuda") for _ in range(4))
        qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
        out[f"flash_backward_recompute_{name}_ms"] = event_ms(torch, lambda: torch.autograd.grad(
            attn.attention_reference(qs, ks, vs), (qs, ks, vs), go))
        want = torch.autograd.grad(attn.attention_reference(qs, ks, vs), (qs, ks, vs), go)
        del qs, ks, vs
        torch.cuda.empty_cache()
        o, lse = attn._flash_lse_launch(q, k, v)
        go_m = go.transpose(1, 2).contiguous().transpose(1, 2)
        got = attn._flash_backward(q, k, v, o, lse, go_m)
        err = max(((a - w).abs().max() / w.abs().max()).item() for a, w in zip(got, want))
        out[f"flash_backward_{name}_max_rel_err"] = err
        del got, want
        out[f"flash_backward_{name}_ms"] = graph_ms(
            torch, lambda: attn._flash_backward(q, k, v, o, lse, go_m), calls=2, reps=3)
        log(f"flash backward f32 {shape}: {out[f'flash_backward_{name}_ms']:.3f} ms, the "
            f"recompute {out[f'flash_backward_recompute_{name}_ms']:.3f} ms, bound "
            f"{t[bound_by] * 1e3:.3f} ms ({bound_by}); dq/dk/dv within {err:.2e} of the "
            f"recompute's over its largest")
        del o, lse, go_m, q, k, v, go
        torch.cuda.empty_cache()
    text = _build.build_log("flash_attention")
    for hd in (64, 32):
        tag = f"flash_bwd_fmaILi{hd}E"
        if tag not in text:
            continue
        tail = text[text.index(tag):]
        regs = re.search(r"Used (\d+) registers", tail)
        spills = re.search(r"(\d+) bytes spill stores", tail)
        out[f"flash_backward_hd{hd}_registers"] = int(regs.group(1)) if regs else None
        out[f"flash_backward_hd{hd}_spill_bytes"] = int(spills.group(1)) if spills else None


def mla_decode_times(torch, out: dict) -> None:
    """The MLA decode kernel at DeepSeek-V2-Lite's decode over 16,512
    positions (module docstring), beside the plain chain it replaced."""
    import importlib.util
    import re

    from modular_audio_pipeline_tpu_torch.ops import _build

    spec = importlib.util.find_spec("modular_audio_pipeline_tpu_torch.models.lm.deepseek_v2")
    if spec is None:
        log("mla decode: this tree has no DeepSeek-V2, skipped")
        return
    from modular_audio_pipeline_tpu_torch.models.lm import deepseek_v2 as ds

    cfg = ds.DEEPSEEK_V2_CONFIGS["deepseek-v2-lite"]
    b, h, ctx, copies = 1, cfg.n_heads, 16512, 8
    nope, rope, r, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank, cfg.v_head_dim
    g = torch.Generator(device="cuda").manual_seed(3)

    def normal(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(torch.bfloat16)

    q = normal(b, h, 1, nope + rope)
    q_nope, q_pe = q[:, :, 0, :nope], q[:, :, 0, nope:]
    layers = [(normal(b, ctx, r), normal(b, ctx, rope), normal(r, h * (nope + dv), std=r ** -0.5))
              for _ in range(copies)]
    pos = torch.tensor(ctx - 1, device="cuda")
    mask = torch.zeros((ctx,), device="cuda")
    scale = ds.softmax_scale(cfg)
    flops = 2.0 * b * ctx * h * (2 * r + rope) + 2.0 * b * h * r * (nope + dv)
    nbytes = 2.0 * (b * ctx * (r + rope) + r * h * (nope + dv))
    out["mla_decode_bound_ops_us"] = flops / 67e12 * 1e6
    out["mla_decode_bound_bytes_us"] = nbytes / 3.35e12 * 1e6
    out["mla_plain_us"] = 1e3 * graph_ms(torch, [
        lambda c=c: ds._absorbed_attention(q_nope, q_pe, *c, mask, cfg) for c in layers], reps=3)
    if importlib.util.find_spec("modular_audio_pipeline_tpu_torch.ops.mla_decode") is None:
        log(f"mla decode: this tree has no kernel; the plain chain {out['mla_plain_us']:.1f} us")
        return
    from modular_audio_pipeline_tpu_torch.ops.mla_decode import mla_decode

    def kernel(c):
        return mla_decode(q_nope, q_pe, *c, pos, scale)

    out["mla_decode_us"] = 1e3 * graph_ms(torch, [lambda c=c: kernel(c) for c in layers], reps=10)
    got, want = kernel(layers[0]).float(), ds._absorbed_attention(
        q_nope, q_pe, *layers[0], mask, cfg).float()
    out["mla_decode_max_rel_err"] = float((got - want).abs().max() / want.abs().max())
    out["mla_decode_device_launches"] = device_launches(torch, lambda: kernel(layers[0]))
    text = _build.build_log("mla_decode")
    for name, tag in (("absorb", "mla_absorbI13__nv_bfloat16E"),
                      ("attend_tc", "mla_attend_tcILi16ELi512ELi64E"),
                      ("combine", "mla_combineI13__nv_bfloat16E")):
        if tag not in text:
            continue
        tail = text[text.index(tag):]
        regs = re.search(r"Used (\d+) registers", tail)
        spills = re.search(r"(\d+) bytes spill stores", tail)
        out[f"mla_{name}_registers"] = int(regs.group(1)) if regs else None
        out[f"mla_{name}_spill_bytes"] = int(spills.group(1)) if spills else None
    log(f"mla decode [1, 16, {ctx}, {r} + {rope}] bf16: {out['mla_decode_us']:.2f} us a layer, "
        f"the plain chain {out['mla_plain_us']:.1f} us, bound "
        f"{out['mla_decode_bound_ops_us']:.2f} us (ops) / {out['mla_decode_bound_bytes_us']:.2f} "
        f"us (bytes); within {out['mla_decode_max_rel_err']:.2e} of the plain chain over its "
        f"largest; {out['mla_decode_device_launches']} device launches")


def fma_shapes(torch, out: dict) -> None:
    """The CUDA-core route at each shape of FMA_SHAPES: built in parallel,
    held to the plain version (1e-4, f32) at ragged lengths, timed."""
    import ctypes
    import re
    import subprocess

    from modular_audio_pipeline_tpu_torch.ops import _build
    from modular_audio_pipeline_tpu_torch.ops.attention import attention_reference

    if "launch_fma" not in (_build.CSRC / "flash_attention.cu").read_text():
        log("fma shapes: this tree has no launch_fma, skipped")
        return
    work = _build.BUILD_DIR / "fma_shapes"
    work.mkdir(parents=True, exist_ok=True)
    (work / "shim.cu").write_text(FMA_SHIM)
    procs = {}
    for name, (t, hd, bq, tq, tk, mb) in FMA_SHAPES.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), f"-DCFG_T={t}",
               f"-DCFG_HD={hd}", f"-DCFG_BQ={bq}", f"-DCFG_TQ={tq}", f"-DCFG_TK={tk}",
               f"-DCFG_MB={mb}", "-o", str(work / f"lib{name}.so"), str(work / "shim.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"fma shape {name}: nvcc failed\n{text[-3000:]}")
        t, hd, bq, tq, tk, mb = FMA_SHAPES[name]
        tag = f"flash_fwd_fmaIfLi{hd}ELi{bq}ELi{tq}ELi{tk}ELi{mb}E"
        tail = text[text.index(tag):] if tag in text else ""
        regs = re.search(r"Used (\d+) registers", tail)
        spills = re.search(r"(\d+) bytes spill stores", tail)
        fn = ctypes.CDLL(str(work / f"lib{name}.so")).fma_shape
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]

        def run(q, k, v, fn=fn):
            o = torch.empty_like(q)
            b, h, s, d = q.shape
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, s, d ** -0.25,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"fma shape {name}: cudaError {rc}")
            return o

        for shape in [(1, 3, 63, hd), (1, 3, 129, hd), (2, 2, 1001, hd)]:
            q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
            err = (run(q, k, v) - attention_reference(q, k, v)).abs().max().item()
            if not err <= 1e-4:
                raise AssertionError(f"fma shape {name} at {shape}: err {err}")
        q, k, v = (torch.randn(FMA_AT[hd], generator=g, device="cuda") for _ in range(3))
        out[f"fma_{name}_ms"] = graph_ms(torch, lambda: run(q, k, v), calls=2, reps=3)
        out[f"fma_{name}_registers"] = int(regs.group(1)) if regs else None
        out[f"fma_{name}_spill_bytes"] = int(spills.group(1)) if spills else None
        log(f"fma {name} at {FMA_AT[hd]}: {out[f'fma_{name}_ms']:.3f} ms, "
            f"{out[f'fma_{name}_registers']} registers, {out[f'fma_{name}_spill_bytes']} spill bytes")
        del q, k, v
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from modular_audio_pipeline_tpu_torch.ops.ancestor_attention import ancestor_attention
    from modular_audio_pipeline_tpu_torch.ops.attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(ROOT), "card": torch.cuda.get_device_name(0)}
    if MLA_ONLY:
        mla_decode_times(torch, out)
        print(json.dumps(out))
        return 0
    x = torch.randn((80, 1280), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((1280, 1280), generator=g, device="cuda").to(torch.bfloat16)
    out["host_us_bf16_matmul_at_start"] = host_us(torch, lambda: torch.matmul(x, w))
    del x, w
    q, k, v = (torch.randn((16, 20, 1500, 64), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out["flash_ms"] = graph_ms(torch, lambda: flash_attention(q, k, v), calls=4, reps=5)
    del q, k, v
    q, k, v = (torch.randn((512, 4, 1000, 32), generator=g, device="cuda") for _ in range(3))
    out["flash_segmentation_f32_ms"] = graph_ms(torch, lambda: flash_attention(q, k, v),
                                                calls=2, reps=3)
    del q, k, v
    q, k, v = (torch.randn((8, 20, 1500, 64), generator=g, device="cuda") for _ in range(3))
    out["flash_training_f32_ms"] = graph_ms(torch, lambda: flash_attention(q, k, v),
                                            calls=2, reps=3)
    from modular_audio_pipeline_tpu_torch.ops import attention as attn

    out["flash_training_f32_lse_ms"] = graph_ms(torch, lambda: attn._flash_lse_launch(q, k, v),
                                                calls=2, reps=3)
    del q, k, v
    flash_backward(torch, out)
    if FMA:
        fma_shapes(torch, out)
    mla_decode_times(torch, out)
    torch.cuda.empty_cache()

    bw, kq, h, hd, layers, layer = 16, 5, 20, 64, 2, 1
    for ctx in (448, 64):
        q = (torch.randn((bw * kq, h, 1, hd), generator=g, device="cuda") * 0.125).to(torch.bfloat16)
        cache = [torch.randint(-127, 128, (layers, bw * kq, h, ctx, hd), generator=g,
                               device="cuda", dtype=torch.int8) for _ in range(2)]
        cache += [torch.rand((layers, bw * kq, h, ctx), generator=g, device="cuda") * 0.02 + 0.001
                  for _ in range(2)]
        mask = torch.zeros((ctx,), device="cuda")
        for shared in (False, True):
            anc = torch.randint(0, kq, (bw, kq, ctx), generator=g, device="cuda", dtype=torch.int32)
            if shared:
                anc[:, :, :-3] = anc[:, :1, :-3]
            name = f"ancestry_ctx{ctx}_{'shared' if shared else 'random'}_ms"
            out[name] = graph_ms(torch, lambda: ancestor_attention(q, *cache, layer, anc, mask))
    del q, cache
    torch.cuda.empty_cache()

    from modular_audio_pipeline_tpu_torch.models.whisper.model import _proj
    from modular_audio_pipeline_tpu_torch.ops.quant import int8_matmul, int8_matmul_reference

    for m, k, n in INT8_SHAPES:
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        ws = torch.rand((n,), generator=g, device="cuda") * 0.002 + 1e-4
        bias = (torch.randn((n,), generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        copies = 1 if m > 1000 else min(64, int(L2_BYTES // (k * n)) + 2)
        wqs = [torch.randint(-127, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
               for _ in range(copies)]
        reps = 2 if m > 1000 else 5
        shape = f"{m}x{k}x{n}"
        out[f"int8_{shape}_ms"] = graph_ms(
            torch, [lambda w=w: int8_matmul(x, w, ws) for w in wqs], reps=reps)
        if n != 51968:  # the head has no bias and keeps f32
            mods = [{"q_wq": w, "q_ws": ws, "q_b": bias} for w in wqs]
            out[f"proj_{shape}_ms"] = graph_ms(
                torch, [lambda mod=mod: _proj(x, mod, "q") for mod in mods], reps=reps)
            proj = lambda: _proj(x, mods[0], "q")  # noqa: E731
            out[f"proj_{shape}_launches"] = wrapper_launches(torch, int8_matmul, proj)
            log(f"proj {shape}: {out[f'proj_{shape}_launches']} int8 kernel launches (wrapper "
                f"counter), {device_launches(torch, proj)} device kernels (torch.profiler)")
        out[f"plain_int8_{shape}_ms"] = graph_ms(
            torch, [lambda w=w: int8_matmul_reference(x, w, ws) for w in wqs[:2]], reps=reps)
        # the least time: bf16 x, int8 codes and f32 scales read once, the f32
        # product written once, over the memory rate, or its multiply-adds at
        # the bf16 tensor-core rate, whichever is longer
        t_bytes = (m * k * 2 + k * n + n * 4 + m * n * 4) / 3.35e12
        t_ops = 2 * m * k * n / 989e12
        out[f"int8_{shape}_bound_ms"] = max(t_bytes, t_ops) * 1e3
        out[f"int8_{shape}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        w_bf16 = [(w.float() * ws).to(torch.bfloat16) for w in wqs]
        out[f"bf16_matmul_{shape}_ms"] = graph_ms(
            torch, [lambda w=w: torch.matmul(x, w) for w in w_bf16], reps=reps)
        if m == 80 and n != 51968:  # the decode step's products, shorter than their host work
            out[f"host_us_int8_{shape}"] = host_us(torch, lambda: int8_matmul(x, wqs[0], ws))
            out[f"host_us_proj_{shape}"] = host_us(torch, lambda: _proj(x, mods[0], "q"))
            out[f"host_us_bf16_matmul_{shape}"] = host_us(torch, lambda: torch.matmul(x, w_bf16[0]))
        del x, wqs, w_bf16
        torch.cuda.empty_cache()
    if E2E:
        e2e_int8_words(torch, out)
        x = torch.randn((80, 1280), generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randn((1280, 1280), generator=g, device="cuda").to(torch.bfloat16)
        out["host_us_bf16_matmul_at_end"] = host_us(torch, lambda: torch.matmul(x, w))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
