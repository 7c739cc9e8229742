#!/usr/bin/env python3
"""Time the Llama LM's generation on one NVIDIA GPU.

    python3 lm_times.py

builds ``LlamaLM`` at tinyllama-1.1b (22 layers, d 2048, 32/4 heads, ff
5632, vocab 32000) with random bf16 weights from a seeded generator on the
card, and prints one JSON line: the milliseconds per generated token after
a 1,536-token prompt (128 greedy tokens, the prompt's own time taken off)
beside the weight bytes one step reads over the card's 3.35 TB/s, and a
``torch.profiler`` trace of 16 decode steps: the step's wall and device
milliseconds, its kernel launches and the ten kernels with the most device
time. The card's name and power limit are printed first.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
PROMPT, NEW = 1536, 128


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from modular_audio_pipeline_tpu_torch.models.lm import LLAMA_CONFIGS, LlamaLM
    from modular_audio_pipeline_tpu_torch.models.lm import llama

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LLAMA_CONFIGS["tinyllama-1.1b"]
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               torch.bfloat16, "cuda")
    lm = LlamaLM(cfg, params=params, device="cuda")
    prompt = np.random.default_rng(21).integers(3, cfg.vocab_size, size=PROMPT).astype(np.int32)
    weight_bytes = sum(t.numel() * t.element_size() for t in params["blocks"].values())
    weight_bytes += sum(params[k].numel() * params[k].element_size()
                        for k in ("final_norm", "lm_head"))
    weight_bytes += cfg.d_model * params["tok_emb"].element_size()

    def per_token_ms() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.generate(prompt, max_new_tokens=1, temperature=0.0)
        torch.cuda.synchronize()
        prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks = lm.generate(prompt, max_new_tokens=NEW, temperature=0.0)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) - prefill) / (len(toks) - 1) * 1e3

    per_token_ms()  # warm-up
    out = {"weight_bytes_per_token": weight_bytes,
           "bound_ms_per_token": weight_bytes / PEAK_BYTES * 1e3,
           "per_token_ms": [per_token_ms() for _ in range(2)]}

    from torch.profiler import ProfilerActivity, profile

    cache = llama.LMCache.zeros(cfg, 1, PROMPT + NEW + 1, torch.bfloat16, "cuda")
    llama.forward(params, cfg, torch.from_numpy(prompt).long().cuda()[None], cache)
    tok = torch.tensor([[5]], device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(16):
            _, cache = llama.forward(params, cfg, tok, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    out.update(
        profiled_step_wall_ms=wall / 16 * 1e3,
        step_device_ms=sum(e.self_device_time_total for e in events) / 16e3,
        launches_per_step=sum(e.count for e in events) / 16,
        top_kernels_ms_per_step=[(e.key[:90], e.self_device_time_total / 16e3, e.count // 16)
                                 for e in top])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
