#!/usr/bin/env python3
"""Device times of the port's attention kernels, for comparing two trees.

    python3 kernel_times.py [ROOT]

imports ``modular_audio_pipeline_tpu_torch`` from ROOT (default: this
file's directory), builds its kernels and prints one JSON line with the
flash kernel's time at the large-v3-turbo encoder shape and the ancestry
kernel's at the decode shape (16 windows x 5 beams x 20 heads, int8
cache), at a 448 and a 64 context bucket, with random and with shared
ancestry. Times are means over CUDA-graph replays, so the wrappers' host
work is not in them. It uses only calls that every version of the port
has, so the same script times a checkout of an earlier commit unpacked
elsewhere: run both in one job on one card and compare within that job.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


def graph_ms(torch, fn, calls: int = 8, reps: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from modular_audio_pipeline_tpu_torch.ops.ancestor_attention import ancestor_attention
    from modular_audio_pipeline_tpu_torch.ops.attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(ROOT), "card": torch.cuda.get_device_name(0)}
    q, k, v = (torch.randn((16, 20, 1500, 64), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out["flash_ms"] = graph_ms(torch, lambda: flash_attention(q, k, v), calls=4, reps=5)
    del q, k, v

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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
