"""mfu.lm (%): the model FLOPs of the window's requests
(roofline_lm.request_flops: the prefill, causal, and every decode step at
its context) over the window's time and the card's bf16 peak. Layer:
DeepseekV2LM.generate. Moves audio_x."""

from bench_port.roofline import PEAK_BF16_FLOPS


def read(ctx):
    flops = ctx.get("request_flops")
    if ctx.get("kind") != "lm" or not flops or not ctx.get("window_s"):
        return None
    return 100.0 * sum(flops) / (ctx["window_s"] * PEAK_BF16_FLOPS)
