"""mfu.serve (%): model FLOPs of the window's requests (roofline.
serve_request_flops: encoder and cross K/V over the kept windows, the beam
decode with its attention and logits, the alignment pass) over the
window's time and the card's bf16 peak. Layer:
serving.ServingPipeline.process. Moves audio_x."""

from bench_port.roofline import PEAK_BF16_FLOPS


def read(ctx):
    flops = ctx.get("request_flops")
    if not flops or not ctx.get("window_s"):
        return None
    return 100.0 * sum(flops) / (ctx["window_s"] * PEAK_BF16_FLOPS)
