"""lm.decode_roofline (%): the time the window's decode steps would take
at the card's memory bandwidth, as a share of the time they took. The
bytes all the steps must read
(roofline_lm.decode_step_bytes: the active weights, six experts a MoE
layer, and the latent cache at its live context, summed over the steps)
over the card's memory bandwidth, over the summed device seconds of the
``lm.decode`` spans that ran them (a traced run). Layer:
models/lm/deepseek_v2 decode loop. Moves audio_x."""

from bench_port.roofline import PEAK_BYTES


def read(ctx):
    if not sum(ctx.get("decode_steps", [])) or not sum(ctx.get("decode_s", [])):
        return None
    return 100.0 * ctx["decode_bytes"] / PEAK_BYTES / sum(ctx["decode_s"])
