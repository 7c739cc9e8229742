"""lm.prefill_s (s): the device seconds of the port's ``lm.prefill`` span
(``DeepseekV2LM.generate``: the whole prompt through the blocked latent
attention and the grouped experts, to the last position's logits), the
median over the window's requests of a traced run. Layer:
models/lm/deepseek_v2 prefill. Moves audio_x."""

import statistics


def read(ctx):
    xs = ctx.get("prefill_s")
    return statistics.median(xs) if xs else None
