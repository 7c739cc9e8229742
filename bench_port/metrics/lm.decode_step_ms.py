"""lm.decode_step_ms (ms): the device seconds of the port's ``lm.decode``
spans (the decode loop, which opens after the step's capture as a CUDA
graph: a replay and a read-back a step; a step is the absorbed attention
over the latent cache, the chosen experts and the logits) over the
``lm.decode_steps``
they counted, summed over the window's requests of a traced run. Layer:
models/lm/deepseek_v2 decode loop. Moves audio_x."""


def read(ctx):
    steps = sum(ctx.get("decode_steps", []))
    if not steps:
        return None
    return sum(ctx["decode_s"]) / steps * 1e3
