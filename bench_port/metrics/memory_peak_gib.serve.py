"""memory_peak_gib.serve (GiB): the allocator's peak
(``torch.cuda.max_memory_allocated``) over the window, reset after the
warm request. It moves with what a random model decodes, so it is no
end-to-end metric of a serving cell. Layer: device. Moves audio_x."""


def read(ctx):
    peak = ctx.get("memory_peak_bytes")
    return peak / 2**30 if peak else None
