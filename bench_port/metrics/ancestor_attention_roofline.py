"""ancestor_attention_roofline (%): the ancestry kernel's launches in the
profiled request: the bytes each must move (roofline.ancestry_bytes: the
selected int8 rows and scales at each step's live context) over the
memory bandwidth, over the device time the profiler gives the kernel.
Layer: csrc/ancestor_attention.cu. Moves audio_x."""

from bench_port.roofline import ancestry_bound_s


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not ctx.get("anc_launches"):
        return None
    t, n = trace.kernel_seconds("ancestor_attention_kernel")
    if not n:
        return None
    return 100.0 * ancestry_bound_s(ctx["anc_bytes"]) / t
