"""flash_fwd_tc_roofline (%): the bf16 head-dim-64 launches of the flash
kernel (``scale_rows`` + ``flash_fwd_tc``) in the profiled request: the
sum of their least times (roofline.flash_bound_s) over the device time
the profiler gives those two kernels. Layer: csrc/flash_attention.cu.
Moves audio_x."""

from bench_port.roofline import flash_bound_s


def read(ctx):
    trace = ctx.get("trace")
    calls = [s for s, d in ctx.get("flash_calls", []) if d == "bfloat16" and s[-1] == 64]
    if trace is None or not calls:
        return None
    t_main, n = trace.kernel_seconds("flash_fwd_tc")
    t_pre, _ = trace.kernel_seconds("scale_rows")
    if not n:
        return None
    return 100.0 * sum(flash_bound_s(s, "bfloat16")[0] for s in calls) / (t_main + t_pre)
