"""flash_fwd_fma_roofline (%): the f32 launches of the flash kernel
(``flash_fwd_fma``, the training encoder's [8, 20, 1500, 64]) in the
profiled steps: the sum of their least times (roofline.flash_bound_s,
f32 on the CUDA cores) over the device time the profiler gives the
kernel. Layer: csrc/flash_attention.cu. Moves train_samples_s."""

from bench_port.roofline import flash_bound_s


def read(ctx):
    trace = ctx.get("trace")
    calls = [s for s, d in ctx.get("flash_calls", []) if d == "float32"]
    if trace is None or not calls:
        return None
    t, n = trace.kernel_seconds("flash_fwd_fma")
    if not n:
        return None
    return 100.0 * sum(flash_bound_s(s, "float32")[0] for s in calls) / t
