"""mfu.train (%): three times the forward FLOPs of every sample of the
window (roofline.train_sample_flops) over the window's time and the
card's f32 peak on the CUDA cores (the configured arithmetic, TF32 off).
Layer: training/whisper_train step. Moves train_samples_s."""

from bench_port.roofline import PEAK_F32_FLOPS


def read(ctx):
    if not ctx.get("samples") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["samples"] * ctx["sample_flops"] / (ctx["window_s"] * PEAK_F32_FLOPS)
