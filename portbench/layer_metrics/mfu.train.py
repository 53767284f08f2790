"""The train step's share of the chip's bf16 peak: 3 × forward operations
× slices trained in the window over window × 989 TFLOP/s, in %."""

from portbench import roofline


def read(ctx):
    if not ctx.get("slices") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["train_flops"] / (ctx["window_s"] * roofline.PEAK_BF16_FLOPS)
