"""The whole volume's share of the chip's bf16 peak: forward operations of
every U-Net run in the window (``portbench/roofline.py``'s count at the
configuration's classes) over window × 989 TFLOP/s, in %."""

from portbench import roofline


def read(ctx):
    if not ctx.get("volumes") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["forward_flops"] / (ctx["window_s"] * roofline.PEAK_BF16_FLOPS)
