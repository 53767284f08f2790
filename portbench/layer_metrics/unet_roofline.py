"""Share of the U-Net forwards' roofline: the analytic least time of every
forward in the traced window (``portbench/roofline.py``: per 32-slice
chunk the larger of operations over 989 TFLOP/s and bytes over 3.35 TB/s,
summed over ops) over the device time of the kernels launched inside the
benchmark's ``forward`` spans, in %."""

from portbench import tracing


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not ctx.get("volumes"):
        return None
    device_s = tracing.device_s_in(trace, "forward")
    if device_s <= 0:
        return None
    return 100.0 * ctx["forward_bound_s"] / device_s
