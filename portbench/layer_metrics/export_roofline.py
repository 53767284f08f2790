"""Share of kernel (b)'s roofline (the port's export of a 3-D model's
logits: trilinear resample, argmax, paste and 4-bit pack,
``ops/kernels/export3d``): the least time of every export of the window's
volumes (``export_bound_s``: the float32 logits read once and the packed
mask written once over 3.35 TB/s, from ``lanes_extra/apply_kernels.py``)
over the device time of the kernels named ``lm_export3d*`` in the traced
window, in %."""

from portbench import spec

PREFIX = "lm_export3d"


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not ctx.get("volumes") or "export_bound_s" not in ctx:
        return None
    dev = spec.module("layer_metrics", "norm3d_roofline").device_s(trace, PREFIX)
    if dev <= 0:
        return None
    return 100.0 * ctx["export_bound_s"] / dev
