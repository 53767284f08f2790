"""Share of kernel (a)'s roofline (the port's InstanceNorm + LeakyReLU,
``ops/kernels/norm3d``): the least time of every normalisation of the
window's volumes (``norm3d_bound_s``: bf16 read once and written once over
3.35 TB/s, from ``lanes_extra/apply_kernels.py``) over the device time of
the kernels named ``lm_norm3d*`` in the traced window, in %."""

from portbench import tracing

PREFIX = "lm_norm3d"


def device_s(trace, prefix: str) -> float:
    """Device seconds of the kernels whose name starts with ``prefix``
    inside the traced window."""
    w0, w1 = tracing.window(trace)
    return sum(min(e, w1) - max(s, w0) for name, s, e, _ in trace["device"]
               if name.startswith(prefix) and e > w0 and s < w1) / 1e9


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not ctx.get("volumes") or "norm3d_bound_s" not in ctx:
        return None
    dev = device_s(trace, PREFIX)
    if dev <= 0:
        return None
    return 100.0 * ctx["norm3d_bound_s"] / dev
