"""Share of an inference cell's traced window in which nothing ran on the
card (``tracing.idle_share``: 1 − the union of the device's kernel, copy
and set intervals over the window), in %. Read where the window finished
volumes."""

from portbench import tracing


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not ctx.get("volumes"):
        return None
    return tracing.idle_share(trace)
