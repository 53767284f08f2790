"""Share of a training cell's traced window in which nothing ran on the
card (``tracing.idle_share``), in %. Read where the window trained
steps."""

from portbench import tracing


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not ctx.get("steps"):
        return None
    return tracing.idle_share(trace)
