"""Seconds per volume of the cohort loader's read and decode of each source
(the ``decode`` stage in ``LMInferer.timings``, the program's own stage
clock) over the window."""


def read(ctx):
    total = ctx.get("stage_totals", {}).get("decode")
    if total is None or not ctx.get("volumes"):
        return None
    return total / ctx["volumes"]
