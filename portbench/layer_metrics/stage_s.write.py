"""Seconds per volume of the cohort finisher's mask write (the ``write``
stage in ``LMInferer.timings``, the program's own stage clock) over the
window."""


def read(ctx):
    total = ctx.get("stage_totals", {}).get("write")
    if total is None or not ctx.get("volumes"):
        return None
    return total / ctx["volumes"]
