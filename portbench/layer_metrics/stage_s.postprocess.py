"""Seconds per volume of the inferer's ``postprocess`` stage (``LMInferer.timings``,
the program's own stage clock) over the window."""


def read(ctx):
    total = ctx.get("stage_totals", {}).get("postprocess")
    if total is None or not ctx.get("volumes"):
        return None
    return total / ctx["volumes"]
