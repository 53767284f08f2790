"""Seconds per volume of the inferer's ``unet`` stage (``LMInferer.timings``,
the program's own stage clock) over the window."""


def read(ctx):
    total = ctx.get("stage_totals", {}).get("unet")
    if total is None or not ctx.get("volumes"):
        return None
    return total / ctx["volumes"]
