"""Seconds per volume of the inferer's ``paste_back`` stage (``LMInferer.timings``,
the program's own stage clock) over the window."""


def read(ctx):
    total = ctx.get("stage_totals", {}).get("paste_back")
    if total is None or not ctx.get("volumes"):
        return None
    return total / ctx["volumes"]
