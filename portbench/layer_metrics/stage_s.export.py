"""Seconds per volume of the inferer's ``export`` stage of a 3-D model
(``LMInferer.timings``, the program's own stage clock: the logits exported
to the input grid, argmax, paste, the 4-bit download and its unpack) over
the window."""


def read(ctx):
    total = ctx.get("stage_totals", {}).get("export")
    if total is None or not ctx.get("volumes"):
        return None
    return total / ctx["volumes"]
