"""Seconds per volume of the inferer's reorientation to LPS and back
(``LMInferer.timings``' ``to_lps`` plus ``from_lps``, the program's own stage
clock; the fused pair's two ``from_lps`` summed) over the window."""


def read(ctx):
    totals = ctx.get("stage_totals", {})
    if "to_lps" not in totals or "from_lps" not in totals or not ctx.get("volumes"):
        return None
    return (totals["to_lps"] + totals["from_lps"]) / ctx["volumes"]
