"""Seconds per volume of the fused pair's fusion (``fusion_postprocess`` in
``LMInferer.timings``: ``native.fused_finish``) over the window."""


def read(ctx):
    total = ctx.get("stage_totals", {}).get("fusion_postprocess")
    if total is None or not ctx.get("volumes"):
        return None
    return total / ctx["volumes"]
