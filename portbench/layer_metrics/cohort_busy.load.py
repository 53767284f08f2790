"""Share of the cohort lane's wall time its load thread spent working
(``CohortStats.stage_seconds["load_busy"]``), in %."""


def read(ctx):
    seconds = ctx.get("cohort_stage_seconds")
    if not seconds or not ctx.get("cohort_wall_s"):
        return None
    return 100.0 * seconds["load_busy"] / ctx["cohort_wall_s"]
