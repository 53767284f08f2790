"""The ``apply`` lane (``lanes.lane_apply``: a closed loop of
``LMInferer.apply`` on the pool) for a model whose forward runs the port's
hand-written 3-D kernels and a sliding window: it adds to what the lane
reads

- ``norm3d_bound_s`` and ``export_bound_s``, the least time of the window's
  volumes in each kernel (the family's ``kernel_bytes`` over 3.35 TB/s),
  which ``layer_metrics/norm3d_roofline.py`` and ``export_roofline.py``
  read beside the kernels' device time;
- the check ``patches_miscount``: the patches the port counted over the
  run (warm-up, window and the check's own forwards) against the sliding
  window's count for each of those volumes, as a share of the latter; a
  program that skips or repeats patches reads above 0.

The port's counters are printed on standard error.
"""

import sys

from portbench import lanes, roofline


def run(run):
    fam, tr = run.family, run.traffic
    shape = (int(tr["slices"]), int(tr["size"]), int(tr["size"]))
    before = fam.counters()
    out = lanes.lane_apply(run)
    after = fam.counters()
    calls = int(tr.get("warm_calls", 1)) + out["attempted"] + getattr(run, "extra_forwards", 0)
    per_volume = fam.forward_cost(run.config, shape, tr["spacing"])["patches"]
    counted = after["patches"] - before["patches"]
    expected = per_volume * calls
    out["checks"].append(["patches_miscount", abs(counted - expected) / max(expected, 1),
                          run.limit("patches_miscount")])
    done = out["attempted"] - out["failed"]
    nbytes = fam.kernel_bytes(run.config, shape, tr["spacing"])
    out["ctx"].update(norm3d_bound_s=nbytes["norm3d"] / roofline.PEAK_BYTES * done,
                      export_bound_s=nbytes["export"] / roofline.PEAK_BYTES * done)
    print(f"portbench: {counted} patches over {calls} volumes ({per_volume} a volume expected); "
          f"launches: norm3d {after['norm3d'] - before['norm3d']}, "
          f"export {after['export'] - before['export']}", file=sys.stderr)
    return out
