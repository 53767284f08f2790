"""A toy lane for the harness's tests: a fixed number of calls of the
family's inferer on one seeded volume, then the family's checks."""

import time
from types import SimpleNamespace

from portbench import phantom


def run(run):
    fam, tr = run.family, run.traffic
    run.mark("start")
    trees = fam.weights(run)
    run.mark("weights")
    vol, _ = phantom.volume(run.seed, 0, tr["slices"], tr["size"], run.device)
    image = SimpleNamespace(array=vol, spacing=(1.0, 1.0, 1.0))
    run.mark("inputs")
    inferer = fam.inferer(run, trees)
    run.mark("inferer")
    inferer.apply(image)
    run.setup_done()
    t0 = time.perf_counter()
    masks = [inferer.apply(image) for _ in range(int(tr["calls"]))]
    window = max(time.perf_counter() - t0, 1e-9)
    out = fam.outputs(run, inferer, [image], [0])
    peak = run.memory_peak()
    del inferer
    run.free_device()
    cost = fam.forward_cost(run.config, vol.shape, image.spacing)
    return {"attempted": len(masks), "failed": 0,
            "e2e": {"volumes_per_h": 3600.0 * len(masks) / window},
            "ctx": {"volumes": len(masks), "window_s": window,
                    "forward_flops": cost["flops"] * len(masks)},
            "checks": fam.checks(run, {0: masks[:2]}, out, [image], trees),
            "memory_peak_bytes": peak, "trace": None}
