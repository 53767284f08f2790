#!/usr/bin/env python
"""Stream a cohort of CT volumes through one inferer of the PyTorch/CUDA
port, with overlapped decode / device compute / write stages.

    python examples/torch/cohort_streaming.py OUT_DIR INPUT [INPUT ...] [--cpu]

The counterpart of ``examples/cohort_streaming.py`` through
``lungmask_tpu_torch.runtime.cohort.run_cohort``; it imports only
``lungmask_tpu_torch`` (run it from the repository root with
``PYTHONPATH=.``, or install the package). The R231 weights come from the
registry. Without CUDA and without ``--cpu`` it fails.
"""

import sys

from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.runtime.cohort import run_cohort


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    paths = [a for a in argv if a != "--cpu"]
    if len(paths) < 2:
        sys.exit(__doc__)
    out_dir, inputs = paths[0], paths[1:]

    inferer = LMInferer(batch_size=32, tqdm_disable=True, force_cpu="--cpu" in argv)
    stats = run_cohort(
        inputs,
        inferer,
        output_dir=out_dir,
        on_result=lambda r: print(
            f"  {r.name}: {'ok' if r.error is None else r.error} ({r.seconds:.1f}s)"
        ),
    )
    print(
        f"{len(stats.results)} volumes in {stats.wall_seconds:.1f}s "
        f"→ {stats.volumes_per_hour:.0f} volumes/hour"
    )
    return stats


if __name__ == "__main__":
    main()
