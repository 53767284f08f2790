#!/usr/bin/env python
"""Minimal example on the PyTorch/CUDA port: segment one CT volume (file or
DICOM directory) on the GPU.

    python examples/torch/segment_volume.py INPUT OUTPUT.nii.gz [--lobes] [--cpu]

The counterpart of ``examples/segment_volume.py``; it imports only
``lungmask_tpu_torch`` (run it from the repository root with
``PYTHONPATH=.``, or install the package). The weights come from the
registry (``$LUNGMASK_TPU_CACHE``, else ``~/.cache/lungmask_tpu``). Without
CUDA and without ``--cpu`` it fails.
"""

import sys

from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.io import load_input_image, write_image


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    paths = [a for a in argv if not a.startswith("--")]
    if len(paths) != 2:
        sys.exit(__doc__)
    input_path, output_path = paths
    lobes = "--lobes" in argv
    force_cpu = "--cpu" in argv

    image = load_input_image(input_path, read_metadata=True)

    if lobes:
        # Fused mode: LTRCLobes labels, R231's lung boundary (reference's
        # LTRCLobes_R231 configuration).
        inferer = LMInferer(modelname="LTRCLobes", fillmodel="R231", force_cpu=force_cpu)
    else:
        inferer = LMInferer(force_cpu=force_cpu)  # R231 left/right lung

    mask = inferer.apply(image)
    write_image(image.with_array(mask), output_path)
    print(f"wrote {output_path}")
    print("stage seconds:")
    print(inferer.timings.report())


if __name__ == "__main__":
    main()
