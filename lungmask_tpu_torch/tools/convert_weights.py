"""Offline weight converter: reference ``.pth`` checkpoints → ``.npz``
(counterpart of the repository's ``tools/convert_weights.py``).

    python -m lungmask_tpu_torch.tools.convert_weights unet_r231-d5d2fc3d.pth [out.npz]

The ``.npz`` (folded BatchNorm, HWIO kernels, ``meta={"source": <file
name>}``) is what both packages load; drop it in $LUNGMASK_TPU_CACHE
(default ~/.cache/lungmask_tpu) named after the release file to have the
registry pick it up without any network access.
"""

import os
import sys

from lungmask_tpu_torch.models import convert


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    src = sys.argv[1]
    dst = (
        sys.argv[2]
        if len(sys.argv) > 2
        else os.path.splitext(os.path.basename(src))[0] + ".npz"
    )
    params, n_classes = convert.convert_pth(src)
    convert.save_npz(dst, params, meta={"source": os.path.basename(src)})
    print(f"{src} -> {dst} (n_classes={n_classes})")


if __name__ == "__main__":
    main()
