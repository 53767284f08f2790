"""nnU-Net's preprocessing of a CT volume for a 3-D model, on the device
(MIC-DKFZ/nnUNet v2, ``DefaultPreprocessor.run_case_npy``, in its order):

1. crop to the nonzero box: nnU-Net takes the bounding box of the mask
   ``x != 0`` with its holes filled; filling holes adds only voxels that
   the mask encloses, which lie inside its box, so the box is that of
   ``x != 0`` (:func:`nonzero_box`; the whole volume where nothing is
   nonzero);
2. CT normalisation (``CTNormalization``): clip to the plan's
   ``[lower, upper]`` (the fingerprint's 0.5 and 99.5 percentiles), then
   ``(x − mean) / max(std, 1e-8)``; nnU-Net normalises before it resamples;
3. resample to the plan's isotropic spacing, shape ``round(shape ×
   spacing / target)``, at the plan's ``data_order`` (3: cubic spline)
   with ``ops/resample3d.zoom``.

The volume goes up as its integer type and is converted on the device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from lungmask_tpu_torch.ops import resample3d

Box = Tuple[int, int, int, int, int, int]


def nonzero_box(x: torch.Tensor) -> Box:
    """``(z0, z1, y0, y1, x0, x1)`` of the voxels ``!= 0`` of a ``(D, H,
    W)`` volume (half-open), or the whole volume where none is."""
    nz = x != 0
    bounds = []
    for axis in range(3):
        other = tuple(a for a in range(3) if a != axis)
        idx = torch.nonzero(nz.any(dim=other[1]).any(dim=other[0])).flatten()
        if idx.numel() == 0:
            return (0, x.shape[0], 0, x.shape[1], 0, x.shape[2])
        bounds += [int(idx[0]), int(idx[-1]) + 1]
    return tuple(bounds)


def normalise_ct(x: torch.Tensor, ct: dict) -> torch.Tensor:
    """nnU-Net's ``CTNormalization`` in float32."""
    x = torch.clamp(x.float(), float(ct["lower"]), float(ct["upper"]))
    return (x - float(ct["mean"])) / max(float(ct["std"]), 1e-8)


def preprocess(volume: np.ndarray, spacing_zyx: Optional[Sequence[float]], plan: dict,
               device) -> dict:
    """A ``(D, H, W)`` LPS volume (HU) → ``{"normalized": (d, h, w)
    float32 on the device, "box": the crop box, "crop_shape",
    "full_shape"}``. ``spacing_zyx`` None (a bare array) is taken as the
    plan's spacing: no resampling."""
    x = torch.from_numpy(np.ascontiguousarray(volume)).to(device)
    box = nonzero_box(x)
    z0, z1, y0, y1, x0, x1 = box
    x = normalise_ct(x[z0:z1, y0:y1, x0:x1], plan["ct"])
    crop = tuple(x.shape)
    target = float(plan["spacing"])
    spacing = (target,) * 3 if spacing_zyx is None else spacing_zyx
    new_shape = resample3d.resampled_shape(crop, spacing, target)
    x = resample3d.zoom(x, new_shape, int(plan["data_order"]))
    return {"normalized": x, "box": box, "crop_shape": crop, "full_shape": tuple(volume.shape)}
