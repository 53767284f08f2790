"""nnU-Net's sliding-window inference of a 3-D model (MIC-DKFZ/nnUNet v2,
``nnUNetPredictor.predict_sliding_window_return_logits``), on the device.

* The volume is padded with 0 to at least the patch on each axis, half the
  difference before (``pad_nd_image``).
* Along each axis of size ``n`` the window takes
  ``ceil((n − p) / (p · step)) + 1`` positions at ``round(i · (n − p) /
  (steps − 1))`` (:func:`compute_steps`, numpy's rounding).
* Each patch's logits, times a Gaussian importance map (a centred impulse
  through ``gaussian_filter`` with σ = ``p · sigma_scale``, mode
  ``constant``; divided by its maximum and multiplied by 10; zeros replaced
  by the smallest nonzero value; :func:`gaussian_map`), are added into a
  whole-volume float32 accumulator, and the map into a weight sum; at the
  end the accumulator is divided by the sum and the padding cut off.

Departures from nnU-Net's predictor: no test-time mirroring (nnU-Net's
default averages 8 flips); the map and the accumulator are float32 (nnU-Net
keeps the map in fp16 under autocast); several patches go through the
network in one forward (``patches_per_forward`` of the plan).

Every patch that goes through the network is counted in
:data:`PATCHES` (``PATCHES.value``), a process-wide counter like the
kernels' launch counters, so that a run can show how many patches its
volumes took.
"""

from __future__ import annotations

import itertools
import math
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from lungmask_tpu_torch.models.unet3d import UNet3D
from lungmask_tpu_torch.ops.kernels import export3d
from lungmask_tpu_torch.ops.packing import unpack_bits_np
from lungmask_tpu_torch.transforms import nnunet3d, postprocess


class _Counter:
    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def add(self, n: int) -> None:
        with self._lock:
            self.value += int(n)


PATCHES = _Counter()


def compute_steps(image_size: Sequence[int], patch: Sequence[int], step: float
                  ) -> List[List[int]]:
    """The window's start positions along each axis (nnU-Net's
    ``compute_steps_for_sliding_window``); ``image_size`` ≥ ``patch``."""
    out = []
    for n, p in zip(image_size, patch):
        n, p = int(n), int(p)
        if n < p:
            raise ValueError(f"image size {n} under the patch {p}: pad first")
        count = int(math.ceil((n - p) / (p * float(step)))) + 1
        if count > 1:
            stride = (n - p) / (count - 1)
            out.append([int(np.round(stride * i)) for i in range(count)])
        else:
            out.append([0])
    return out


def padding(shape: Sequence[int], patch: Sequence[int]) -> List[Tuple[int, int]]:
    """(before, after) zeros on each axis to reach at least the patch."""
    out = []
    for n, p in zip(shape, patch):
        diff = max(int(p) - int(n), 0)
        out.append((diff // 2, diff - diff // 2))
    return out


def gaussian_map(patch: Sequence[int], sigma_scale: float = 1.0 / 8,
                 value_scale: float = 10.0) -> np.ndarray:
    """nnU-Net's importance map as float32: per axis the discrete Gaussian
    that ``scipy.ndimage.gaussian_filter`` (truncate 4, mode ``constant``)
    gives a centred impulse, their outer product over its maximum times
    ``value_scale``, zeros raised to the smallest nonzero value."""
    g = np.ones((), np.float64)
    for p in patch:
        p = int(p)
        sigma = p * float(sigma_scale)
        radius = int(4.0 * sigma + 0.5)
        k = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
        k /= k.sum()
        off = np.arange(p) - p // 2
        line = np.where(np.abs(off) <= radius, k[np.clip(off + radius, 0, 2 * radius)], 0.0)
        g = np.multiply.outer(g, line)
    g = g / g.max() * float(value_scale)
    if (g == 0).any():
        g[g == 0] = g[g > 0].min()
    return g.astype(np.float32)


class SlidingWindowRunner:
    """Holds the 3-D U-Net on its device and runs whole volumes through
    it: :meth:`logits` of a normalised ``(d, h, w)`` volume."""

    def __init__(self, params, plan: dict, device, compute_dtype=torch.bfloat16):
        self.device = torch.device(device)
        self.net = UNet3D(params, plan, self.device, compute_dtype)
        self.n_classes = self.net.n_classes
        self.patch = [int(p) for p in plan["patch"]]
        self.step = float(plan["step"])
        self.batch = max(1, int(plan.get("patches_per_forward", 1)))
        self.gauss = torch.from_numpy(gaussian_map(self.patch, float(plan["sigma_scale"]))).to(
            self.device)
        self._weight_sum: Tuple[tuple, torch.Tensor] = ((), None)

    def windows(self, shape: Sequence[int]) -> List[Tuple[slice, slice, slice]]:
        """The patches' slices of a padded volume of ``shape``, in
        nnU-Net's order (z outermost)."""
        steps = compute_steps(shape, self.patch, self.step)
        return [tuple(slice(s, s + p) for s, p in zip(corner, self.patch))
                for corner in itertools.product(*steps)]

    def weight_sum(self, shape: Sequence[int]) -> torch.Tensor:
        """The Gaussian maps of every window of a padded ``shape`` summed
        (kept for the last shape, which a stream of equal volumes reuses)."""
        key = tuple(int(s) for s in shape)
        if self._weight_sum[0] != key:
            ws = torch.zeros(key, dtype=torch.float32, device=self.device)
            for sl in self.windows(key):
                ws[sl] += self.gauss
            self._weight_sum = (key, ws)
        return self._weight_sum[1]

    def logits(self, vol: torch.Tensor) -> torch.Tensor:
        """``(d, h, w)`` normalised float32 volume → ``(K, d, h, w)``
        float32 logits on the runner's device."""
        pads = padding(vol.shape, self.patch)
        x = vol.to(self.device, torch.float32)
        if any(a or b for a, b in pads):
            flat = [v for a, b in reversed(pads) for v in (a, b)]
            x = torch.nn.functional.pad(x, flat)
        shape = tuple(x.shape)
        acc = torch.zeros((self.n_classes,) + shape, dtype=torch.float32, device=self.device)
        wins = self.windows(shape)
        with torch.inference_mode():
            for i in range(0, len(wins), self.batch):
                group = wins[i:i + self.batch]
                batch = torch.stack([x[sl] for sl in group]).unsqueeze(1)
                out = self.net(batch)
                PATCHES.add(len(group))
                for j, sl in enumerate(group):
                    acc[(slice(None),) + sl].addcmul_(out[j], self.gauss)
            acc /= self.weight_sum(shape)
        crop = tuple(slice(a, n - b) for (a, b), n in zip(pads, shape))
        return acc[(slice(None),) + crop].contiguous()


class VolumePipeline:
    """A 3-D model's phases behind ``LMInferer`` (its ``model`` a
    :class:`SlidingWindowRunner`), on the front's device, with the front's
    stage timer, settings and synchronisation."""

    def __init__(self, front, plan: dict):
        self.front = front
        self.plan = plan

    def preprocess(self, volume: np.ndarray, lps_image) -> dict:
        """nnU-Net's preprocessing (:func:`nnunet3d.preprocess`) at the
        image's spacing (a bare array: the plan's)."""
        spacing = None if lps_image is None else tuple(reversed(lps_image.spacing))
        return self.front._synced(nnunet3d.preprocess(volume, spacing, self.plan,
                                                      self.front.device))

    def forward(self, pre: dict) -> torch.Tensor:
        """The (K, d, h, w) float32 logits, left on the device."""
        return self.front._synced(self.front.model.logits(pre["normalized"]))

    def finish(self, pre: dict, logits: torch.Tensor) -> np.ndarray:
        """The logits exported to the input grid, argmax and pasted into
        the uncropped volume on the device, 4 bits a voxel where they fit
        (stage ``export``, its download and unpack included); the host
        postprocessing; the reorientation back."""
        f = self.front
        with f.timings.stage("export"):
            packed = export3d.export_packed(logits, pre["box"], pre["full_shape"]).cpu().numpy()
            per = export3d.packing(f.model.n_classes, pre["full_shape"][2])
            mask = unpack_bits_np(packed, 8 // per)
        if f.volume_postprocessing:
            with f.timings.stage("postprocess"):
                mask = postprocess.postprocessing(mask, disable_tqdm=f.tqdm_disable)
        return f._from_lps(mask, pre["curr_orient"], pre["lps_image"])
