"""nnU-Net's resampling of a volume (``skimage.transform.resize(order,
mode="edge", anti_aliasing=False)``, which is ``scipy.ndimage.zoom(order,
mode="nearest", grid_mode=True)`` to an explicit output shape) as one
matrix product per axis on the device.

Both orders that nnU-Net uses are linear in the data and separable, so
along each axis the whole operation is a fixed ``(n_out, n_in)`` matrix,
built once per shape pair on the host in float64 (:func:`zoom_matrix`) and
applied on the device in float32 (:func:`zoom`; a float32 matmul is full
float32 unless TF32 is turned on for matmuls, which the port never does):

* output index ``i`` maps to input coordinate ``c = (i + 0.5)·n_in/n_out −
  0.5`` (``grid_mode``);
* order 1: linear between ``floor(c)`` and ``floor(c) + 1``, indices
  clamped into ``[0, n_in − 1]`` (mode ``nearest``);
* order 3: scipy pads the line by 12 samples of its edge values
  (``_prepad_for_spline_filter``), turns the padded line into cubic
  B-spline coefficients (the exact inverse of the ``[1, 4, 1]/6``
  tridiagonal system, mirror-symmetric at the padded ends) and evaluates
  the spline at ``c`` from the four coefficients around it. A change of the
  end condition at the padded ends reaches the unpadded line damped by
  ``(2 − √3)^12`` ≈ 1.4e-7.

An axis whose size does not change is left as it is: at order 1 the
coordinates fall on the samples, and the cubic spline interpolates them.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

PAD = 12  # scipy's pre-padding for the spline filter in mode "nearest"


def _coords(n_in: int, n_out: int) -> np.ndarray:
    return (np.arange(n_out, dtype=np.float64) + 0.5) * (np.float64(n_in) / n_out) - 0.5


def _linear(n_in: int, n_out: int) -> np.ndarray:
    m = np.zeros((n_out, n_in), np.float64)
    c = _coords(n_in, n_out)
    lo = np.floor(c)
    w = c - lo
    rows = np.arange(n_out)
    np.add.at(m, (rows, np.clip(lo.astype(np.int64), 0, n_in - 1)), 1.0 - w)
    np.add.at(m, (rows, np.clip(lo.astype(np.int64) + 1, 0, n_in - 1)), w)
    return m


def _cubic(n_in: int, n_out: int) -> np.ndarray:
    n = n_in + 2 * PAD
    pad = np.zeros((n, n_in), np.float64)  # edge padding
    pad[np.arange(n), np.clip(np.arange(n) - PAD, 0, n_in - 1)] = 1.0
    a = np.zeros((n, n), np.float64)  # samples = A · coefficients
    idx = np.arange(n)
    a[idx, idx] = 4.0 / 6.0
    if n > 1:
        a[idx[:-1], idx[:-1] + 1] = 1.0 / 6.0
        a[idx[1:], idx[1:] - 1] = 1.0 / 6.0
        a[0, 1] = a[n - 1, n - 2] = 2.0 / 6.0  # mirror: c[-1] = c[1]
    coef = np.linalg.solve(a, pad)  # (n, n_in)
    c = _coords(n_in, n_out) + PAD
    fl = np.floor(c)
    t = c - fl
    taps = [(1 - t) ** 3 / 6, (3 * t ** 3 - 6 * t ** 2 + 4) / 6,
            (-3 * t ** 3 + 3 * t ** 2 + 3 * t + 1) / 6, t ** 3 / 6]
    ev = np.zeros((n_out, n), np.float64)
    rows = np.arange(n_out)
    for k, wk in enumerate(taps):
        np.add.at(ev, (rows, np.clip(fl.astype(np.int64) - 1 + k, 0, n - 1)), wk)
    return ev @ coef


@functools.lru_cache(maxsize=64)
def zoom_matrix(n_in: int, n_out: int, order: int) -> np.ndarray:
    """The float64 ``(n_out, n_in)`` matrix of nnU-Net's resize along one
    axis at ``order`` 1 or 3 (read-only; cached per shape pair)."""
    if order not in (1, 3):
        raise ValueError(f"order must be 1 or 3, got {order}")
    m = _linear(n_in, n_out) if order == 1 else _cubic(n_in, n_out)
    m.setflags(write=False)
    return m


def zoom(x: torch.Tensor, out_shape: Sequence[int], order: int) -> torch.Tensor:
    """``(D, H, W)`` float32 volume → ``out_shape``, one axis at a time
    (the axis that shrinks most first), each a float32 matmul on ``x``'s
    device."""
    if x.ndim != 3 or len(out_shape) != 3:
        raise ValueError("zoom takes a (D, H, W) volume and a 3-D shape")
    x = x.float()
    axes = [a for a in range(3) if x.shape[a] != int(out_shape[a])]
    for a in sorted(axes, key=lambda a: int(out_shape[a]) / x.shape[a]):
        m = torch.tensor(zoom_matrix(x.shape[a], int(out_shape[a]), order),
                         dtype=torch.float32, device=x.device)
        if a == 2:
            x = torch.matmul(x, m.t())
        elif a == 1:
            x = torch.matmul(m, x)
        else:
            d, h, w = x.shape
            x = torch.matmul(m, x.reshape(d, h * w)).reshape(-1, h, w)
    return x.contiguous()


def resampled_shape(shape: Sequence[int], spacing: Sequence[float], target: float):
    """nnU-Net's ``compute_new_shape``: ``round(shape × spacing / target)``
    (numpy's rounding), with ``spacing`` in the array's axis order."""
    return tuple(int(v) for v in np.round(np.asarray(spacing, np.float64) / float(target)
                                          * np.asarray(shape, np.float64)).astype(int))
