"""Seeded lung-like CT volumes, made on the device in a few large calls.

A vectorised rewrite of the port's ``models/synthetic.lung_phantom``: air
−1000 HU, an elliptic body, a left lung near −850 HU and a right lung near
−550 HU (the bands the crafted weights of :mod:`portbench.weights` label 2
and 1), vessels at body density drifting through the lungs from slice to
slice, small pockets of lung density in the body, and ±30 HU of noise. The
seed moves the ellipses' sizes and centres, the vessels, the pockets, the
noise and each tissue's HU offset; the shape, the int16 type and the HU
margins to the weights' thresholds (−925, −650, −400 HU) never move.

``labels`` is the matching lung mask (1 right lung, 2 left lung, R231's
classes), vessels included, for the fine-tuning cell.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Direction cosines (columns: image axes x, y, z in LPS space) of a RAS
# volume, as NIfTI files from most scanners carry: x points right, y
# anterior. ``LMInferer`` reorients it to LPS and back.
RAS = np.diag([-1.0, -1.0, 1.0])


def _rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, int(index)])


def volume(seed: int, index: int, n_slices: int, size: int,
           device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """Volume ``index`` of the pool drawn from ``seed``: (int16 HU
    (n_slices, size, size), uint8 lung labels of the same shape)."""
    rng = _rng(seed, index)
    h = w = size
    f = torch.float32
    yy = torch.arange(h, device=device, dtype=f).view(h, 1)
    xx = torch.arange(w, device=device, dtype=f).view(1, w)

    def ellipse(cy, cx, ry, rx):
        return ((yy - cy * h) / (ry * h)) ** 2 + ((xx - cx * w) / (rx * w)) ** 2 < 1

    u = rng.uniform
    cy = 0.5 + u(-0.02, 0.02)
    body = ellipse(0.5 + u(-0.02, 0.02), 0.5 + u(-0.02, 0.02), 0.40 + u(-0.02, 0.02),
                   0.35 + u(-0.02, 0.02))
    lung_l = ellipse(cy, 0.35 + u(-0.01, 0.01), 0.20 + u(-0.015, 0.015), 0.12 + u(-0.01, 0.01))
    lung_r = ellipse(cy, 0.65 + u(-0.01, 0.01), 0.20 + u(-0.015, 0.015), 0.12 + u(-0.01, 0.01))
    hu_body = int(40 + rng.integers(-15, 16))
    hu_l = int(-850 + rng.integers(-20, 21))
    hu_r = int(-550 + rng.integers(-20, 21))

    base = torch.full((h, w), -1000, dtype=torch.int16, device=device)
    base[body] = hu_body
    base[lung_l] = hu_l
    base[lung_r] = hu_r
    lab = torch.zeros((h, w), dtype=torch.uint8, device=device)
    lab[lung_r] = 1
    lab[lung_l] = 2
    vol = base.expand(n_slices, h, w).clone()

    z = torch.arange(n_slices, device=device, dtype=f).view(-1, 1, 1)
    y3, x3 = yy.view(1, h, 1), xx.view(1, 1, w)
    for lung, cx in ((lung_l, 0.35), (lung_r, 0.65)):
        for _ in range(6):
            vy = rng.uniform(0.42, 0.58) * h
            vx = rng.uniform(cx - 0.06, cx + 0.06) * w
            r = float(rng.integers(2, 6)) * size / 512
            phase = rng.uniform(0, 2 * np.pi)
            cyz = vy + 6 * size / 512 * torch.sin(phase + z / 17.0)
            cxz = vx + 6 * size / 512 * torch.cos(phase + z / 23.0)
            disk = ((y3 - cyz) ** 2 + (x3 - cxz) ** 2 < r * r) & lung
            vol[disk] = hu_body
    for j in range(4):
        z0 = int(rng.integers(0, max(1, n_slices - 4)))
        z1 = min(n_slices, z0 + int(rng.integers(4, 20)))
        py, px = rng.uniform(0.25, 0.75) * h, rng.uniform(0.2, 0.8) * w
        r = float(rng.integers(2, 5)) * size / 512
        disk = ((yy - py) ** 2 + (xx - px) ** 2 < r * r) & body & ~lung_l & ~lung_r
        vol[z0:z1][disk.expand(z1 - z0, h, w)] = hu_r if j % 2 else hu_l
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(0, 2**62)))
    vol += torch.randint(-30, 30, vol.shape, generator=gen, device=device, dtype=torch.int16)
    return vol.cpu().numpy(), lab.expand(n_slices, h, w).cpu().numpy()


def pool(seed: int, count: int, n_slices: int, size: int, device: torch.device):
    """``count`` volumes of ``n_slices`` slices from ``seed``: a list of
    (volume, labels)."""
    return [volume(seed, i, n_slices, size, device) for i in range(count)]
