"""A toy model family for the harness's tests: the "model" is one HU
threshold drawn from the seed, the inferer marks every voxel above it, and
the plain reference is the same comparison in NumPy. It brings no
training step, no control and no fault."""

import time

import numpy as np
import torch


class _Timings:
    def __init__(self):
        self.totals = {}

    def reset(self):
        self.totals = {}


class ThresholdInferer:
    def __init__(self, theta: float, device: torch.device):
        self.theta, self.device, self.timings = theta, device, _Timings()

    def apply(self, image) -> np.ndarray:
        t0 = time.perf_counter()
        vol = torch.as_tensor(np.asarray(image.array), device=self.device)
        out = (vol > self.theta).to(torch.uint8).cpu().numpy()
        totals = self.timings.totals
        totals["unet"] = totals.get("unet", 0.0) + time.perf_counter() - t0
        return out


def weights(run):
    u = np.random.default_rng([run.seed % 2**63, 11]).random()
    return [{"theta": np.float32(run.config["theta_hu"] + run.config["theta_spread"] * u)}]


def inferer(run, trees):
    return ThresholdInferer(float(trees[0]["theta"]), run.device)


def forward_cost(config, shape, spacing):
    n = float(np.prod(shape))
    return {"flops": n, "bound_s": 3.0 * n / 3.35e12}


def outputs(run, inferer, images, sampled):
    return {i: inferer.apply(images[i]) for i in sampled}


def checks(run, masks, out, images, trees):
    theta = float(trees[0]["theta"])
    worst = 0.0 if masks else 1.0
    for i, kept in sorted(masks.items()):
        want = (np.asarray(images[i].array) > theta).astype(np.uint8)
        for m in list(kept) + [out[i]]:
            worst = max(worst, float(np.mean(m != want)) if m.shape == want.shape else 1.0)
    return [["mask_mismatch", worst, run.limit("mask_mismatch")]]


def shrink(cell):
    cell["traffic"].update(slices=4, size=64)
