"""nnU-Net's 3-D full-resolution U-Net and its inference pipeline in plain
float32 PyTorch and NumPy/SciPy, written from the published code of
MIC-DKFZ/nnUNet v2 (``DefaultPreprocessor.run_case_npy``,
``CTNormalization``, ``resample_data_or_seg_to_shape``,
``nnUNetPredictor.predict_sliding_window_return_logits``, ``compute_gaussian``,
``compute_steps_for_sliding_window``,
``convert_predicted_logits_to_segmentation_with_correct_shape``) and
``dynamic_network_architectures`` ``PlainConvUNet`` (Isensee et al., Nature
Methods 18, 2021). It imports nothing of ``lungmask_tpu_torch`` or of the
JAX package; TF32 is off (``reference/__init__.py``).

* Network (:func:`logits`): per encoder stage two 3×3×3 convs with bias,
  padding 1, the first with the stage's stride, each followed by
  ``F.instance_norm`` (affine, eps from the plan) and ``F.leaky_relu``;
  per decoder level ``F.conv_transpose3d`` (kernel 2, stride 2, bias), the
  skip concatenated after it, two conv blocks; the last level's 1×1×1 head.
* Preprocessing (:func:`preprocess`): the box of ``x != 0`` with its holes
  filled (``binary_fill_holes``), the crop; clip to ``[lower, upper]`` and
  z-score with the plan's values (before the resample, as nnU-Net does);
  ``scipy.ndimage.zoom(order=3, mode="nearest", grid_mode=True)`` to
  ``round(shape × spacing / target)`` (``skimage.transform.resize(order=3,
  mode="edge", anti_aliasing=False)``), in float64.
* Sliding window (:func:`sliding_window`): zero padding to the patch, the
  steps, the Gaussian map from ``scipy.ndimage.gaussian_filter``, one patch
  at a time, the logits times the map summed into a whole-volume
  accumulator and the map into a weight sum, then divided.
* Export (:func:`export`): each class's logits ``scipy.ndimage.zoom(order=1,
  mode="nearest", grid_mode=True)`` to the cropped shape, the argmax (that
  of the softmax), pasted into the uncropped shape, 0 outside the box.

Departures from nnU-Net, each also the port's: no test-time mirroring; the
map, the accumulator and the network in float32 (nnU-Net runs fp16 autocast
with an fp16 map); the model's plan, not a dataset fingerprint, gives the
normalisation values.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from portbench.reference.unet import Quant

Box = Tuple[int, int, int, int, int, int]


def tensors(flat: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The flat tree (torch layouts) as float32 tensors on ``device``."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in flat.items()}


def _stage(p, x, prefix, n, stride, plan, q):
    for i in range(n):
        key = f"{prefix}.convs.{i}"
        w = p[key + ".conv.weight"]
        x = F.conv3d(q(x), q(w), p[key + ".conv.bias"], stride=stride if i == 0 else 1,
                     padding=w.shape[-1] // 2)
        x = F.instance_norm(x, weight=p[key + ".norm.weight"], bias=p[key + ".norm.bias"],
                            eps=float(plan["norm_eps"]))
        x = F.leaky_relu(x, float(plan["leaky_slope"]))
    return x


def logits(p: Dict[str, torch.Tensor], x: torch.Tensor, plan: dict, quant: Quant = None,
           head_input: bool = False):
    """``(N, 1, P, P, P)`` patches → ``(N, K, P, P, P)`` float32 logits
    (with ``head_input`` also the head's input). ``quant`` rounds every
    conv's input and weight (the lower-precision control)."""
    q = quant or (lambda t: t)
    feats = plan["features"]
    skips = []
    for s in range(len(feats)):
        x = _stage(p, x, f"encoder.stages.{s}.0", int(plan["convs_per_stage"]),
                   int(plan["strides"][s]), plan, q)
        skips.append(x)
    x = skips.pop()
    for j in range(len(feats) - 1):
        w = p[f"decoder.transpconvs.{j}.weight"]
        up = F.conv_transpose3d(q(x), q(w), p[f"decoder.transpconvs.{j}.bias"], stride=2)
        x = _stage(p, torch.cat([up, skips.pop()], 1), f"decoder.stages.{j}",
                   int(plan["decoder_convs_per_stage"]), 1, plan, q)
    head = f"decoder.seg_layers.{len(feats) - 2}"
    out = F.conv3d(q(x), q(p[head + ".weight"]), p[head + ".bias"])
    return (out, x) if head_input else out


def steps(size: Sequence[int], patch: Sequence[int], step: float):
    """nnU-Net's ``compute_steps_for_sliding_window``."""
    out = []
    for n, p in zip(size, patch):
        k = int(np.ceil((n - p) / (p * step))) + 1
        stride = (n - p) / (k - 1) if k > 1 else 99999999999
        out.append([int(np.round(stride * i)) for i in range(k)])
    return out


def gaussian(patch: Sequence[int], sigma_scale: float, value_scale: float = 10.0) -> np.ndarray:
    """nnU-Net's ``compute_gaussian`` in float32."""
    tmp = np.zeros(tuple(patch))
    tmp[tuple(p // 2 for p in patch)] = 1
    g = ndimage.gaussian_filter(tmp, [p * sigma_scale for p in patch], 0, mode="constant",
                                cval=0)
    g = g / (g.max() / value_scale)
    g = g.astype(np.float32)
    g[g == 0] = g[g != 0].min()
    return g


def sliding_window(p: Dict[str, torch.Tensor], vol: np.ndarray, plan: dict, device,
                   quant: Quant = None):
    """A normalised ``(d, h, w)`` volume → (``(K, d, h, w)`` float32 logits,
    per class the scale of the head's terms, both on the host). The scale
    of class ``k`` is √(Σ over voxels of Σ_c (w_kc·y_c)², each patch's term
    weighted as the logits are, + b_k² per voxel): what a rounding error in
    a class's logits is measured against, as for the 2-D U-Net
    (``reference/unet.scores``)."""
    patch = [int(v) for v in plan["patch"]]
    shape = vol.shape
    pads = [(max(pp - n, 0) // 2, max(pp - n, 0) - max(pp - n, 0) // 2)
            for n, pp in zip(shape, patch)]
    x = torch.tensor(np.pad(vol.astype(np.float32), pads), device=device)
    g = torch.tensor(gaussian(patch, float(plan["sigma_scale"])), device=device)
    k = int(plan["n_classes"])
    head = f"decoder.seg_layers.{len(plan['features']) - 2}"
    w2 = p[head + ".weight"][:, :, 0, 0, 0] ** 2
    acc = torch.zeros((k,) + tuple(x.shape), device=device)
    sq = torch.zeros_like(acc)
    wsum = torch.zeros(tuple(x.shape), device=device)
    with torch.no_grad():
        sz, sy, sx = steps(x.shape, patch, float(plan["step"]))
        for corner in [(a, b, c) for a in sz for b in sy for c in sx]:
            sl = tuple(slice(c, c + pp) for c, pp in zip(corner, patch))
            out, y = logits(p, x[sl][None, None], plan, quant, head_input=True)
            acc[(slice(None),) + sl] += out[0] * g
            sq[(slice(None),) + sl] += torch.einsum("kc,cdhw->kdhw", w2, y[0] ** 2) * g * g
            wsum[sl] += g
        acc /= wsum
        sq /= wsum * wsum
        crop = (slice(None),) + tuple(slice(a, n + a) for (a, _), n in zip(pads, shape))
        scale = (sq[crop].sum(dim=(1, 2, 3)) + p[head + ".bias"] ** 2 * math.prod(shape)).sqrt()
        return acc[crop].cpu().numpy(), scale.cpu().numpy()


def class_gap(got: np.ndarray, want: np.ndarray, scale: np.ndarray) -> float:
    """The largest over classes of ‖got − want‖ over the class's scale, of
    two ``(K, …)`` logit arrays."""
    d = (torch.as_tensor(got, dtype=torch.float64) - torch.as_tensor(want, dtype=torch.float64))
    d = d.reshape(d.shape[0], -1).norm(dim=1).numpy()
    return float((d / np.maximum(np.asarray(scale, np.float64), 1e-30)).max())


def nonzero_box(vol: np.ndarray) -> Box:
    """The box of nnU-Net's nonzero mask (``x != 0``, holes filled)."""
    mask = ndimage.binary_fill_holes(vol != 0)
    if not mask.any():
        return (0, vol.shape[0], 0, vol.shape[1], 0, vol.shape[2])
    sl = ndimage.find_objects(mask.astype(np.int8))[0]
    return tuple(v for s in sl for v in (s.start, s.stop))


def resize(x: np.ndarray, new_shape: Sequence[int], order: int) -> np.ndarray:
    """``skimage.transform.resize(x, new_shape, order, mode="edge",
    anti_aliasing=False)`` of a float array, i.e. ``scipy.ndimage.zoom`` in
    grid mode."""
    factors = [o / i for o, i in zip(new_shape, x.shape)]
    if all(f == 1 for f in factors):
        return x.copy()
    return ndimage.zoom(x, factors, order=order, mode="nearest", grid_mode=True)


def preprocess(vol: np.ndarray, spacing_zyx: Sequence[float], plan: dict):
    """A ``(D, H, W)`` LPS volume (HU) → (normalised ``(d, h, w)`` float32,
    the crop box, the cropped shape)."""
    box = nonzero_box(vol)
    z0, z1, y0, y1, x0, x1 = box
    x = vol[z0:z1, y0:y1, x0:x1].astype(np.float32)
    ct = plan["ct"]
    x = np.clip(x, ct["lower"], ct["upper"])
    x = (x - ct["mean"]) / max(ct["std"], 1e-8)
    target = float(plan["spacing"])
    new_shape = [int(round(s / target * n)) for s, n in zip(spacing_zyx, x.shape)]
    out = resize(x.astype(np.float64), new_shape, int(plan["data_order"]))
    return out.astype(np.float32), box, x.shape


def export(lg: np.ndarray, box: Box, crop_shape: Sequence[int], full_shape: Sequence[int],
           map_fn: Callable = map) -> np.ndarray:
    """``(K, d, h, w)`` logits → the uint8 mask of the uncropped shape:
    each class resized at order 1 to ``crop_shape`` (``map_fn`` over the
    classes: a thread pool's ``map`` runs them at once, as SciPy releases
    the GIL), argmax, pasted."""
    up = list(map_fn(lambda c: resize(np.asarray(c, np.float32), crop_shape, 1), lg))
    cls = np.argmax(np.stack(up), axis=0).astype(np.uint8)
    out = np.zeros(tuple(full_shape), np.uint8)
    z0, z1, y0, y1, x0, x1 = box
    out[z0:z1, y0:y1, x0:x1] = cls
    return out
