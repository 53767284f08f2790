"""LMInferer: the public inference orchestrator (counterpart of
``lungmask_tpu.inferer``), single model.

Same constructor and ``apply()`` contract as the JAX package: a
geometry-carrying :class:`MedicalImage` is processed in LPS orientation and
returned in its own; a numpy ``(z, y, x)`` volume passes through. The main
path is hybrid preprocessing (``transforms/preprocess.py``, the bodymask
kernel K1 on the device), the U-Net (``runtime/engine.py``), exact host
postprocessing (``transforms/postprocess.py`` → the native core) and the
native paste-back.

Device rule: the device is resolved once. ``force_cpu=True`` or
``device="cpu"`` mean the CPU; otherwise a CUDA device is required and its
absence raises — the inferer never quietly continues on the CPU.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Union

import numpy as np
import torch

from lungmask_tpu_torch.io.image import MedicalImage, reorient
from lungmask_tpu_torch.logger import logger
from lungmask_tpu_torch.models.registry import MODEL_URLS, get_model
from lungmask_tpu_torch.ops import resample
from lungmask_tpu_torch.runtime.engine import UNetRunner
from lungmask_tpu_torch.transforms import postprocess, preprocess
from lungmask_tpu_torch.utils.profiling import StageTimer

ImageLike = Union[MedicalImage, np.ndarray]


def resolve_device(device=None, force_cpu: bool = False) -> torch.device:
    """``force_cpu`` or ``device="cpu"`` → CPU; an explicit CUDA device or
    ``None`` → CUDA, which must exist."""
    if force_cpu:
        return torch.device("cpu")
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass force_cpu=True or device='cpu' "
            "(--cpu on the command line) to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to lungmask_tpu_torch yet (ROADMAP.md queue 1, item {item})"
    )


class _NullBar:
    def update(self, n: int = 1) -> None:
        pass


class LMInferer:
    def __init__(
        self,
        modelname: str = "R231",
        modelpath: Optional[str] = None,
        fillmodel: Optional[str] = None,
        fillmodel_path: Optional[str] = None,
        force_cpu: bool = False,
        batch_size: Optional[int] = None,
        volume_postprocessing: bool = True,
        tqdm_disable: bool = False,
        preprocessing: Optional[str] = None,
        precision: str = "bfloat16",
        mesh=None,
        postprocessing_mode: str = "exact",
        device=None,
    ):
        """Lung-mask inference.

        Args:
            modelname: model to apply ('R231', 'LTRCLobes', 'R231CovidWeb').
            modelpath: path to weights (.pth or converted .npz); overrides
                ``modelname``, and the class count comes from the weights.
            fillmodel / fillmodel_path: the fused two-model mode — not ported
                yet (ROADMAP.md queue 1, item 4).
            force_cpu: run on the CPU.
            batch_size: slices per forward (default 32).
            volume_postprocessing: connected-component cleanup toggle.
            tqdm_disable: disable progress output (tqdm is optional).
            preprocessing: None or 'hybrid'; the other modes are ROADMAP.md
                queue 1, item 5.
            precision: 'bfloat16' (default) or 'float32' (cuDNN TF32 off).
            mesh: multi-device sharding — not ported yet (item 10).
            postprocessing_mode: 'exact'; 'device' is item 6.
            device: 'cuda', 'cuda:N' or 'cpu'; None means CUDA.
        """
        if modelname not in MODEL_URLS:
            raise ValueError(
                f"Modelname not found. Please choose from: {list(MODEL_URLS)}"
            )
        if fillmodel is not None or fillmodel_path is not None:
            raise _not_ported("the fused two-model mode (fillmodel)", 4)
        if preprocessing not in (None, "hybrid"):
            raise _not_ported(f"preprocessing={preprocessing!r}", 5)
        if mesh is not None:
            raise _not_ported("multi-device sharding (mesh=)", 10)
        if postprocessing_mode != "exact":
            raise _not_ported(f"postprocessing_mode={postprocessing_mode!r}", 6)
        if precision not in ("bfloat16", "float32"):
            raise ValueError(f"precision must be 'bfloat16' or 'float32', got {precision!r}")

        self.device = resolve_device(device, force_cpu)
        self._compute_dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
        if modelpath is not None:
            modelname = os.path.basename(modelpath)
        self.modelname = modelname
        self.batch_size = batch_size
        self.volume_postprocessing = volume_postprocessing
        self.tqdm_disable = tqdm_disable
        self.timings = StageTimer()
        logger.info(f"lungmask_tpu_torch running on {self.device}")

        params, n_classes = get_model(modelname, modelpath)
        self.model = UNetRunner(
            params,
            n_classes,
            batch_size=batch_size,
            compute_dtype=self._compute_dtype,
            device=self.device,
        )

    # ------------------------------------------------------------------

    def _preprocess(self, volume: np.ndarray):
        """→ (normalized device slices (N, 256, 256), boxes (N, 4))."""
        return preprocess.preprocess_hybrid(
            volume,
            resolution=(256, 256),
            compute_dtype=self._compute_dtype,
            device=self.device,
        )

    def _to_lps(self, image: ImageLike):
        """Input normalization (reference mask.py:153-164): numpy passthrough,
        geometry-carrying images reoriented to LPS."""
        if isinstance(image, np.ndarray):
            return self._hu_capable(image.copy()), None, None
        curr_orient = image.orientation()
        if curr_orient != "LPS":
            image = reorient(image, "LPS")
        return self._hu_capable(image.array), curr_orient, image

    @staticmethod
    def _hu_capable(arr: np.ndarray) -> np.ndarray:
        """Voxels must be able to hold the HU window bounds: unsigned and
        narrow inputs are promoted to the smallest signed type that covers
        their range and the window; int16/int32/float pass untouched."""
        kind, size = arr.dtype.kind, arr.dtype.itemsize
        if kind == "u":
            return arr.astype({1: np.int16, 2: np.int32}.get(size, np.int64))
        if kind in "ib" and size < 2:
            return arr.astype(np.int16)
        return arr

    def _from_lps(self, outmask, curr_orient, lps_image) -> np.ndarray:
        """Reorient a result back to the input orientation (mask.py:204-208)."""
        if curr_orient is None or curr_orient == "LPS":
            return outmask.astype(np.uint8)
        out_img = MedicalImage(
            outmask,
            spacing=lps_image.spacing,
            origin=lps_image.origin,
            direction=lps_image.direction,
        )
        return reorient(out_img, curr_orient).array.astype(np.uint8)

    def _stage_bar(self):
        """Per-volume progress over the four pipeline stages."""
        try:
            from tqdm import tqdm
        except ImportError:
            return contextlib.nullcontext(_NullBar())
        return tqdm(
            total=4, disable=self.tqdm_disable, desc="inference", unit="stage", leave=False
        )

    def _infer_volume(self, inimg_raw: np.ndarray) -> np.ndarray:
        """LPS-space volume → mask (preprocess → U-Net → postprocess → paste)."""
        with self._stage_bar() as bar:
            with self.timings.stage("preprocess"):
                normalized, boxes = self._preprocess(inimg_raw)
            bar.update(1)
            with self.timings.stage("unet"):
                pred = self.model.run_numpy(normalized)
            bar.update(1)
            return self._finish_volume(
                pred, boxes, inimg_raw.shape[1:], self.model.n_classes, bar=bar
            )

    def _finish_volume(self, pred_np, boxes, slice_shape, n_classes, bar=None) -> np.ndarray:
        """Host finishing stages: exact postprocess + paste-back."""
        if self.volume_postprocessing:
            with self.timings.stage("postprocess"):
                outmask = postprocess.postprocessing(pred_np, disable_tqdm=self.tqdm_disable)
        else:
            outmask = pred_np
        if bar is not None:
            bar.update(1)
        with self.timings.stage("paste_back"):
            out = resample.paste_masks_host(outmask, boxes, slice_shape).astype(np.uint8)
        if bar is not None:
            bar.update(1)
        return out

    # -- split-phase API ----------------------------------------------------

    def preprocess_image(self, image: ImageLike) -> dict:
        """Phase 1 of :meth:`apply`: orientation normalization + hybrid
        preprocessing (the normalized stack ends on the device)."""
        inimg_raw, curr_orient, lps_image = self._to_lps(image)
        with self.timings.stage("preprocess"):
            normalized, boxes = self._preprocess(inimg_raw)
        return {
            "inimg_raw": inimg_raw,
            "curr_orient": curr_orient,
            "lps_image": lps_image,
            "normalized": normalized,
            "boxes": boxes,
        }

    def forward_preprocessed(self, pre: dict) -> np.ndarray:
        """Phase 2a: the U-Net forward; returns the host class map."""
        with self.timings.stage("unet"):
            return self.model.run_numpy(pre["normalized"])

    def finish_forward(self, pre: dict, pred) -> np.ndarray:
        """Phase 2b: postprocess + paste-back + reorientation."""
        outmask = self._finish_volume(
            pred, pre["boxes"], pre["inimg_raw"].shape[1:], self.model.n_classes
        )
        return self._from_lps(outmask, pre["curr_orient"], pre["lps_image"])

    def apply_preprocessed(self, pre: dict) -> np.ndarray:
        """Phase 2 of :meth:`apply` on a :meth:`preprocess_image` result."""
        return self.finish_forward(pre, self.forward_preprocessed(pre))

    def apply(self, image: ImageLike) -> np.ndarray:
        """Apply the model to a volumetric image; returns the uint8 label
        volume in the input's own geometry and axis order."""
        inimg_raw, curr_orient, lps_image = self._to_lps(image)
        outmask = self._infer_volume(inimg_raw)
        return self._from_lps(outmask, curr_orient, lps_image)
