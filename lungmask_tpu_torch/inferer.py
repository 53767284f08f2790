"""LMInferer: the public inference orchestrator (counterpart of
``lungmask_tpu.inferer``), with the deprecated ``apply`` / ``apply_fused``.

Same constructor and ``apply()`` contract as the JAX package: a
geometry-carrying :class:`MedicalImage` is processed in LPS orientation and
returned in its own; a numpy ``(z, y, x)`` volume passes through. The main
path is hybrid preprocessing (``transforms/preprocess.py``, the bodymask
kernel K1 on the device; slices under 128² and ``preprocessing="host"`` take
the strict host pipeline; ``preprocessing="device"`` runs the whole
preprocessing on the device, K1 included), the U-Net
(``runtime/engine.py``; its pooling and upsampling are the kernels K2 and
K3), exact host postprocessing
(``transforms/postprocess.py`` → the native core) and the native
paste-back. With ``postprocessing_mode="device"`` the class map stays on the
device and is cleaned there (``transforms/postprocess_device.py``); only the
crumb-packed result comes down.

With a device mesh (``mesh=``, ``parallel/mesh.py``) the slices split over
its data axis and, with ``space > 1``, each slab's height into bands over
its row's space devices: preprocessing defaults to ``"sharded"`` (device
mode, each slab on its own data device, then split into bands), the U-Net
runs as ``parallel.ShardedUNetRunner`` and device postprocessing as
``parallel.make_sharded_postprocess``, the class map staying in blocks
until the cleaned mask comes down.

The fused two-model mode (``fillmodel=``, the CLI's ``LTRCLobes_R231``)
preprocesses once, runs both U-Nets chunk by chunk over the one stack,
finishes each model's mask on its own (postprocess + paste + reorient, on
two threads where the host has more than one core and the postprocessing
runs on the host), and fuses the two with
the reference's FN-fill / FP-removal rule (``native.fused_finish``;
reference mask.py:223-232).

A 3-D model (an ``.npz`` whose meta names nnU-Net's ``3d_fullres`` U-Net,
``models/unet3d.py``) takes another path through the same phases:
preprocessing is nnU-Net's on the device (``transforms/nnunet3d.py``: crop to
the nonzero box, CT normalisation, the cubic resample to the plan's spacing),
the forward is nnU-Net's sliding window (``runtime/sliding_window.py``; its
InstanceNorm + LeakyReLU is the kernel ``ops/kernels/norm3d``), and the
finish exports the logits to the input grid, argmax and paste in one kernel
(``ops/kernels/export3d``, stage ``export``) before the host postprocessing
(``volume_postprocessing``) and the reorientation back. The 3-D modules and
Triton are imported only when such a model is loaded. A 3-D model takes no
``fillmodel``, ``mesh``, ``preprocessing`` or device postprocessing, and
runs the plan's patches per forward whatever ``batch_size`` says.

Device rule: the device is resolved once. ``force_cpu=True`` or
``device="cpu"`` mean the CPU; otherwise a CUDA device is required and its
absence raises — the inferer never quietly continues on the CPU. With a
mesh, the mesh's devices are the inferer's (``device`` is its first data
device).
"""

from __future__ import annotations

import contextlib
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

import numpy as np
import torch

from lungmask_tpu_torch.io.image import MedicalImage, reorient
from lungmask_tpu_torch.logger import logger
from lungmask_tpu_torch.models.registry import MODEL_URLS, get_model, model_plan
from lungmask_tpu_torch.ops import native, resample
from lungmask_tpu_torch.parallel.sharded import ShardedUNetRunner, make_sharded_postprocess
from lungmask_tpu_torch.runtime import prefault_host_heap, tune_host_allocator
from lungmask_tpu_torch.runtime.engine import (
    UNetRunner,
    pack_bits,
    run_pair,
    run_pair_numpy,
    unpack_crumbs,
    unpack_nibbles,
)
from lungmask_tpu_torch.transforms import postprocess, preprocess
from lungmask_tpu_torch.transforms.postprocess_device import (
    postprocess_device,
    postprocess_device_packed2,
)
from lungmask_tpu_torch.utils.device import resolve_device
from lungmask_tpu_torch.utils.profiling import StageTimer, trace

ImageLike = Union[MedicalImage, np.ndarray]


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
            fillmodel / fillmodel_path: optional second model for the fused
                FN-fill/FP-removal mode; it runs on the same device.
            force_cpu: run on the CPU.
            batch_size: slices per forward (default 32).
            volume_postprocessing: connected-component cleanup toggle.
            tqdm_disable: disable progress output (tqdm is optional).
            preprocessing: None (default) resolves to 'sharded' with a mesh,
                else 'hybrid' (device bodymask boxes, float64 host
                resample); 'host' (the reference's per-slice scipy chain;
                bit-equal to 'hybrid'), 'device' (all of it on the device:
                the same boxes, a float32 gather resample) or 'sharded'
                ('device' split over the mesh's data axis; needs ``mesh``).
                An explicit value is honoured with a mesh too.
            precision: 'bfloat16' (default) or 'float32' (cuDNN TF32 off).
            mesh: a ``parallel.Mesh`` (``parallel.make_mesh``): the slices
                split over its data axis (and their height over its space
                axis) for the U-Net, for the default preprocessing and for
                device postprocessing. ``batch_size`` is then per chunk
                over the whole mesh (default 32 per data row).
            postprocessing_mode: 'exact' (the host C++ core, bit-faithful to
                the reference) or 'device' (largest component + hole fill on
                the inferer's device, without the small-region merge; see
                ``transforms/postprocess_device.py``).
            device: 'cuda', 'cuda:N' or 'cpu'; None means CUDA.
        """
        if modelname not in MODEL_URLS:
            raise ValueError(
                f"Modelname not found. Please choose from: {list(MODEL_URLS)}"
            )
        self._plan3d = model_plan(modelpath) if modelpath is not None else {}
        if self._plan3d:
            refused = [name for name, given in (
                ("fillmodel", fillmodel is not None or fillmodel_path is not None),
                ("mesh", mesh is not None), ("preprocessing", preprocessing is not None),
                ("postprocessing_mode='device'", postprocessing_mode == "device")) if given]
            if refused:
                raise ValueError(
                    f"{modelpath} is a 3-D model (nnU-Net's 3d_fullres U-Net), which takes no "
                    f"{', '.join(refused)}: it runs its own preprocessing and sliding window "
                    "on one device")
            if int(self._plan3d.get("logit_order", 1)) != 1:
                raise ValueError(
                    f"{modelpath}: the plan's logit_order is {self._plan3d['logit_order']}, but "
                    "the export resamples a 3-D model's logits at order 1 only")
        if fillmodel is not None and fillmodel not in MODEL_URLS:
            raise ValueError(
                f"Modelname not found. Please choose from: {list(MODEL_URLS)}"
            )
        if preprocessing not in (None, "hybrid", "host", "device", "sharded"):
            raise ValueError(f"unknown preprocessing {preprocessing!r}")
        if preprocessing is None:
            preprocessing = "sharded" if mesh is not None else "hybrid"
        if preprocessing == "sharded" and mesh is None:
            raise ValueError("preprocessing='sharded' requires mesh=")
        if postprocessing_mode not in ("exact", "device"):
            raise ValueError(
                f"postprocessing_mode must be 'exact' or 'device', got {postprocessing_mode!r}"
            )
        if precision not in ("bfloat16", "float32"):
            raise ValueError(f"precision must be 'bfloat16' or 'float32', got {precision!r}")

        tune_host_allocator()
        # Pre-touch the heap once so mask-sized host buffers (paste canvas,
        # unpacked class map, postprocessing scratch) never first-fault
        # inside a timed stage (runtime.prefault_host_heap).
        prefault_host_heap()

        self.mesh = mesh
        self.device = resolve_device(device, force_cpu) if mesh is None else mesh.data_devices[0]
        self._compute_dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
        if modelpath is not None:
            modelname = os.path.basename(modelpath)
        if fillmodel_path is not None:
            fillmodel = os.path.basename(fillmodel_path)
        self.modelname = modelname
        self.fillmodel = fillmodel
        self.batch_size = batch_size
        self.volume_postprocessing = volume_postprocessing
        self.tqdm_disable = tqdm_disable
        self.preprocessing = preprocessing
        self.postprocessing_mode = postprocessing_mode
        self.timings = StageTimer()
        self._sharded_post = {}  # n_classes -> make_sharded_postprocess step
        logger.info(f"lungmask_tpu_torch running on {self.device if mesh is None else mesh}")

        def make_runner(name, path):
            params, n_classes = get_model(name, path)
            if mesh is not None:
                return ShardedUNetRunner(params, n_classes, mesh=mesh, batch_size=batch_size,
                                         compute_dtype=self._compute_dtype)
            return UNetRunner(
                params,
                n_classes,
                batch_size=batch_size,
                compute_dtype=self._compute_dtype,
                device=self.device,
            )

        if self._plan3d:
            from lungmask_tpu_torch.runtime.sliding_window import SlidingWindowRunner

            self.model = SlidingWindowRunner(
                get_model(modelname, modelpath)[0], self._plan3d, self.device,
                self._compute_dtype)
            self.fillmodelm = None
            return
        self.model = make_runner(modelname, modelpath)
        self.fillmodelm = None if fillmodel is None else make_runner(fillmodel, fillmodel_path)

    # ------------------------------------------------------------------

    def _preprocess(self, volume: np.ndarray):
        """→ (normalized device slices (N, 256, 256), or their slabs with
        ``"sharded"``; boxes (N, 4))."""
        if self.preprocessing == "sharded":
            return preprocess.preprocess_sharded(
                volume, self.mesh, resolution=(256, 256), compute_dtype=self._compute_dtype
            )
        fn = {
            "host": preprocess.preprocess_host,
            "hybrid": preprocess.preprocess_hybrid,
            "device": preprocess.preprocess,
        }[self.preprocessing]
        return fn(
            volume,
            resolution=(256, 256),
            compute_dtype=self._compute_dtype,
            device=self.device,
        )

    def _to_lps(self, image: ImageLike):
        """Input normalization (reference mask.py:153-164): numpy passthrough,
        geometry-carrying images reoriented to LPS (stage ``to_lps``)."""
        with self.timings.stage("to_lps"):
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
        """Reorient a result back to the input orientation (mask.py:204-208;
        stage ``from_lps``)."""
        with self.timings.stage("from_lps"):
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
                pred = self._forward_model(self.model, normalized)
            bar.update(1)
            return self._finish_volume(
                pred, boxes, inimg_raw.shape[1:], self.model.n_classes, bar=bar
            )

    @property
    def _device_post(self) -> bool:
        return self.volume_postprocessing and self.postprocessing_mode == "device"

    def _forward_model(self, model: UNetRunner, normalized):
        """The U-Net forward. With device postprocessing the class map stays
        on the device for it; otherwise it is downloaded bit-packed."""
        if self._device_post:
            return self._synced(model.run(normalized))
        return model.run_numpy(normalized)

    def _synced(self, out):
        """Wait for the device work queued so far (on every device of the
        mesh): a stage that leaves its result on the device must still end
        when its work does, or its seconds land in the next stage."""
        devices = [self.device] if self.mesh is None else set(self.mesh.devices.ravel())
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return out

    def _device_postprocess(self, pred, n_classes: int) -> np.ndarray:
        """Device-mode cleanup on the inferer's device (a host map is
        uploaded first); the result comes down crumb-packed where it can
        (≤ 4 classes, W % 4 == 0), a quarter of the dense bytes. With a mesh
        the map stays in blocks over the mesh
        (``parallel.make_sharded_postprocess``); a map that arrives whole is
        split into blocks there. Each block comes down on its own; the
        bands of a slab are joined on the host."""
        if self.mesh is None:
            pred = torch.as_tensor(pred).to(self.device)
            if n_classes <= 4 and pred.shape[2] % 4 == 0:
                return unpack_crumbs(postprocess_device_packed2(pred, n_classes).cpu().numpy())
            return postprocess_device(pred, n_classes).cpu().numpy()
        step = self._sharded_post.get(n_classes)
        if step is None:
            step = self._sharded_post[n_classes] = make_sharded_postprocess(self.mesh, n_classes)
        if not isinstance(pred, (list, tuple)):
            pred = torch.as_tensor(pred)
        blocks = step(pred)
        if self.mesh.shape["space"] == 1:
            blocks = [[s] for s in blocks]
        crumbs = n_classes <= 4 and blocks[0][0].shape[-1] % 4 == 0
        out = np.concatenate([
            np.concatenate([pack_bits(b, 2).cpu().numpy() if crumbs else b.cpu().numpy()
                            for b in row], axis=1)
            for row in blocks])
        return unpack_crumbs(out) if crumbs else out

    def _finish_volume(self, pred_np, boxes, slice_shape, n_classes, bar=None) -> np.ndarray:
        """Finishing stages: postprocess (per mode) + host paste-back."""
        if self._device_post:
            with self.timings.stage("postprocess"):
                outmask = self._device_postprocess(pred_np, n_classes)
        elif self.volume_postprocessing:
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
        """Phase 1 of :meth:`apply`: orientation normalization +
        preprocessing (the normalized stack ends on the device)."""
        inimg_raw, curr_orient, lps_image = self._to_lps(image)
        if self._plan3d:
            from lungmask_tpu_torch.transforms import nnunet3d

            spacing = None if lps_image is None else tuple(reversed(lps_image.spacing))
            with self.timings.stage("preprocess"):
                pre = self._synced(nnunet3d.preprocess(inimg_raw, spacing, self._plan3d,
                                                       self.device))
            return dict(pre, inimg_raw=inimg_raw, curr_orient=curr_orient, lps_image=lps_image)
        with self.timings.stage("preprocess"):
            normalized, boxes = self._preprocess(inimg_raw)
        return {
            "inimg_raw": inimg_raw,
            "curr_orient": curr_orient,
            "lps_image": lps_image,
            "normalized": normalized,
            "boxes": boxes,
        }

    def forward_preprocessed(self, pre: dict):
        """Phase 2a: the U-Net forward; returns the class map, or the pair of
        maps (base, fill) in the fused mode — on the host, or on the device
        with device postprocessing."""
        with self.timings.stage("unet"):
            if self._plan3d:  # the (K, d, h, w) float32 logits, left on the device
                return self._synced(self.model.logits(pre["normalized"]))
            if self.fillmodelm is None:
                return self._forward_model(self.model, pre["normalized"])
            if self.mesh is not None:  # the two sharded runners one after the other
                run = "run" if self._device_post else "run_numpy"
                pair = tuple(getattr(m, run)(pre["normalized"]) for m in (self.model, self.fillmodelm))
                return self._synced(pair)
            if self._device_post:
                return self._synced(run_pair(self.model, self.fillmodelm, pre["normalized"]))
            return run_pair_numpy(self.model, self.fillmodelm, pre["normalized"])

    def finish_forward(self, pre: dict, pred) -> np.ndarray:
        """Phase 2b: postprocess + paste-back + reorientation; in the fused
        mode each model's mask is finished so, then the two are fused."""
        if self._plan3d:
            return self._finish_3d(pre, pred)
        shape = pre["inimg_raw"].shape[1:]

        def finish_one(pred_np, runner):
            outmask = self._finish_volume(pred_np, pre["boxes"], shape, runner.n_classes)
            return self._from_lps(outmask, pre["curr_orient"], pre["lps_image"])

        if self.fillmodelm is None:
            return finish_one(pred, self.model)
        jobs = list(zip(pred, (self.model, self.fillmodelm)))
        if self._fused_finish_threads():
            # The native core runs GIL-free with thread-local scratch, so the
            # two independent passes overlap; the result is the same either way.
            with ThreadPoolExecutor(max_workers=2) as ex:
                res_l, res_r = ex.map(lambda job: finish_one(*job), jobs)
        else:
            res_l, res_r = (finish_one(*job) for job in jobs)
        with self.timings.stage("fusion_postprocess"):
            # Reference mask.py:228-232; the fusion's postprocessing runs
            # whatever volume_postprocessing is, as in the reference.
            fused = native.fused_finish(res_l, res_r)
            if fused is not None:
                return fused
            spare_value = res_l.max() + 1
            res_l[np.logical_and(res_l == 0, res_r > 0)] = spare_value
            res_l[res_r == 0] = 0
            return postprocess.postprocessing(
                res_l, spare=[spare_value], disable_tqdm=self.tqdm_disable
            )

    def _finish_3d(self, pre: dict, logits) -> np.ndarray:
        """A 3-D model's finish: the logits exported to the input grid,
        argmax and pasted into the uncropped volume on the device, 4 bits a
        voxel where they fit (stage ``export``, its download and unpack
        included); the host postprocessing; the reorientation back."""
        from lungmask_tpu_torch.ops.kernels import export3d

        with self.timings.stage("export"):
            packed = export3d.export_packed(logits, pre["box"], pre["full_shape"]).cpu().numpy()
            if export3d.packing(self.model.n_classes, pre["full_shape"][2]) == 2:
                mask = unpack_nibbles(packed)
            else:
                mask = packed
        if self.volume_postprocessing:
            with self.timings.stage("postprocess"):
                mask = postprocess.postprocessing(mask, disable_tqdm=self.tqdm_disable)
        return self._from_lps(mask, pre["curr_orient"], pre["lps_image"])

    def apply_preprocessed(self, pre: dict) -> np.ndarray:
        """Phase 2 of :meth:`apply` on a :meth:`preprocess_image` result."""
        return self.finish_forward(pre, self.forward_preprocessed(pre))

    @trace("inference")
    def apply(self, image: ImageLike) -> np.ndarray:
        """Apply the model (or the fused model pair) to a volumetric image;
        returns the uint8 label volume in the input's own geometry and axis
        order. The fused pair shares one preprocessing pass."""
        if self.fillmodelm is not None or self._plan3d:
            return self.apply_preprocessed(self.preprocess_image(image))
        inimg_raw, curr_orient, lps_image = self._to_lps(image)
        outmask = self._infer_volume(inimg_raw)
        return self._from_lps(outmask, curr_orient, lps_image)

    def _fused_finish_threads(self) -> bool:
        """Whether the fused mode's two per-model finishes run on two
        threads: when the host has more than one core and the postprocessing
        runs on the host (two device cleanups would only queue on the one
        device), unless ``LUNGMASK_TPU_FUSED_THREADS`` is set (``0`` =
        sequential)."""
        flag = os.environ.get("LUNGMASK_TPU_FUSED_THREADS")
        if flag is not None:
            return flag != "0"
        return (os.cpu_count() or 1) > 1 and not self._device_post


def apply(
    image: ImageLike,
    model: Optional[UNetRunner] = None,
    force_cpu: bool = False,
    batch_size: int = 20,
    volume_postprocessing: bool = True,
    tqdm_disable: bool = False,
) -> np.ndarray:
    """Deprecated functional API (reference mask.py:235-255)."""
    warnings.warn(
        "The function `apply` will be removed in a future version. Please use the LMInferer class!",
        DeprecationWarning,
    )
    inferer = LMInferer(
        force_cpu=force_cpu,
        batch_size=batch_size,
        volume_postprocessing=volume_postprocessing,
        tqdm_disable=tqdm_disable,
    )
    if model is not None:
        inferer.model = model
    return inferer.apply(image)


def apply_fused(
    image: ImageLike,
    basemodel: str = "LTRCLobes",
    fillmodel: str = "R231",
    force_cpu: bool = False,
    batch_size: int = 20,
    volume_postprocessing: bool = True,
    tqdm_disable: bool = False,
) -> np.ndarray:
    """Deprecated functional API (reference mask.py:258-279)."""
    warnings.warn(
        "The function `apply_fused` will be removed in a future version. Please use the LMInferer class!",
        DeprecationWarning,
    )
    inferer = LMInferer(
        modelname=basemodel,
        force_cpu=force_cpu,
        fillmodel=fillmodel,
        batch_size=batch_size,
        volume_postprocessing=volume_postprocessing,
        tqdm_disable=tqdm_disable,
    )
    return inferer.apply(image)
