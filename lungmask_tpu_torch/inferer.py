"""LMInferer: the public inference orchestrator (counterpart of
``lungmask_tpu.inferer``), with the deprecated ``apply`` / ``apply_fused``.

Same constructor and ``apply()`` contract as the JAX package: a
geometry-carrying :class:`MedicalImage` is processed in LPS orientation and
returned in its own; a numpy ``(z, y, x)`` volume passes through.

``LMInferer`` is a thin front: its constructor picks one pipeline for the
model, and ``apply`` is that pipeline's three phases for every model —
:meth:`~LMInferer.preprocess_image` (to LPS, then the pipeline's
preprocessing), :meth:`~LMInferer.forward_preprocessed` (stage ``unet``) and
:meth:`~LMInferer.finish_forward` (the pipeline's finish and the
reorientation back).

The slice pipeline (:class:`_SlicePipeline`) runs the 2-D models: hybrid
preprocessing (``transforms/preprocess.py``, the bodymask kernel K1 on the
device; slices under 128² and ``preprocessing="host"`` take the strict host
pipeline; ``preprocessing="device"`` runs all of it on the device), the
U-Net (``runtime/engine.py``; its pooling and upsampling are the kernels K2
and K3), exact host postprocessing (``transforms/postprocess.py`` → the
native core) and the native paste-back. With ``postprocessing_mode="device"``
the class map stays on the device and is cleaned there
(``transforms/postprocess_device.py``); only the crumb-packed result comes
down (``ops/packing.py``). With a device mesh (``mesh=``,
``parallel/mesh.py``) the slices split over its data axis and, with
``space > 1``, each slab's height into bands over its row's space devices:
preprocessing defaults to ``"sharded"``, the U-Net runs as
``parallel.ShardedUNetRunner`` and device postprocessing as
``parallel.make_sharded_postprocess``, the class map staying in blocks until
the cleaned mask comes down. The fused two-model mode (``fillmodel=``, the
CLI's ``LTRCLobes_R231``) preprocesses once, runs both U-Nets chunk by chunk
over the one stack, finishes each model's mask on its own (postprocess +
paste + reorient, on two threads where the host has more than one core and
the postprocessing runs on the host), and fuses the two with the reference's
FN-fill / FP-removal rule (``native.fused_finish``; reference
mask.py:223-232).

The volume pipeline (``runtime/sliding_window.py:VolumePipeline``) runs a
3-D model (an ``.npz`` whose meta names nnU-Net's ``3d_fullres`` U-Net):
nnU-Net's preprocessing on the device, its sliding window, and the export
of the logits to the input grid in one kernel (stage ``export``) before the
host postprocessing. The 3-D modules and Triton are imported only when such
a model is loaded. A 3-D model takes no ``fillmodel``, ``mesh``,
``preprocessing`` or device postprocessing, and runs the plan's patches per
forward whatever ``batch_size`` says.

Device rule: the device is resolved once. ``force_cpu=True`` or
``device="cpu"`` mean the CPU; otherwise a CUDA device is required and its
absence raises — the inferer never quietly continues on the CPU. With a
mesh, the mesh's devices are the inferer's (``device`` is its first data
device).
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

import numpy as np
import torch

from lungmask_tpu_torch.io.image import MedicalImage, copy_voxels, reorient
from lungmask_tpu_torch.logger import logger
from lungmask_tpu_torch.models.registry import MODEL_URLS, get_model, model_plan
from lungmask_tpu_torch.ops import native, resample
from lungmask_tpu_torch.ops.packing import pack_bits, pack_bits_for, unpack_bits_np, unpack_crumbs
from lungmask_tpu_torch.parallel.sharded import ShardedUNetRunner, make_sharded_postprocess
from lungmask_tpu_torch.runtime import prefault_host_heap, tune_host_allocator
from lungmask_tpu_torch.runtime.engine import UNetRunner, run_pair, run_pair_numpy
from lungmask_tpu_torch.transforms import postprocess, preprocess
from lungmask_tpu_torch.transforms.postprocess_device import (
    postprocess_device,
    postprocess_device_packed2,
)
from lungmask_tpu_torch.utils.device import resolve_device
from lungmask_tpu_torch.utils.profiling import StageTimer, trace

ImageLike = Union[MedicalImage, np.ndarray]


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
        plan3d = model_plan(modelpath) if modelpath is not None else {}
        if plan3d:
            refused = [name for name, given in (
                ("fillmodel", fillmodel is not None or fillmodel_path is not None),
                ("mesh", mesh is not None), ("preprocessing", preprocessing is not None),
                ("postprocessing_mode='device'", postprocessing_mode == "device")) if given]
            if refused:
                raise ValueError(
                    f"{modelpath} is a 3-D model (nnU-Net's 3d_fullres U-Net), which takes no "
                    f"{', '.join(refused)}: it runs its own preprocessing and sliding window "
                    "on one device")
            if int(plan3d.get("logit_order", 1)) != 1:
                raise ValueError(
                    f"{modelpath}: the plan's logit_order is {plan3d['logit_order']}, but "
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

        # The one choice of the model family: every phase asks the pipeline.
        if plan3d:
            from lungmask_tpu_torch.runtime.sliding_window import (
                SlidingWindowRunner,
                VolumePipeline,
            )

            self.model = SlidingWindowRunner(
                get_model(modelname, modelpath)[0], plan3d, self.device, self._compute_dtype)
            self.fillmodelm = None
            self._pipeline = VolumePipeline(self, plan3d)
        else:
            self.model = make_runner(modelname, modelpath)
            self.fillmodelm = None if fillmodel is None else make_runner(fillmodel, fillmodel_path)
            self._pipeline = _SlicePipeline(self)

    # ------------------------------------------------------------------

    def _to_lps(self, image: ImageLike):
        """Input normalization (reference mask.py:153-164): numpy passthrough,
        geometry-carrying images reoriented to LPS (stage ``to_lps``). The
        copy, the reorientation and the :meth:`_hu_dtype` promotion are one
        pass; an LPS image of an HU-capable dtype is used as it is."""
        with self.timings.stage("to_lps"):
            if isinstance(image, np.ndarray):
                return copy_voxels(image, self._hu_dtype(image.dtype)), None, None
            curr_orient = image.orientation()
            hu = self._hu_dtype(image.array.dtype)
            if curr_orient != "LPS":
                image = reorient(image, "LPS", dtype=hu)
            elif hu != image.array.dtype:
                return copy_voxels(image.array, hu), curr_orient, image
            return image.array, curr_orient, image

    @staticmethod
    def _hu_dtype(dtype) -> np.dtype:
        """Voxels must be able to hold the HU window bounds: unsigned and
        narrow inputs are promoted to the smallest signed type that covers
        their range and the window; int16/int32/float keep their dtype."""
        dtype = np.dtype(dtype)
        kind, size = dtype.kind, dtype.itemsize
        if kind == "u":
            return np.dtype({1: np.int16, 2: np.int32}.get(size, np.int64))
        if kind in "ib" and size < 2:
            return np.dtype(np.int16)
        return dtype

    def _from_lps(self, outmask, curr_orient, lps_image) -> np.ndarray:
        """Reorient a result back to the input orientation (mask.py:204-208;
        stage ``from_lps``) as uint8, cast in the reorientation's one pass;
        a uint8 mask already in the input's orientation is returned as is."""
        with self.timings.stage("from_lps"):
            if curr_orient is None or curr_orient == "LPS":
                return outmask if outmask.dtype == np.uint8 else copy_voxels(outmask, np.uint8)
            out_img = MedicalImage(
                outmask,
                spacing=lps_image.spacing,
                origin=lps_image.origin,
                direction=lps_image.direction,
            )
            return reorient(out_img, curr_orient, dtype=np.uint8).array

    def _synced(self, out):
        """Wait for the device work queued so far (on every device of the
        mesh): a stage that leaves its result on the device must still end
        when its work does, or its seconds land in the next stage."""
        devices = [self.device] if self.mesh is None else set(self.mesh.devices.ravel())
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return out

    # -- the three phases ---------------------------------------------------

    def preprocess_image(self, image: ImageLike) -> dict:
        """Phase 1 of :meth:`apply`: orientation normalization + the
        pipeline's preprocessing (stage ``preprocess``; the normalized
        stack or volume ends on the device)."""
        inimg_raw, curr_orient, lps_image = self._to_lps(image)
        with self.timings.stage("preprocess"):
            pre = self._pipeline.preprocess(inimg_raw, lps_image)
        return dict(pre, inimg_raw=inimg_raw, curr_orient=curr_orient, lps_image=lps_image)

    def forward_preprocessed(self, pre: dict):
        """Phase 2a: the network forward (stage ``unet``): the class map,
        or the pair of maps (base, fill) in the fused mode, on the host or
        on the device with device postprocessing; a 3-D model's logits on
        the device."""
        with self.timings.stage("unet"):
            return self._pipeline.forward(pre)

    def finish_forward(self, pre: dict, pred) -> np.ndarray:
        """Phase 2b: the pipeline's finish (postprocessing and paste-back,
        or a 3-D model's export) and the reorientation back; in the fused
        mode each model's mask is finished so, then the two are fused."""
        return self._pipeline.finish(pre, pred)

    def apply_preprocessed(self, pre: dict) -> np.ndarray:
        """Phase 2 of :meth:`apply` on a :meth:`preprocess_image` result."""
        return self.finish_forward(pre, self.forward_preprocessed(pre))

    @trace("inference")
    def apply(self, image: ImageLike) -> np.ndarray:
        """Apply the model (or the fused model pair) to a volumetric image;
        returns the uint8 label volume in the input's own geometry and axis
        order. The fused pair shares one preprocessing pass."""
        return self.apply_preprocessed(self.preprocess_image(image))


class _SlicePipeline:
    """The 2-D models' phases behind :class:`LMInferer`: slices through one
    U-Net or the fused pair, on one device or a mesh. It reads the front's
    settings and runners when it runs, so a runner assigned to
    ``LMInferer.model`` is the one that runs."""

    def __init__(self, front: LMInferer):
        self.front = front
        self._sharded_post = {}  # n_classes -> make_sharded_postprocess step

    def preprocess(self, volume: np.ndarray, lps_image) -> dict:
        """→ normalized device slices (N, 256, 256), or their slabs with
        ``"sharded"``, and their boxes (N, 4)."""
        f = self.front
        if f.preprocessing == "sharded":
            normalized, boxes = preprocess.preprocess_sharded(
                volume, f.mesh, resolution=(256, 256), compute_dtype=f._compute_dtype)
        else:
            fn = {"host": preprocess.preprocess_host, "hybrid": preprocess.preprocess_hybrid,
                  "device": preprocess.preprocess}[f.preprocessing]
            normalized, boxes = fn(volume, resolution=(256, 256), compute_dtype=f._compute_dtype,
                                   device=f.device)
        return {"normalized": normalized, "boxes": boxes}

    @property
    def _device_post(self) -> bool:
        return self.front.volume_postprocessing and self.front.postprocessing_mode == "device"

    def forward(self, pre: dict):
        """The U-Net forward. With device postprocessing the class map stays
        on the device for it; otherwise it is downloaded bit-packed."""
        f, normalized = self.front, pre["normalized"]
        if f.fillmodelm is None:
            if self._device_post:
                return f._synced(f.model.run(normalized))
            return f.model.run_numpy(normalized)
        if f.mesh is not None:  # the two sharded runners one after the other
            run = "run" if self._device_post else "run_numpy"
            return f._synced(tuple(getattr(m, run)(normalized) for m in (f.model, f.fillmodelm)))
        if self._device_post:
            return f._synced(run_pair(f.model, f.fillmodelm, normalized))
        return run_pair_numpy(f.model, f.fillmodelm, normalized)

    def _device_postprocess(self, pred, n_classes: int) -> np.ndarray:
        """Device-mode cleanup on the inferer's device (a host map is
        uploaded first); the result comes down crumb-packed where
        :func:`pack_bits_for` gives 2 bits, a quarter of the dense bytes.
        With a mesh the map stays in blocks over the mesh
        (``parallel.make_sharded_postprocess``); a map that arrives whole is
        split into blocks there. Each block comes down on its own; the
        bands of a slab are joined on the host."""
        mesh = self.front.mesh
        if mesh is None:
            pred = torch.as_tensor(pred).to(self.front.device)
            if pack_bits_for(n_classes, pred.shape[2]) == 2:
                return unpack_crumbs(postprocess_device_packed2(pred, n_classes).cpu().numpy())
            return postprocess_device(pred, n_classes).cpu().numpy()
        step = self._sharded_post.get(n_classes)
        if step is None:
            step = self._sharded_post[n_classes] = make_sharded_postprocess(mesh, n_classes)
        if not isinstance(pred, (list, tuple)):
            pred = torch.as_tensor(pred)
        blocks = step(pred)
        if mesh.shape["space"] == 1:
            blocks = [[s] for s in blocks]
        bits = 2 if pack_bits_for(n_classes, blocks[0][0].shape[-1]) == 2 else 8
        out = np.concatenate([
            np.concatenate([pack_bits(b, bits).cpu().numpy() for b in row], axis=1)
            for row in blocks])
        return unpack_bits_np(out, bits)

    def _finish_volume(self, pred_np, boxes, slice_shape, n_classes) -> np.ndarray:
        """Finishing stages: postprocess (per mode) + host paste-back."""
        f = self.front
        if self._device_post:
            with f.timings.stage("postprocess"):
                outmask = self._device_postprocess(pred_np, n_classes)
        elif f.volume_postprocessing:
            with f.timings.stage("postprocess"):
                outmask = postprocess.postprocessing(pred_np, disable_tqdm=f.tqdm_disable)
        else:
            outmask = pred_np
        with f.timings.stage("paste_back"):
            return resample.paste_masks_host(outmask, boxes, slice_shape).astype(np.uint8)

    def finish(self, pre: dict, pred) -> np.ndarray:
        """Postprocess + paste-back + reorientation; in the fused mode each
        model's mask is finished so, then the two are fused. The pasted mask
        is reoriented after :meth:`_finish_volume` returns, so that the
        postprocessed map is freed first: held longer, it makes the host heap
        fault in fresh pages more often."""
        f = self.front
        shape = pre["inimg_raw"].shape[1:]

        def finish_one(pred_np, runner):
            outmask = self._finish_volume(pred_np, pre["boxes"], shape, runner.n_classes)
            return f._from_lps(outmask, pre["curr_orient"], pre["lps_image"])

        if f.fillmodelm is None:
            return finish_one(pred, f.model)
        jobs = list(zip(pred, (f.model, f.fillmodelm)))
        if self._fused_finish_threads():
            # The native core runs GIL-free with thread-local scratch, so the
            # two independent passes overlap; the result is the same either way.
            with ThreadPoolExecutor(max_workers=2) as ex:
                res_l, res_r = ex.map(lambda job: finish_one(*job), jobs)
        else:
            res_l, res_r = (finish_one(*job) for job in jobs)
        with f.timings.stage("fusion_postprocess"):
            # Reference mask.py:228-232; the fusion's postprocessing runs
            # whatever volume_postprocessing is, as in the reference.
            fused = native.fused_finish(res_l, res_r)
            if fused is not None:
                return fused
            spare_value = res_l.max() + 1
            res_l[np.logical_and(res_l == 0, res_r > 0)] = spare_value
            res_l[res_r == 0] = 0
            return postprocess.postprocessing(
                res_l, spare=[spare_value], disable_tqdm=f.tqdm_disable
            )

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
