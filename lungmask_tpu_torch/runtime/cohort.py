"""Cohort streaming: overlapped decode → device inference → postprocess/write
(a copy of ``lungmask_tpu.runtime.cohort`` on the port's loader and
split-phase API).

The reference processes volumes strictly one after another (its CLI handles
one volume per invocation). This runtime pipelines a cohort through three
overlapping stages:

  [loader thread]   file/DICOM decode + preprocessing/upload  (host I/O + device)
  [main thread]     U-Net forward                             (device)
  [finisher thread] postprocessing + paste + output write     (host, or device
                                                               in device mode)

so host decode of volume i+1 and host postprocessing of volume i-1 overlap
device compute of volume i. The stages are the inferer's split-phase API:
``preprocess_image`` in the loader, ``forward_preprocessed`` in the main
thread, ``finish_forward`` in the finisher. Queues are bounded
(``prefetch``) so memory stays flat regardless of cohort size.

Every thread launches on the default CUDA stream, so the loader thread's
bodymask kernel (K1), the main thread's U-Net and the finisher's device-mode
cleanup queue on the card one after another in launch order; the overlap
is between host work and device work. Side streams would need
``record_stream`` and event waits at every hand-off.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from lungmask_tpu_torch.io import loader
from lungmask_tpu_torch.io.image import MedicalImage
from lungmask_tpu_torch.logger import logger

VolumeSource = Union[str, np.ndarray, MedicalImage]


@dataclass
class CohortResult:
    name: str
    mask: Optional[np.ndarray]
    seconds: float
    error: Optional[str] = None


@dataclass
class CohortStats:
    results: List[CohortResult] = field(default_factory=list)
    wall_seconds: float = 0.0
    # Pipeline diagnosis (seconds summed over the run): `*_busy` is time a
    # stage spent working, `*_wait` time it spent blocked on its queue. A
    # healthy pipeline has the bottleneck stage ~100% busy and the others
    # waiting; every stage busy-dominated on a 1-core host means the stages
    # are fighting for the core, not overlapping.
    stage_seconds: dict = field(default_factory=dict)

    @property
    def volumes_per_hour(self) -> float:
        done = sum(1 for r in self.results if r.error is None)
        return 3600.0 * done / self.wall_seconds if self.wall_seconds else 0.0


def _load(source: VolumeSource) -> MedicalImage:
    if isinstance(source, MedicalImage):
        return source
    if isinstance(source, np.ndarray):
        return MedicalImage(source)
    return loader.load_input_image(source)


def run_cohort(
    sources: Sequence[VolumeSource],
    inferer,
    output_dir: Optional[str] = None,
    prefetch: int = 2,
    on_result: Optional[Callable[[CohortResult], None]] = None,
    keep_masks: bool = False,
) -> CohortStats:
    """Stream a cohort of volumes through the inferer.

    Args:
        sources: paths (image files or DICOM series directories), arrays,
            or MedicalImages. A directory without DICOM fails its volume
            ("No dicoms found!") and the cohort goes on.
        inferer: an ``LMInferer``.
        output_dir: when set, masks are written as ``<name>_mask.nii.gz``.
            Names derive from the source basename, de-duplicated with an
            index suffix when two sources share one (common with per-patient
            directories all named e.g. ``DICOM``).
        prefetch: bounded decode look-ahead.
        on_result: per-volume callback; an exception it raises is recorded on
            that volume's result and does not stop the cohort.
        keep_masks: retain masks in the returned stats (memory!).
    """
    t_start = time.perf_counter()
    stats = CohortStats()
    in_q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    out_q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))

    used_names = set()

    def name_of(i, src):
        if isinstance(src, str):
            base = os.path.basename(os.path.normpath(src))
            name = os.path.splitext(os.path.splitext(base)[0])[0]
        else:
            name = f"volume{i:04d}"
        if name in used_names:
            name = f"{name}_{i:04d}"
        used_names.add(name)
        return name

    waits = {
        "load_busy": 0.0,
        "load_wait": 0.0,
        "forward_busy": 0.0,
        "forward_wait": 0.0,
        # Time the main thread spent blocked handing results to the finisher
        # (out_q full) — kept separate from forward_wait (in_q starvation) so
        # the bench's bottleneck diagnosis points at the right neighbor.
        "forward_backpressure": 0.0,
        "finish_busy": 0.0,
        "finish_wait": 0.0,
    }
    stats.stage_seconds = waits

    def _timed_put(q, item, key):
        t0 = time.perf_counter()
        q.put(item)
        waits[key] += time.perf_counter() - t0

    def loader_thread():
        it = enumerate(sources)
        try:
            while True:
                try:
                    i, src = next(it)
                except StopIteration:
                    break
                except Exception as e:  # the iterable itself failed
                    _timed_put(in_q, (f"cohort-source-{len(used_names)}", None,
                                      None, f"source iteration failed: {e}"),
                               "load_wait")
                    break
                t0 = time.perf_counter()
                try:
                    img = _load(src)
                    pre = inferer.preprocess_image(img)
                    waits["load_busy"] += time.perf_counter() - t0
                    _timed_put(in_q, (name_of(i, src), img, pre, None),
                               "load_wait")
                # SystemExit included: load_input_image sys.exit()s on a
                # directory without DICOM (reference semantics); here that
                # skips the volume.
                except (Exception, SystemExit) as e:
                    # Time burned before the failure is still loader work —
                    # without it, a cohort of failing volumes reports an
                    # all-idle loader and the diagnosis blames the wrong stage.
                    waits["load_busy"] += time.perf_counter() - t0
                    _timed_put(in_q, (name_of(i, src), None, None, str(e)),
                               "load_wait")
        finally:
            in_q.put(None)

    def finisher_thread():
        while True:
            t0 = time.perf_counter()
            item = out_q.get()
            waits["finish_wait"] += time.perf_counter() - t0
            if item is None:
                break
            name, img, pre, payload, t0, err = item
            mask = None
            if err is None:
                tb = time.perf_counter()
                try:
                    mask = inferer.finish_forward(pre, payload)
                    if output_dir is not None:
                        out = img.with_array(mask)
                        loader.write_image(
                            out, os.path.join(output_dir, f"{name}_mask.nii.gz")
                        )
                except Exception as e:
                    logger.error(f"cohort: finishing failed for {name}: {e}")
                    err, mask = str(e), None
                finally:
                    waits["finish_busy"] += time.perf_counter() - tb
            res = CohortResult(
                name=name,
                mask=mask if keep_masks else None,
                seconds=time.perf_counter() - t0,
                error=err,
            )
            if on_result is not None:
                try:
                    on_result(res)
                except Exception as e:
                    logger.error(f"cohort: on_result callback failed for {name}: {e}")
                    res.error = res.error or f"on_result failed: {e}"
            stats.results.append(res)

    lt = threading.Thread(target=loader_thread, daemon=True)
    ft = threading.Thread(target=finisher_thread, daemon=True)
    lt.start()
    ft.start()

    while True:
        tw = time.perf_counter()
        item = in_q.get()
        waits["forward_wait"] += time.perf_counter() - tw
        if item is None:
            break
        name, img, pre, err = item
        t0 = time.perf_counter()
        if err is not None:
            logger.warning(f"cohort: skipping {name}: {err}")
            _timed_put(out_q, (name, None, None, None, t0, err),
                       "forward_backpressure")
            continue
        try:
            payload = inferer.forward_preprocessed(pre)
            waits["forward_busy"] += time.perf_counter() - t0
            _timed_put(out_q, (name, img, pre, payload, t0, None),
                       "forward_backpressure")
        except Exception as e:
            logger.error(f"cohort: inference failed for {name}: {e}")
            waits["forward_busy"] += time.perf_counter() - t0
            _timed_put(out_q, (name, img, None, None, t0, str(e)),
                       "forward_backpressure")

    out_q.put(None)
    lt.join()
    ft.join()
    stats.wall_seconds = time.perf_counter() - t_start
    stats.stage_seconds = {k: round(v, 3) for k, v in waits.items()}
    return stats
