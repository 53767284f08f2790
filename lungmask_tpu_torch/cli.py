"""Command-line interface: ``lungmask-torch INPUT OUTPUT`` (counterpart of
``lungmask_tpu.cli``, also ``python -m lungmask_tpu_torch``).

The reference's flags (lungmask/__main__.py:20-144): positional input and
output, ``--modelname`` (``LTRCLobes_R231`` is the fused two-model mode,
both models from the registry), ``--modelpath``, ``--cpu`` (forces batch
size 1), ``--nopostprocess``, ``--batchsize``, ``--noprogress``,
``--version``, ``--removemetadata``. INPUT is an image file (NIfTI,
MetaImage, NRRD, Analyze, VTK, GIPL, raster or one DICOM file) or a
directory scanned for DICOM series (the largest wins); OUTPUT takes the same
formats, and one ending in ``.dcm`` is written as a DICOM series
(``stem_0000.dcm`` ...) carrying the input's keep-listed tags and the
reference's marker tags. The JAX package's extensions: ``--noHU`` (8-bit
image stacks mapped to pseudo-HU), ``--postprocessing {exact,device}``,
``--cohort`` (a directory of volumes through the overlapped cohort
pipeline), ``--serve [HOST:]PORT`` (the HTTP lane) and ``--warmup
[N_SLICES]``.
"""

from __future__ import annotations

import argparse
import os
import sys

from lungmask_tpu_torch import __version__
from lungmask_tpu_torch.inferer import LMInferer
from lungmask_tpu_torch.io import loader, nifti
from lungmask_tpu_torch.logger import logger


def path(string: str) -> str:
    """argparse type for the input positional: exits when the path is absent."""
    if not os.path.exists(string):
        sys.exit(f"File not found: {string}")
    return string


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="lungmask-torch", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument(
        "input", metavar="input", type=path, nargs="?", default=None,
        help="CT volume to segment: a single image file, or a directory that will be "
        "scanned recursively for a DICOM series; with --cohort a directory of volumes",
    )
    parser.add_argument(
        "output", metavar="output", type=str, nargs="?", default=None,
        help="where to write the resulting label volume (its extension picks the format; "
        ".dcm writes a DICOM series); with --cohort a directory",
    )
    parser.add_argument(
        "--warmup",
        nargs="?",
        type=int,
        const=192,
        default=None,
        metavar="N_SLICES",
        help="build the CUDA kernels and the host core, then run the configured "
        "model(s) twice over an N_SLICES-slice 512² phantom and log the cold and "
        "warm seconds. No input/output needed; honors --modelname/--modelpath/"
        "--batchsize/--cpu/--postprocessing.",
    )
    parser.add_argument(
        "--modelname",
        help="which pretrained segmentation model to run",
        type=str,
        choices=["R231", "LTRCLobes", "LTRCLobes_R231", "R231CovidWeb"],
        default="R231",
    )
    parser.add_argument(
        "--modelpath",
        help="load weights from this local .pth/.npz file instead of the "
        "named model's cached weights",
        default=None,
    )
    parser.add_argument(
        "--cpu",
        help="run on the CPU instead of the CUDA device; also drops the "
        "batch size to 1",
        action="store_true",
    )
    parser.add_argument(
        "--nopostprocess",
        help="skip the volume-level cleanup pass (connected-component "
        "filtering and hole filling)",
        action="store_true",
    )
    parser.add_argument(
        "--batchsize",
        type=int,
        help="slices per forward-pass batch (default: 32)",
        default=None,
    )
    parser.add_argument("--noprogress", action="store_true", help="suppress progress bars")
    parser.add_argument(
        "--version",
        help="print the installed version and exit",
        action="version",
        version=__version__,
    )
    parser.add_argument(
        "--removemetadata",
        action="store_true",
        help="strip patient/study tags from the output instead of carrying "
        "them over; only meaningful for metadata-capable formats like DICOM",
    )
    parser.add_argument(
        "--noHU",
        action="store_true",
        help="For processing of 8-bit image stacks (e.g. jpg/png slices) that are not in "
        "Hounsfield units: intensities are mapped to the model's HU window. Implies "
        "--removemetadata.",
    )
    parser.add_argument(
        "--postprocessing",
        choices=["exact", "device"],
        default="exact",
        help="volume cleanup: 'exact' replicates the reference's label semantics "
        "bit for bit on the host C++ core; 'device' keeps the cleanup on the GPU "
        "(largest component + hole fill, no small-region merge; see "
        "transforms/postprocess_device.py)",
    )
    parser.add_argument(
        "--cohort",
        action="store_true",
        help="batch mode: INPUT is a directory whose entries are volumes (image files, "
        "or subdirectories holding one DICOM series each); masks are streamed to "
        "OUTPUT/<name>_mask.nii.gz through the overlapped decode/compute/"
        "postprocess pipeline (lungmask_tpu_torch.runtime.cohort)",
    )
    parser.add_argument(
        "--serve",
        metavar="[HOST:]PORT",
        default=None,
        help="start an HTTP segmentation endpoint instead of processing one volume "
        "(POST /v1/segment, GET /healthz|/v1/models|/metrics; "
        "lungmask_tpu_torch.runtime.serve). No input/output needed; honors "
        "--modelname/--modelpath/--batchsize/--cpu/--nopostprocess/--postprocessing. "
        "Runs --warmup first if given.",
    )
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.modelname == "LTRCLobes_R231" and args.modelpath is not None:
        parser.error(
            "the fused LTRCLobes_R231 mode resolves both models from the "
            "registry; --modelpath is not accepted here"
        )

    batchsize = 1 if args.cpu else args.batchsize
    inferer = None
    if args.warmup is not None:
        inferer = _warmup(args, batchsize)
        if args.serve is None:
            return
    if args.serve is not None:
        from lungmask_tpu_torch.runtime.serve import serve_forever

        host, _, port_s = args.serve.rpartition(":")
        try:
            port = int(port_s)
        except ValueError:
            parser.error(f"--serve expects [HOST:]PORT, got {args.serve!r}")
        serve_forever(inferer or _build_inferer(args, batchsize), host or "127.0.0.1", port)
        return
    if args.input is None or args.output is None:
        parser.error("input and output are required (or pass --warmup/--serve)")
    if args.cohort:
        if args.noHU:
            parser.error("--cohort does not support --noHU stacks")
        _cohort(args, batchsize)
        return

    # Patient and study tags are kept by default; dropped by flag or for
    # non-HU data (no DICOM source).
    keepmetadata = not args.removemetadata and not args.noHU

    logger.info("Load model")
    if args.noHU:
        from lungmask_tpu_torch.io import nohu

        if os.path.isdir(args.input):
            input_image = nohu.load_image_directory(args.input)
        else:
            input_image = nohu.load_image_stack([args.input])
    else:
        input_image = loader.load_input_image(
            args.input, disable_tqdm=args.noprogress, read_metadata=keepmetadata
        )

    logger.info("Infer lungmask")
    inferer = _build_inferer(args, batchsize)
    result = inferer.apply(input_image)

    result_out = input_image.with_array(result)
    if keepmetadata:
        kept = {
            k: v for k, v in input_image.metadata.items() if k in loader.DICOM_METADATA_TO_KEEP
        }
        kept["0008|103e"] = "Created with lungmask"  # SeriesDescription
        kept["0028|1050"] = "1"  # Window Center
        kept["0028|1051"] = "2"  # Window Width
        result_out.metadata = kept
    else:
        result_out.metadata = {}

    logger.info(f"Save result to: {args.output}")
    loader.write_image(result_out, args.output)


def _build_inferer(args, batchsize: int) -> LMInferer:
    common = dict(
        force_cpu=args.cpu,
        batch_size=batchsize,
        volume_postprocessing=not args.nopostprocess,
        tqdm_disable=args.noprogress,
        postprocessing_mode=args.postprocessing,
    )
    if args.modelname == "LTRCLobes_R231":
        return LMInferer(modelname="LTRCLobes", fillmodel="R231", **common)
    return LMInferer(modelname=args.modelname, modelpath=args.modelpath, **common)


_COHORT_EXTS = (
    ".dcm", ".nii", ".nii.gz", ".mha", ".mhd", ".nrrd", ".nhdr",
    ".hdr", ".img", ".vtk", ".gipl", ".gipl.gz",
)


def _cohort(args, batchsize) -> None:
    """Batch mode: each entry of INPUT (subdirectory = one DICOM series,
    file = one volume) streams through ``runtime.cohort``; masks land in
    OUTPUT. Failures are per volume (logged, recorded), not fatal: a corrupt
    series must not abort an overnight run."""
    from lungmask_tpu_torch.runtime.cohort import run_cohort

    if not os.path.isdir(args.input):
        sys.exit(f"--cohort input must be a directory: {args.input}")
    sources = []
    for entry in sorted(os.listdir(args.input)):
        p = os.path.join(args.input, entry)
        if os.path.isdir(p) or entry.lower().endswith(_COHORT_EXTS):
            sources.append(p)
    if not sources:
        sys.exit(f"No volumes found in {args.input}")
    os.makedirs(args.output, exist_ok=True)

    logger.info(f"Cohort: {len(sources)} volumes -> {args.output}")
    inferer = _build_inferer(args, batchsize)
    stats = run_cohort(sources, inferer, output_dir=args.output)
    failed = [r for r in stats.results if r.error]
    for r in failed:
        logger.error(f"{r.name}: {r.error}")
    logger.info(
        f"Cohort done: {len(stats.results) - len(failed)}/{len(stats.results)} "
        f"volumes in {stats.wall_seconds:.1f}s ({stats.volumes_per_hour:.0f} volumes/hour)"
    )
    logger.info("Cohort stages (seconds summed over the run):\n" + inferer.timings.report())
    logger.info("Cohort threads (busy and wait seconds): " + ", ".join(
        f"{key} {secs:.1f}s" for key, secs in stats.stage_seconds.items()))
    logger.info("Cohort .nii.gz deflate (process-wide counts): " + ", ".join(
        f"{key} {n}" for key, n in nifti.deflate_counts().items()))
    if failed and len(failed) == len(stats.results):
        sys.exit("every volume failed")


def _warmup(args, batchsize) -> LMInferer:
    """Warm start: the port has no compile cache, so warming builds the
    CUDA kernel libraries (on a CUDA inferer) and the host core, then runs
    the full pipeline twice on a synthetic lung phantom (cuDNN picks its
    algorithms on the first pass) and logs both times. Returns the warm
    inferer (``--serve`` goes on with it)."""
    import time

    from lungmask_tpu_torch.models.synthetic import lung_phantom
    from lungmask_tpu_torch.ops import native

    n = int(args.warmup)
    inferer = _build_inferer(args, batchsize)
    t0 = time.perf_counter()
    if inferer.device.type == "cuda":
        from lungmask_tpu_torch.ops.kernels import bodymask, stencil

        bodymask.build()
        stencil.build()
    native.native_loaded()
    built = time.perf_counter() - t0
    logger.info(f"Warmup: kernels and host core ready in {built:.1f}s; {n}-slice phantom")
    vol = lung_phantom(n)
    t0 = time.perf_counter()
    inferer.apply(vol)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    inferer.apply(vol)
    warm = time.perf_counter() - t0
    logger.info(f"Warmup complete: first pass {cold:.1f}s, warm pass {warm:.1f}s")
    return inferer


if __name__ == "__main__":
    main()
