"""Command-line interface: ``lungmask-torch INPUT OUTPUT`` (counterpart of
``lungmask_tpu.cli``, also ``python -m lungmask_tpu_torch``).

The reference's flags (lungmask/__main__.py:20-144): positional input and
output, ``--modelname`` (``LTRCLobes_R231`` is the fused two-model mode,
both models from the registry), ``--modelpath``, ``--cpu`` (forces batch
size 1), ``--nopostprocess``, ``--batchsize``, ``--noprogress``,
``--version``, ``--removemetadata``. The port reads and writes NIfTI. Not
ported yet: ``--cohort``, ``--serve``, ``--warmup``, ``--noHU`` and
``--postprocessing`` (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import argparse
import os
import sys

from lungmask_tpu_torch import __version__
from lungmask_tpu_torch.inferer import LMInferer
from lungmask_tpu_torch.io import loader
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
        "input", metavar="input", type=path,
        help="CT volume to segment (.nii or .nii.gz)",
    )
    parser.add_argument(
        "output", metavar="output", type=str,
        help="where to write the resulting label volume (.nii or .nii.gz)",
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
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.modelname == "LTRCLobes_R231" and args.modelpath is not None:
        parser.error(
            "the fused LTRCLobes_R231 mode resolves both models from the "
            "registry; --modelpath is not accepted here"
        )

    batchsize = 1 if args.cpu else args.batchsize
    keepmetadata = not args.removemetadata

    logger.info("Load model")
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
    )
    if args.modelname == "LTRCLobes_R231":
        return LMInferer(modelname="LTRCLobes", fillmodel="R231", **common)
    return LMInferer(modelname=args.modelname, modelpath=args.modelpath, **common)


if __name__ == "__main__":
    main()
