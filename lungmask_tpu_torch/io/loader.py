"""Input loading and output writing (counterpart of ``lungmask_tpu.io.loader``).

This slice of the port reads and writes NIfTI (``.nii`` / ``.nii.gz``) only.
Every other format of the JAX loader (DICOM series and codecs, MetaImage,
NRRD, Analyze, VTK, GIPL, raster) raises ``NotImplementedError``; it is
ROADMAP.md queue 1, item 2 (DICOM I/O and codecs, other formats).
"""

from __future__ import annotations

import os
from typing import Optional

from lungmask_tpu_torch.io import nifti
from lungmask_tpu_torch.io.image import MedicalImage
from lungmask_tpu_torch.logger import logger

# DICOM tags carried input → output — the reference's keep list
# (lungmask/utils.py:17-30).
DICOM_METADATA_TO_KEEP = (
    "0008|0020",  # StudyDate
    "0008|0030",  # StudyTime
    "0008|0050",  # AccessionNumber
    "0008|0090",  # ReferringPhysicianName
    "0008|1030",  # StudyDescription
    "0010|0010",  # PatientName
    "0010|0020",  # PatientID
    "0010|0030",  # PatientBirthDate
    "0010|0040",  # PatientSex
    "0018|5100",  # Patient Position
    "0020|000d",  # StudyInstanceUID
    "0020|0010",  # StudyID
)

_NOT_PORTED = (
    "{what}: only NIfTI (.nii, .nii.gz) is ported to lungmask_tpu_torch so "
    "far; other formats and DICOM are ROADMAP.md queue 1, item 2"
)


def _format_of(path: str) -> Optional[str]:
    lower = path.lower()
    for ext in (".nii.gz", ".nii"):
        if lower.endswith(ext):
            return ext
    return None


def load_input_image(
    path: str, disable_tqdm: bool = False, read_metadata: bool = False
) -> MedicalImage:
    """NIfTI file → :class:`MedicalImage`. Directories (DICOM series) and
    other formats raise ``NotImplementedError``."""
    if os.path.isfile(path) and _format_of(path) is not None:
        logger.info(f"Read input: {path}")
        return nifti.read(path)
    raise NotImplementedError(_NOT_PORTED.format(what=path))


def write_image(image: MedicalImage, path: str) -> None:
    if _format_of(path) is None:
        raise NotImplementedError(_NOT_PORTED.format(what=path))
    nifti.write(image, path)
