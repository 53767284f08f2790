"""Input loading and output writing (counterpart of ``lungmask_tpu.io.loader``).

The port reads and writes NIfTI (``.nii`` / ``.nii.gz``), from files and,
for the serving lane, from and to in-memory buffers. Every other format of
the JAX loader (DICOM series and codecs, MetaImage, NRRD, Analyze, VTK,
GIPL, raster) raises ``NotImplementedError``; it is ROADMAP.md queue 1,
item 2 (DICOM I/O and codecs, other formats).
"""

from __future__ import annotations

import gzip
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


# Formats with an in-memory decode/encode path (the serving lane's fast lane,
# no temp-file spool).
_MEMORY_FORMATS = (".nii", ".nii.gz")


def supports_memory_io(name: str) -> bool:
    """Whether ``name``'s format decodes from / encodes to one in-memory
    buffer (:func:`load_input_bytes` / :func:`encode_image_bytes`)."""
    return _format_of(name) in _MEMORY_FORMATS


def load_input_bytes(data, name: str) -> MedicalImage:
    """Decode a whole in-memory upload whose format ``name``'s extension
    gives. ``data`` may be bytes, bytearray or memoryview; a writable buffer
    is aliased without a copy."""
    if not supports_memory_io(name):
        raise ValueError(f"{name}: no in-memory decoder for this format")
    return nifti.read_bytes(data, name)


def encode_image_bytes(image: MedicalImage, ext: str) -> bytes:
    """Encode ``image`` to file-format bytes in memory (the inverse of
    :func:`load_input_bytes`)."""
    if ext not in _MEMORY_FORMATS:
        raise ValueError(f"{ext}: no in-memory encoder for this format")
    payload = nifti.encode(image)
    if ext.endswith(".gz"):
        # Level 1: masks are runs of small labels; higher levels cost ~3x
        # the CPU for a few percent smaller bodies.
        payload = gzip.compress(payload, compresslevel=1)
    return payload
