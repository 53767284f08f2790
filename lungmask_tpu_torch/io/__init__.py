"""File formats and DICOM (the port of ``lungmask_tpu.io``)."""

from lungmask_tpu_torch.io.image import MedicalImage, orientation_code, reorient
from lungmask_tpu_torch.io.loader import (
    DICOM_METADATA_TO_KEEP,
    get_DICOM_tags_to_keep,
    load_input_image,
    read_dicoms,
    write_image,
)

__all__ = [
    "MedicalImage",
    "orientation_code",
    "reorient",
    "DICOM_METADATA_TO_KEEP",
    "get_DICOM_tags_to_keep",
    "load_input_image",
    "read_dicoms",
    "write_image",
]
