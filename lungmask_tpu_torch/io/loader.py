"""Input loading & output writing: file-format dispatch + DICOM series assembly
(a copy of ``lungmask_tpu.io.loader``; PIL is imported only for raster files).

Capability parity with the reference's ``load_input_image`` / ``read_dicoms``
(lungmask/utils.py:132-269): a file path loads directly by
format; a directory is scanned for DICOM series (filtered, deduped, z-sorted)
and the largest volume wins. Output writing matches the CLI's behavior
(lungmask/__main__.py:119-144): geometry copied from the
input, keep-listed DICOM tags propagated.
"""

from __future__ import annotations

import gzip
import os
import sys
from typing import List, Optional

import numpy as np

from lungmask_tpu_torch.io import dicom, gipl, mha, nifti, nrrd, vtk
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


def get_DICOM_tags_to_keep():
    """Reference API parity (lungmask/utils.py:406-415)."""
    return DICOM_METADATA_TO_KEEP


def _volume_from_series(
    slices: List[dicom.DicomFile], read_metadata: bool = False
) -> MedicalImage:
    """Assemble a z-sorted DICOM slice list into a MedicalImage.

    A single multi-frame file (Enhanced-CT-style, NumberOfFrames > 1) IS the
    volume; mixing multi-frame and per-slice files in one series is refused."""
    arrays = []
    for hdr in slices:
        full = dicom.read_file(hdr.path)
        if full.pixels is None:
            raise dicom.DicomError(f"{hdr.path}: no pixel data")
        arrays.append(full.pixels)
    if any(a.ndim == 3 for a in arrays):
        if len(arrays) != 1:
            raise dicom.DicomError(
                f"{slices[0].path}: series mixes multi-frame and per-slice "
                "files — not supported"
            )
        vol = arrays[0]
    else:
        vol = np.stack(arrays, axis=0)

    first = slices[0]
    ps = first.get("0028|0030", "1\\1").split("\\")
    try:
        sx, sy = float(ps[1]), float(ps[0])  # PixelSpacing is row\col = (y, x)
    except (IndexError, ValueError):
        logger.warning(
            f"{first.path}: malformed PixelSpacing "
            f"{first.get('0028|0030')!r}; assuming 1\\1 mm"
        )
        sx = sy = 1.0
    pos0 = first.position or (0.0, 0.0, 0.0)
    if len(slices) > 1 and slices[1].position is not None:
        dz_vec = np.asarray(slices[1].position) - np.asarray(pos0)
        sz = float(np.linalg.norm(dz_vec))
        zdir = dz_vec / sz if sz > 0 else np.array([0.0, 0.0, 1.0])
    else:
        # Multi-frame / single-slice: SpacingBetweenSlices wins over
        # SliceThickness (frames are spaced, not necessarily contiguous).
        sz = float(first.get("0018|0088", "") or first.get("0018|0050", "1") or 1)
        zdir = None

    iop = first.get("0020|0037", "1\\0\\0\\0\\1\\0").split("\\")
    try:
        row_cos = np.asarray([float(v) for v in iop[:3]])  # dir of +x (cols)
        col_cos = np.asarray([float(v) for v in iop[3:6]])  # dir of +y (rows)
        if row_cos.shape != (3,) or col_cos.shape != (3,):
            raise ValueError("short IOP")
    except ValueError:
        logger.warning(
            f"{first.path}: malformed ImageOrientationPatient "
            f"{first.get('0020|0037')!r}; assuming axial"
        )
        row_cos = np.asarray([1.0, 0.0, 0.0])
        col_cos = np.asarray([0.0, 1.0, 0.0])
    if zdir is None:
        zdir = np.cross(row_cos, col_cos)
    direction = np.stack([row_cos, col_cos, zdir], axis=1)

    metadata = dict(first.tags) if read_metadata else {}
    return MedicalImage(
        array=vol,
        spacing=(sx, sy, sz),
        origin=tuple(pos0),
        direction=direction,
        metadata=metadata,
    )


def read_dicoms(
    path: str,
    primary: bool = True,
    original: bool = True,
    disable_tqdm: bool = False,
    read_metadata: bool = False,
) -> List[MedicalImage]:
    """Reference ``read_dicoms`` (lungmask/utils.py:132-230):
    list of assembled volumes, one per DICOM series under ``path``."""
    series = dicom.scan_directory(
        path, primary=primary, original=original, disable_tqdm=disable_tqdm
    )
    return [_volume_from_series(s, read_metadata=read_metadata) for s in series]


def _read_hdr_img(path: str) -> MedicalImage:
    """Dispatch .hdr/.img pairs: detached NIfTI ("ni1" magic) vs Analyze 7.5."""
    import gzip

    from lungmask_tpu_torch.io import analyze

    hdr_path, _ = analyze._paths(path)
    opener = gzip.open if hdr_path.endswith(".gz") else open
    with opener(hdr_path, "rb") as f:
        head = f.read(348)
    if len(head) >= 348 and head[344:348] == b"ni1\x00":
        return nifti.read(hdr_path)
    return analyze.read(path)


def _write_analyze(image: MedicalImage, path: str) -> None:
    from lungmask_tpu_torch.io import analyze

    analyze.write(image, path)


def _read_raster(path: str) -> MedicalImage:
    """Raster images (png/jpg/bmp/tiff) as single-slice volumes — the
    reference reads these through ``sitk.ImageFileReader`` like any other ITK
    format (lungmask/utils.py:247-249), yielding raw stored
    pixel values (no HU mapping; the ``--noHU`` path owns the 8-bit →
    pseudo-HU window, io/nohu.py)."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("I", "I;16", "I;16B", "I;16L"):
            arr = np.asarray(im, dtype=np.int32)
        else:
            arr = np.asarray(im.convert("L")).astype(np.int32)
    dtype = np.int16 if arr.min() >= -(2**15) and arr.max() < 2**15 else np.int32
    return MedicalImage(arr[None].astype(dtype))


def _write_raster(image: MedicalImage, path: str) -> None:
    from PIL import Image

    arr = np.asarray(image.array)
    if arr.ndim == 3:
        if arr.shape[0] != 1:
            raise ValueError(
                f"{path}: raster formats hold one slice; got {arr.shape[0]}"
            )
        arr = arr[0]
    if path.lower().endswith((".jpg", ".jpeg")):
        # ITK's JPEGImageIO accepts label maps too; JPEG is lossy, so small
        # label values can shift. Honor the request but say so.
        logger.warning(f"{path}: JPEG is lossy — label values may not round-trip")
    Image.fromarray(arr.astype(np.uint8), mode="L").save(path)


_READERS = {
    ".nii": nifti.read,
    ".nii.gz": nifti.read,
    ".mha": mha.read,
    ".mhd": mha.read,
    ".nrrd": nrrd.read,
    ".nhdr": nrrd.read,
    ".hdr": _read_hdr_img,
    ".hdr.gz": _read_hdr_img,
    ".img": _read_hdr_img,
    ".img.gz": _read_hdr_img,
    ".vtk": vtk.read,
    ".gipl": gipl.read,
    ".png": _read_raster,
    ".jpg": _read_raster,
    ".jpeg": _read_raster,
    ".bmp": _read_raster,
    ".tif": _read_raster,
    ".tiff": _read_raster,
}
_WRITERS = {
    ".nii": nifti.write,
    ".nii.gz": nifti.write,
    ".mha": mha.write,
    ".mhd": mha.write,
    ".nrrd": nrrd.write,
    ".nhdr": nrrd.write,
    ".hdr": _write_analyze,
    ".hdr.gz": _write_analyze,
    ".img": _write_analyze,
    ".img.gz": _write_analyze,
    ".vtk": vtk.write,
    ".gipl": gipl.write,
    ".png": _write_raster,
    ".jpg": _write_raster,
    ".jpeg": _write_raster,
    ".bmp": _write_raster,
    ".tif": _write_raster,
    ".tiff": _write_raster,
}


# Formats with an in-memory decode/encode path (serving-lane fast lane — no
# temp-file spool). NIfTI is the lane's dominant wire format; other formats
# keep the spool-to-scratch path.
_MEMORY_FORMATS = (".nii", ".nii.gz")


def supports_memory_io(name: str) -> bool:
    """True if ``name``'s format can be decoded from / encoded to a single
    in-memory buffer (load_input_bytes / encode_image_bytes)."""
    return _format_of(name) in _MEMORY_FORMATS


def load_input_bytes(data, name: str) -> MedicalImage:
    """Decode a whole in-memory upload whose format is given by ``name``'s
    extension. Only :data:`_MEMORY_FORMATS` are supported — callers should
    check :func:`supports_memory_io` and fall back to a spooled
    :func:`load_input_image`. ``data`` may be bytes/bytearray/memoryview; a
    writable buffer is aliased zero-copy."""
    ext = _format_of(name)
    if ext not in _MEMORY_FORMATS:
        raise ValueError(f"{name}: no in-memory decoder for this format")
    return nifti.read_bytes(data, name)


def encode_image_bytes(image: MedicalImage, ext: str) -> bytes:
    """Encode ``image`` to file-format bytes entirely in memory (the inverse
    of :func:`load_input_bytes`; same :data:`_MEMORY_FORMATS` support)."""
    if ext not in _MEMORY_FORMATS:
        raise ValueError(f"{ext}: no in-memory encoder for this format")
    payload = nifti.encode(image)
    if ext.endswith(".gz"):
        # Level 1: masks are runs of small labels — higher levels cost ~3x
        # the CPU for a few percent smaller body on this payload class.
        payload = gzip.compress(payload, compresslevel=1)
    return payload


def _format_of(path: str) -> Optional[str]:
    lower = path.lower()
    for ext in (
        ".nii.gz", ".nii", ".mha", ".mhd", ".nrrd", ".nhdr", ".img.gz",
        ".hdr.gz", ".hdr", ".img", ".vtk", ".gipl", ".png", ".jpg", ".jpeg",
        ".bmp", ".tif", ".tiff",
    ):
        if lower.endswith(ext):
            return ext
    return None


def load_input_image(
    path: str, disable_tqdm: bool = False, read_metadata: bool = False
) -> MedicalImage:
    """File → load by format (DICOM single file included); directory → DICOM
    scan, largest volume wins (lungmask/utils.py:233-269)."""
    if os.path.isfile(path):
        logger.info(f"Read input: {path}")
        ext = _format_of(path)
        if ext is not None:
            img = _READERS[ext](path)
            return img
        # Fall back to single-file DICOM.
        f = dicom.read_file(path)
        if f.pixels is None:
            raise ValueError(f"{path}: unsupported image file")
        return _volume_from_series([f], read_metadata=read_metadata)

    logger.info(f"Looking for dicoms in {path}")
    volumes = read_dicoms(
        path,
        primary=False,
        original=False,
        disable_tqdm=disable_tqdm,
        read_metadata=read_metadata,
    )
    if len(volumes) < 1:
        sys.exit("No dicoms found!")
    if len(volumes) > 1:
        logger.warning(
            "There are more than one volume in the path, will take the largest one"
        )
    return volumes[int(np.argmax([v.voxel_count() for v in volumes]))]


# Tags write_slice computes fresh for the OUTPUT volume. Caller-supplied tags
# override write_slice's own elements, so copying these from the input would
# corrupt the mask: e.g. the CT's RescaleIntercept=-1024 would make mask value
# 1 read back as -1023 HU, and a copied SOPInstanceUID would duplicate across
# slices. Group 0002 (file meta) and 7FE0 (pixel data) are excluded wholesale.
_SERIES_TAGS_NOT_COPIED = frozenset(
    {
        (0x0008, 0x0016),  # SOPClassUID
        (0x0008, 0x0018),  # SOPInstanceUID (fresh per slice)
        (0x0018, 0x0050),  # SliceThickness
        (0x0018, 0x0088),  # SpacingBetweenSlices
        (0x0020, 0x000D),  # StudyInstanceUID (carried via study_uid param)
        (0x0020, 0x000E),  # SeriesInstanceUID (fresh)
        (0x0020, 0x0013),  # InstanceNumber (per slice)
        (0x0020, 0x0032),  # ImagePositionPatient (per slice)
        (0x0020, 0x0037),  # ImageOrientationPatient
        (0x0028, 0x0002),  # SamplesPerPixel
        (0x0028, 0x0004),  # PhotometricInterpretation
        (0x0028, 0x0008),  # NumberOfFrames
        (0x0028, 0x0010),  # Rows
        (0x0028, 0x0011),  # Columns
        (0x0028, 0x0030),  # PixelSpacing
        (0x0028, 0x0100),  # BitsAllocated
        (0x0028, 0x0101),  # BitsStored
        (0x0028, 0x0102),  # HighBit
        (0x0028, 0x0103),  # PixelRepresentation
        (0x0028, 0x1052),  # RescaleIntercept
        (0x0028, 0x1053),  # RescaleSlope
        (0x0028, 0x1054),  # RescaleType
    }
)
# WindowCenter/Width (0028,1050/1051) are deliberately NOT excluded: the CLI
# writes the reference's marker values through this path (__main__.py:142-143).


def write_dicom_series(image: MedicalImage, path: str) -> None:
    """Write a volume as a DICOM series.

    ``path`` ending in ``.dcm`` is used as a filename template
    (``stem_0000.dcm`` …) — one CT slice file per z index, carrying the
    image's metadata tags (the CLI places the keep-list + marker tags there,
    matching the reference's DICOM output behavior,
    lungmask/__main__.py:125-141). The StudyInstanceUID from
    the metadata is preserved when present (SetKeepOriginalImageUID parity).
    """
    stem = path[: -len(".dcm")]
    d = np.asarray(image.direction)
    orientation = tuple(d[:, 0]) + tuple(d[:, 1])
    zdir = d[:, 2]
    origin = np.asarray(image.origin, dtype=np.float64)
    study_uid = image.metadata.get("0020|000d", "").strip() or dicom.generate_uid()
    series_uid = dicom.generate_uid()
    extra = {}
    for key, value in image.metadata.items():
        try:
            g, e = (int(p, 16) for p in key.split("|"))
        except ValueError:
            continue
        if g in (0x0002, 0x7FE0) or (g, e) in _SERIES_TAGS_NOT_COPIED:
            continue
        extra[(g, e)] = value
    arr = image.array
    if arr.dtype != np.int16:
        arr = arr.astype(np.int16)
    for z in range(arr.shape[0]):
        pos = origin + zdir * image.spacing[2] * z
        dicom.write_slice(
            f"{stem}_{z:04d}.dcm",
            arr[z],
            series_uid=series_uid,
            study_uid=study_uid,
            position=tuple(pos),
            orientation=orientation,
            spacing=(image.spacing[1], image.spacing[0]),
            slice_thickness=image.spacing[2],
            tags={**extra, (0x0020, 0x0013): str(z + 1)},
        )


def write_image(image: MedicalImage, path: str) -> None:
    if path.lower().endswith(".dcm"):
        write_dicom_series(image, path)
        return
    ext = _format_of(path)
    if ext is None or ext not in _WRITERS:
        raise ValueError(
            f"{path}: unsupported output format (supported: .nii[.gz], .mha, "
            ".mhd, .nrrd, .nhdr, .hdr/.img[.gz], .vtk, .gipl, "
            ".png/.jpg/.bmp/.tif, .dcm)"
        )
    _WRITERS[ext](image, path)
