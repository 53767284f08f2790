"""Analyze 7.5 reader/writer (.hdr/.img pairs, optional .img.gz).

Part of matching the reference's "any ITK format" file-input surface
(lungmask/utils.py:247-249). The 348-byte Analyze header is
the layout NIfTI-1 was designed to stay compatible with, so the field offsets
mirror io/nifti.py; unlike NIfTI there is no affine — Analyze carries no
orientation, so images load with identity direction in LPS and a zero origin
(the same axis-convention gamble every Analyze consumer makes; the ``orient``
byte is honored only to reject the flipped variants loudly).

Both endiannesses are supported (the format predates a fixed byte order;
readers sniff ``sizeof_hdr``).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from lungmask_tpu_torch.io.image import MedicalImage, coerce_for_write

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _paths(path: str):
    base = path
    for ext in (".hdr.gz", ".hdr", ".img.gz", ".img"):
        if path.lower().endswith(ext):
            base = path[: -len(ext)]
            break
    hdr = base + ".hdr"
    if not os.path.exists(hdr) and os.path.exists(hdr + ".gz"):
        hdr = hdr + ".gz"
    img = base + ".img"
    if not os.path.exists(img) and os.path.exists(img + ".gz"):
        img = img + ".gz"
    return hdr, img


def read(path: str) -> MedicalImage:
    hdr_path, img_path = _paths(path)
    hdr_opener = gzip.open if hdr_path.endswith(".gz") else open
    with hdr_opener(hdr_path, "rb") as f:
        hdr = f.read()
    if len(hdr) < 348:
        raise ValueError(f"{hdr_path}: truncated Analyze header")
    for endian in ("<", ">"):
        (sizeof_hdr,) = struct.unpack_from(endian + "i", hdr, 0)
        if sizeof_hdr == 348:
            break
    else:
        raise ValueError(f"{hdr_path}: not an Analyze 7.5 header")

    dim = struct.unpack_from(endian + "8h", hdr, 40)
    ndim = dim[0]
    nx, ny, nz = dim[1], max(dim[2], 1), max(dim[3], 1)
    if ndim > 3 and any(d > 1 for d in dim[4 : 1 + ndim]):
        raise ValueError(f"{hdr_path}: >3-D Analyze not supported")
    datatype, bitpix = struct.unpack_from(endian + "2h", hdr, 70)
    if datatype not in _DTYPES:
        raise ValueError(f"{hdr_path}: unsupported Analyze datatype {datatype}")
    pixdim = struct.unpack_from(endian + "8f", hdr, 76)
    orient = hdr[252] if len(hdr) > 252 else 0
    if orient not in (0, 255):  # 0 = transverse unflipped; 255 = unset
        raise ValueError(
            f"{hdr_path}: Analyze orient={orient} (flipped/sagittal/coronal) "
            "not supported — convert to NIfTI to carry orientation"
        )

    opener = gzip.open if img_path.endswith(".gz") else open
    with opener(img_path, "rb") as f:
        data = f.read()
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    arr = np.frombuffer(data, dtype=dtype, count=nx * ny * nz).reshape(nz, ny, nx)
    arr = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder("=")))

    spacing = [abs(p) or 1.0 for p in pixdim[1:4]]
    return MedicalImage(
        array=arr,
        spacing=tuple(spacing),
        origin=(0.0, 0.0, 0.0),
        direction=np.eye(3),
    )


def write(image: MedicalImage, path: str) -> None:
    # Derive the pair from the REQUESTED name only (no existence probing like
    # _paths does for reads — a stale .hdr.gz next to a plain .hdr request
    # must not turn the output gzipped). A .gz request gzips both halves,
    # matching the nibabel/ITK pairing convention.
    base, gz = path, False
    for ext in (".hdr.gz", ".img.gz", ".hdr", ".img"):
        if path.lower().endswith(ext):
            base = path[: -len(ext)]
            gz = ext.endswith(".gz")
            break
    suffix = ".gz" if gz else ""
    hdr_path = base + ".hdr" + suffix
    img_path = base + ".img" + suffix
    opener = gzip.open if gz else open
    arr = coerce_for_write(image.array, _CODES)
    nz, ny, nx = arr.shape

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    hdr[32:36] = b"r0\x00\x00"  # hkey_un0/extents region marker unused
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<2h", hdr, 70, _CODES[arr.dtype], arr.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *[float(s) for s in image.spacing],
                     1.0, 1.0, 1.0, 1.0)
    hdr[252] = 0  # transverse unflipped

    with opener(hdr_path, "wb") as f:
        f.write(bytes(hdr))
    with opener(img_path, "wb") as f:
        f.write(arr.tobytes())
