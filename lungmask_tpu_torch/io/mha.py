"""MetaImage (.mha/.mhd) reader/writer — broadens file-format parity with the
reference's ITK-based I/O (lungmask/utils.py:247-249) beyond
NIfTI. Single-file (.mha, ElementDataFile = LOCAL) and detached-header (.mhd +
raw/zraw data file) forms, optional zlib compression."""

from __future__ import annotations

import os
import zlib
from typing import Dict

import numpy as np

from lungmask_tpu_torch.io.image import MedicalImage, coerce_for_write

_MET_TYPES = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_MET_NAMES = {np.dtype(v): k for k, v in _MET_TYPES.items()}


def read(path: str) -> MedicalImage:
    with open(path, "rb") as f:
        data = f.read()
    header: Dict[str, str] = {}
    pos = 0
    while True:
        nl = data.index(b"\n", pos)
        # latin-1 never fails: headers written by other tools may carry
        # non-ASCII metadata bytes (e.g. accented names in Comment fields).
        line = data[pos:nl].decode("latin-1").strip()
        pos = nl + 1
        if "=" not in line:
            raise ValueError(f"{path}: malformed MetaImage header line {line!r}")
        key, val = (s.strip() for s in line.split("=", 1))
        header[key] = val
        if key == "ElementDataFile":
            break
    datafile = header.get("ElementDataFile")
    # ITK honors HeaderSize only for detached data files; a LOCAL .mha payload
    # starts right after the header regardless of a HeaderSize field.
    header_size = 0
    if datafile != "LOCAL":
        # .mhd detached header: data lives in a sibling file.
        data_path = os.path.join(os.path.dirname(path), datafile)
        with open(data_path, "rb") as f:
            raw = f.read()
        header_size = int(header.get("HeaderSize", "0") or 0)
        if header_size > 0:
            raw = raw[header_size:]
    else:
        raw = data[pos:]
    # HeaderSize = -1 (data at the tail) resolves after the size is known.
    if int(header.get("NDims", "3")) != 3:
        raise ValueError(f"{path}: only 3-D MetaImages supported")
    channels = int(header.get("ElementNumberOfChannels", "1") or 1)
    if channels != 1:
        # Reading interleaved multi-channel bytes as scalar voxels would be
        # silently wrong (the size check passes — the file is larger).
        raise ValueError(
            f"{path}: multi-channel MetaImage (ElementNumberOfChannels="
            f"{channels}) is not supported; CT volumes are single-channel"
        )
    dims = [int(v) for v in header["DimSize"].split()]
    dtype = _MET_TYPES[header["ElementType"]]
    spacing = [float(v) for v in header.get("ElementSpacing", "1 1 1").split()]
    origin = [float(v) for v in header.get("Offset", header.get("Position", "0 0 0")).split()]
    tm = [float(v) for v in header.get("TransformMatrix", "1 0 0 0 1 0 0 0 1").split()]
    # MetaIO stores the matrix row-major with ROWS = image axis directions;
    # our convention keeps them as columns.
    direction = np.asarray(tm, dtype=np.float64).reshape(3, 3).T

    if header.get("CompressedData", "False").lower() == "true":
        raw = zlib.decompress(raw)
    nx, ny, nz = dims
    need = nx * ny * nz * np.dtype(dtype).itemsize
    if header_size == -1:
        raw = raw[-need:]
    if len(raw) < need:
        raise ValueError(
            f"{path}: MetaImage payload truncated ({len(raw)} < {need})"
        )
    arr = np.frombuffer(raw, dtype=dtype, count=nx * ny * nz).reshape(nz, ny, nx)
    if header.get("BinaryDataByteOrderMSB", "False").lower() == "true" or (
        header.get("ElementByteOrderMSB", "False").lower() == "true"
    ):
        arr = arr.byteswap().view(arr.dtype)
    return MedicalImage(
        array=np.ascontiguousarray(arr),
        spacing=tuple(spacing),
        origin=tuple(origin),
        direction=direction,
    )


def write(image: MedicalImage, path: str, compressed: bool = False) -> None:
    arr = coerce_for_write(image.array, _MET_NAMES)
    nz, ny, nx = arr.shape
    detached = path.lower().endswith(".mhd")
    if detached:
        data_name = os.path.basename(path)[:-4] + (".zraw" if compressed else ".raw")
    else:
        data_name = "LOCAL"
    tm = " ".join(str(v) for v in np.asarray(image.direction).T.reshape(-1))
    lines = [
        "ObjectType = Image",
        "NDims = 3",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
        f"TransformMatrix = {tm}",
        f"Offset = {image.origin[0]} {image.origin[1]} {image.origin[2]}",
        "CenterOfRotation = 0 0 0",
        f"ElementSpacing = {image.spacing[0]} {image.spacing[1]} {image.spacing[2]}",
        f"DimSize = {nx} {ny} {nz}",
        f"ElementType = {_MET_NAMES[arr.dtype]}",
        f"ElementDataFile = {data_name}",
    ]
    payload = arr.tobytes()
    if compressed:
        payload = zlib.compress(payload)
    header = ("\n".join(lines) + "\n").encode("ascii")
    if detached:
        with open(path, "wb") as f:
            f.write(header)
        with open(os.path.join(os.path.dirname(path), data_name), "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(header + payload)
