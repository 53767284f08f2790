"""GIPL (.gipl) reader/writer — further file-format parity with the
reference's ITK-based I/O (lungmask/utils.py:247-249); ITK
ships a GiplImageIO.

Format (Guys Image Processing Lab, as implemented by itkGiplImageIO): a fixed
256-byte BIG-endian header —

    offset  size  field
    0       8     dims[4]           (ushort ×4; 4th dim 0/1 for volumes)
    8       2     image_type        (ushort; 8=uchar, 15=short, 16=ushort,
                                     31=uint, 32=int, 64=float, 65=double)
    10      16    pixdim[4]         (float ×4)
    26      80    line1             (ASCII patient info, zero-padded)
    106     80    matrix[20]        (float ×20)
    186     2     flag1, flag2
    188     16    min, max          (double ×2)
    204     32    origin[4]         (double ×4)
    236     16    pixval_offset/cal, user_def1/2 (float ×4)
    252     4     magic = 719555000 (0x2AE389B8)

Payload: voxels in x-fastest order, BIG-endian. GIPL carries no direction
matrix — identity on read; writing a non-identity direction is refused.
"""

from __future__ import annotations

import struct

import numpy as np

from lungmask_tpu_torch.io.image import MedicalImage, coerce_for_write

MAGIC = 719555000

_GIPL_TYPES = {
    8: np.uint8,
    15: np.int16,
    16: np.uint16,
    31: np.uint32,
    32: np.int32,
    64: np.float32,
    65: np.float64,
}
_GIPL_CODES = {np.dtype(v): k for k, v in _GIPL_TYPES.items()}


def read(path: str) -> MedicalImage:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 256:
        raise ValueError(f"{path}: truncated GIPL header")
    (magic,) = struct.unpack_from(">I", data, 252)
    if magic != MAGIC:
        raise ValueError(f"{path}: bad GIPL magic {magic:#x}")
    dims = struct.unpack_from(">4H", data, 0)
    (image_type,) = struct.unpack_from(">H", data, 8)
    pixdim = struct.unpack_from(">4f", data, 10)
    origin = struct.unpack_from(">3d", data, 204)
    dtype = _GIPL_TYPES.get(image_type)
    if dtype is None:
        raise ValueError(f"{path}: unsupported GIPL image type {image_type}")
    nx, ny, nz = dims[0], dims[1], max(dims[2], 1)
    n = nx * ny * nz
    be = np.dtype(dtype).newbyteorder(">")
    if len(data) - 256 < n * be.itemsize:
        raise ValueError(
            f"{path}: GIPL payload truncated "
            f"({len(data) - 256} bytes < {n * be.itemsize})"
        )
    arr = np.frombuffer(data[256:], dtype=be, count=n).astype(dtype)
    return MedicalImage(
        array=np.ascontiguousarray(arr.reshape(nz, ny, nx)),
        spacing=tuple(float(p) or 1.0 for p in pixdim[:3]),
        origin=tuple(origin),
    )


def write(image: MedicalImage, path: str) -> None:
    if not np.allclose(image.direction, np.eye(3)):
        raise ValueError(f"{path}: GIPL cannot carry a direction matrix")
    arr = coerce_for_write(image.array, _GIPL_CODES)
    nz, ny, nx = arr.shape
    header = bytearray(256)
    struct.pack_into(">4H", header, 0, nx, ny, nz, 1)
    struct.pack_into(">H", header, 8, _GIPL_CODES[arr.dtype])
    struct.pack_into(">4f", header, 10, *image.spacing, 1.0)
    struct.pack_into(
        ">2d", header, 188, float(arr.min()), float(arr.max())
    )
    struct.pack_into(">4d", header, 204, *image.origin, 0.0)
    struct.pack_into(">I", header, 252, MAGIC)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(arr.astype(arr.dtype.newbyteorder(">")).tobytes())
