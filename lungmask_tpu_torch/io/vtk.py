"""Legacy VTK structured-points (.vtk) reader/writer — further file-format
parity with the reference's ITK-based I/O
(lungmask/utils.py:247-249); ITK ships a VTKImageIO that
reads/writes this format.

Format (VTK file formats spec, legacy): a 5-part ASCII header — version line,
title, BINARY|ASCII, ``DATASET STRUCTURED_POINTS`` with DIMENSIONS / SPACING /
ORIGIN lines, then ``POINT_DATA n`` + ``SCALARS name type`` +
``LOOKUP_TABLE default`` followed by the voxel payload. BINARY payloads are
BIG-endian by spec. Structured points carry no direction matrix — identity on
read, and writing a non-identity direction is refused rather than silently
dropped.
"""

from __future__ import annotations

import numpy as np

from lungmask_tpu_torch.io.image import MedicalImage, coerce_for_write

_VTK_TYPES = {
    "char": np.int8,
    "unsigned_char": np.uint8,
    "short": np.int16,
    "unsigned_short": np.uint16,
    "int": np.int32,
    "unsigned_int": np.uint32,
    "long": np.int64,
    "unsigned_long": np.uint64,
    "float": np.float32,
    "double": np.float64,
}
_VTK_NAMES = {np.dtype(v): k for k, v in _VTK_TYPES.items()}


def read(path: str) -> MedicalImage:
    with open(path, "rb") as f:
        data = f.read()

    lines = []
    pos = 0
    # Header is ASCII lines up to SCALARS plus an optional LOOKUP_TABLE line
    # (optional per the legacy-format spec); scan line-by-line so binary
    # payload bytes stay untouched.
    saw_scalars = False
    while pos < len(data):
        nl = data.find(b"\n", pos)
        if saw_scalars:
            # Peek one line: consume it only if it is the optional
            # LOOKUP_TABLE; anything else (including newline-free binary
            # payload) starts the data section at ``pos``.
            end = nl if nl != -1 else len(data)
            line = data[pos:end].rstrip(b"\r").decode("ascii", "replace").strip()
            if nl != -1 and line.upper().startswith("LOOKUP_TABLE"):
                lines.append(line)
                pos = nl + 1
            break
        if nl == -1:
            raise ValueError(f"{path}: truncated VTK header")
        line = data[pos:nl].rstrip(b"\r").decode("ascii", "replace").strip()
        pos = nl + 1
        lines.append(line)
        if line.upper().startswith("SCALARS"):
            saw_scalars = True
    if not saw_scalars:
        raise ValueError(f"{path}: no SCALARS declaration found")

    if not lines or not lines[0].startswith("# vtk DataFile"):
        raise ValueError(f"{path}: not a legacy VTK file")
    fields = {}
    fmt = None
    for line in lines[2:]:
        up = line.upper()
        if up in ("BINARY", "ASCII"):
            fmt = up
        elif up.startswith(
            ("DATASET", "DIMENSIONS", "SPACING", "ASPECT_RATIO", "ORIGIN",
             "POINT_DATA", "SCALARS")
        ):
            # split(None, 1): the legacy format is free-form — any run of
            # whitespace (tabs included) separates keyword from values.
            parts = line.split(None, 1)
            fields[parts[0].upper()] = parts[1].strip() if len(parts) > 1 else ""
    if fmt is None:
        raise ValueError(f"{path}: missing BINARY/ASCII format line")
    if fields.get("DATASET", "").upper() != "STRUCTURED_POINTS":
        raise ValueError(
            f"{path}: only STRUCTURED_POINTS supported "
            f"(got {fields.get('DATASET')!r})"
        )
    nx, ny, nz = (int(v) for v in fields["DIMENSIONS"].split())
    spacing = tuple(
        float(v)
        for v in fields.get("SPACING", fields.get("ASPECT_RATIO", "1 1 1")).split()
    )
    origin = tuple(float(v) for v in fields.get("ORIGIN", "0 0 0").split())
    scalars = fields.get("SCALARS", "scalars unsigned_char").split()
    type_name = scalars[1] if len(scalars) > 1 else "unsigned_char"
    ncomp = int(scalars[2]) if len(scalars) > 2 else 1
    if ncomp != 1:
        raise ValueError(f"{path}: only 1-component scalars supported")
    dtype = _VTK_TYPES.get(type_name)
    if dtype is None:
        raise ValueError(f"{path}: unsupported VTK scalar type {type_name!r}")

    n = nx * ny * nz
    if fmt == "BINARY":
        be = np.dtype(dtype).newbyteorder(">")
        if len(data) - pos < n * be.itemsize:
            raise ValueError(
                f"{path}: VTK payload truncated "
                f"({len(data) - pos} bytes < {n * be.itemsize})"
            )
        arr = np.frombuffer(data[pos:], dtype=be, count=n).astype(dtype)
    else:
        tokens = data[pos:].split()
        if len(tokens) < n:
            raise ValueError(
                f"{path}: VTK payload truncated ({len(tokens)} values < {n})"
            )
        arr = np.array(tokens[:n], dtype=dtype)
    return MedicalImage(
        array=np.ascontiguousarray(arr.reshape(nz, ny, nx)),
        spacing=spacing,
        origin=origin,
    )


def write(image: MedicalImage, path: str) -> None:
    if not np.allclose(image.direction, np.eye(3)):
        raise ValueError(
            f"{path}: VTK structured points cannot carry a direction matrix"
        )
    arr = coerce_for_write(image.array, _VTK_NAMES)
    nz, ny, nx = arr.shape
    sx, sy, sz = image.spacing
    ox, oy, oz = image.origin
    header = (
        "# vtk DataFile Version 3.0\n"
        "lungmask_tpu\n"
        "BINARY\n"
        "DATASET STRUCTURED_POINTS\n"
        f"DIMENSIONS {nx} {ny} {nz}\n"
        f"SPACING {sx} {sy} {sz}\n"
        f"ORIGIN {ox} {oy} {oz}\n"
        f"POINT_DATA {arr.size}\n"
        f"SCALARS scalars {_VTK_NAMES[arr.dtype]} 1\n"
        "LOOKUP_TABLE default\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(arr.astype(arr.dtype.newbyteorder(">")).tobytes())
