"""NRRD reader/writer — further file-format parity with the reference's
ITK-based I/O (lungmask/utils.py:247-249). Single-file NRRD
and detached headers (.nhdr with a ``data file`` field, optional ``byte
skip``), raw or gzip encodings, little-endian.

Geometry: NRRD ``space`` is declared as left-posterior-superior and the
``space directions`` rows are the (x, y, z) image-axis direction vectors
scaled by spacing — matching this framework's LPS convention directly.
"""

from __future__ import annotations

import gzip
import re
import zlib
from typing import Dict

import numpy as np

from lungmask_tpu_torch.io.image import MedicalImage, coerce_for_write

_NRRD_TYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8, "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16, "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32, "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32, "uint32_t": np.uint32,
    "float": np.float32, "double": np.float64,
}
_TYPE_NAMES = {
    np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
    np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
    np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
}


def _parse_vector(s: str):
    return [float(v) for v in s.strip().lstrip("(").rstrip(")").split(",")]


def read(path: str) -> MedicalImage:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"NRRD"):
        raise ValueError(f"{path}: not a NRRD file")
    # Header = lines until the first blank line. Scan line-by-line (accepting
    # LF or CRLF endings) rather than searching the whole buffer — a byte
    # pattern like b"\n\n" can occur inside the binary payload of a
    # CRLF-terminated header and must not be mistaken for the terminator.
    header_lines = []
    pos = 0
    payload_start = None
    while pos < len(data):
        nl = data.find(b"\n", pos)
        if nl == -1:
            header_lines.append(data[pos:].rstrip(b"\r").decode("ascii", "replace"))
            pos = len(data)
            break
        line = data[pos:nl].rstrip(b"\r")
        if line == b"":
            payload_start = nl + 1
            break
        header_lines.append(line.decode("ascii", errors="replace"))
        pos = nl + 1
    if payload_start is None:
        # Detached headers (.nhdr) may end without a blank line — the payload
        # comes from the `data file` field then. A single-file NRRD missing
        # its terminator still fails below with a truncated-payload error.
        payload_start = len(data)
    header_lines = header_lines[1:]  # drop the NRRD magic line
    fields: Dict[str, str] = {}
    for line in header_lines:
        if not line or line.startswith("#"):
            continue
        if ":=" in line:
            k, v = line.split(":=", 1)
        elif ":" in line:
            k, v = line.split(":", 1)
        else:
            continue
        fields[k.strip().lower()] = v.strip()
    payload = data[payload_start:]

    datafile = fields.get("data file") or fields.get("datafile")
    if datafile:
        if any(ch in datafile for ch in "% "):  # printf-style multi-file list
            raise ValueError(f"{path}: multi-file NRRD data lists not supported")
        import os

        with open(os.path.join(os.path.dirname(path) or ".", datafile), "rb") as df:
            payload = df.read()
        # NRRD applies `line skip` before `byte skip`; ignoring it would
        # silently shift every voxel by the skipped text's byte length.
        line_skip = int(fields.get("line skip", fields.get("lineskip", "0")) or 0)
        for _ in range(line_skip):
            nl = payload.find(b"\n")
            if nl == -1:
                raise ValueError(f"{path}: line skip runs past the data file")
            payload = payload[nl + 1 :]
        byte_skip = int(fields.get("byte skip", fields.get("byteskip", "0")) or 0)
        if byte_skip > 0:
            payload = payload[byte_skip:]
        # byte skip: -1 (raw only) means "take the payload from the tail";
        # handled after the dtype/size fields are known, below.

    if int(fields.get("dimension", "3")) != 3:
        raise ValueError(f"{path}: only 3-D NRRD supported")
    sizes = [int(v) for v in fields["sizes"].split()]
    dtype = _NRRD_TYPES.get(fields["type"])
    if dtype is None:
        raise ValueError(f"{path}: unsupported NRRD type {fields['type']!r}")
    if fields.get("endian", "little") == "big":
        raise ValueError(f"{path}: big-endian NRRD not supported")
    encoding = fields.get("encoding", "raw").lower()
    if encoding in ("gzip", "gz"):
        payload = zlib.decompress(payload, zlib.MAX_WBITS | 32)
    elif encoding != "raw":
        raise ValueError(f"{path}: unsupported NRRD encoding {encoding!r}")

    nx, ny, nz = sizes
    need = nx * ny * nz * np.dtype(dtype).itemsize
    if datafile and encoding == "raw" and byte_skip == -1:
        payload = payload[-need:]
    if len(payload) < need:
        raise ValueError(f"{path}: NRRD payload truncated ({len(payload)} < {need})")
    arr = np.frombuffer(payload, dtype=dtype, count=nx * ny * nz).reshape(nz, ny, nx)

    direction = np.eye(3)
    spacing = [1.0, 1.0, 1.0]
    if "space directions" in fields:
        # Vectors are whitespace-separated "(a,b,c)" groups; any amount of
        # whitespace (spaces, tabs) between them is spec-valid.
        vecs = [
            _parse_vector(v)
            for v in re.findall(r"\(([^)]*)\)", fields["space directions"])
        ]
        if len(vecs) != 3:
            raise ValueError(
                f"{path}: expected 3 space-direction vectors, got {len(vecs)}"
            )
        m = np.asarray(vecs, dtype=np.float64).T  # columns = image axes
        space = fields.get("space", "left-posterior-superior").lower()
        flip = _lps_flip(space)
        m = flip @ m
        spacing = list(np.linalg.norm(m, axis=0))
        direction = m / np.asarray(spacing)[None, :]
    elif "spacings" in fields:
        # teem/pynrrd-style per-axis spacings (no orientation information).
        sp = [float(v) for v in fields["spacings"].split()[:3]]
        spacing = [abs(s) if np.isfinite(s) and s != 0 else 1.0 for s in sp]
    origin = [0.0, 0.0, 0.0]
    if "space origin" in fields:
        origin = list(
            _lps_flip(fields.get("space", "left-posterior-superior").lower())
            @ np.asarray(_parse_vector(fields["space origin"]))
        )
    elif "axis mins" in fields or "axismins" in fields:
        mins = (fields.get("axis mins") or fields["axismins"]).split()[:3]
        origin = [float(v) for v in mins]
    return MedicalImage(
        array=np.ascontiguousarray(arr),
        spacing=tuple(spacing),
        origin=tuple(origin),
        direction=direction,
    )


def _lps_flip(space: str) -> np.ndarray:
    if space in ("left-posterior-superior", "lps"):
        return np.eye(3)
    if space in ("right-anterior-superior", "ras"):
        return np.diag([-1.0, -1.0, 1.0])
    if space in ("left-anterior-superior", "las"):
        return np.diag([1.0, -1.0, 1.0])
    raise ValueError(f"unsupported NRRD space {space!r}")


def write(image: MedicalImage, path: str, compressed: bool = True) -> None:
    """Write a single-file ``.nrrd`` or, when ``path`` ends in ``.nhdr``, a
    detached header + ``<base>.raw[.gz]`` data file (the layout ITK's
    NrrdImageIO produces for ``.nhdr`` outputs — reference writes via
    ``sitk.ImageFileWriter``, lungmask/__main__.py:119-125)."""
    import os

    detached = path.lower().endswith(".nhdr")
    arr = coerce_for_write(image.array, _TYPE_NAMES)
    nz, ny, nx = arr.shape
    d = np.asarray(image.direction) * np.asarray(image.spacing)[None, :]
    sd = " ".join(
        "(" + ",".join(repr(float(v)) for v in d[:, j]) + ")" for j in range(3)
    )
    so = "(" + ",".join(repr(float(v)) for v in image.origin) + ")"
    lines = [
        "NRRD0004",
        "# Complete NRRD file format specification at:",
        "# http://teem.sourceforge.net/nrrd/format.html",
        f"type: {_TYPE_NAMES[arr.dtype]}",
        "dimension: 3",
        "space: left-posterior-superior",
        f"sizes: {nx} {ny} {nz}",
        f"space directions: {sd}",
        "kinds: domain domain domain",
        "endian: little",
        f"encoding: {'gzip' if compressed else 'raw'}",
        f"space origin: {so}",
    ]
    payload = arr.tobytes()
    if compressed:
        payload = gzip.compress(payload)
    if detached:
        data_name = os.path.basename(path)[: -len(".nhdr")] + (
            ".raw.gz" if compressed else ".raw"
        )
        lines.append(f"data file: {data_name}")
        with open(os.path.join(os.path.dirname(path) or ".", data_name), "wb") as f:
            f.write(payload)
        # A detached header carries no payload after the fields; the trailing
        # blank line is still required by the format.
        with open(path, "wb") as f:
            f.write(("\n".join(lines) + "\n\n").encode("ascii"))
        return
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("ascii") + payload)
