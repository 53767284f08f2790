"""Self-contained NIfTI reader/writer (.nii / .nii.gz).

Replaces the reference's SimpleITK/ITK NIfTI path
(lungmask/utils.py:244-253, __main__.py:119-144) for the
formats the test-suite and CLI exercise. Reads NIfTI-1 and NIfTI-2 in either
byte order (ITK's ImageFileReader accepts all four); writes little-endian
NIfTI-1. Geometry: NIfTI affines are RAS; conversion to/from this framework's
LPS direction/origin negates the x/y rows.
"""

from __future__ import annotations

import contextlib
import gzip
import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lungmask_tpu_torch.io.image import MedicalImage, coerce_for_write

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_LPS_FROM_RAS = np.diag([-1.0, -1.0, 1.0])


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _quaternion_to_rotation(b: float, c: float, d: float, qfac: float) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    r = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
            [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
            [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
        ]
    )
    r[:, 2] *= qfac
    return r


def _parse_header(path: str, data: bytes):
    """Parse a NIfTI-1 or NIfTI-2 header in either byte order into the common
    field set the assembly below needs. Returns a dict plus the endian prefix
    ("<" or ">") so voxel decode can byteswap to native order."""
    if len(data) < 348:
        raise ValueError(f"{path}: truncated NIfTI header")
    (hdr_le,) = struct.unpack_from("<i", data, 0)
    (hdr_be,) = struct.unpack_from(">i", data, 0)
    if hdr_le in (348, 540):
        bo, sizeof_hdr = "<", hdr_le
    elif hdr_be in (348, 540):
        bo, sizeof_hdr = ">", hdr_be
    else:
        raise ValueError(f"{path}: not a NIfTI-1 or NIfTI-2 file")

    if sizeof_hdr == 348:  # NIfTI-1
        magic = data[344:348]
        if magic not in (b"n+1\x00", b"ni1\x00"):
            raise ValueError(f"{path}: bad NIfTI-1 magic {magic!r}")
        dim = struct.unpack_from(f"{bo}8h", data, 40)
        datatype, _bitpix = struct.unpack_from(f"{bo}2h", data, 70)
        pixdim = struct.unpack_from(f"{bo}8f", data, 76)
        (vox_offset,) = struct.unpack_from(f"{bo}f", data, 108)
        scl_slope, scl_inter = struct.unpack_from(f"{bo}2f", data, 112)
        qform_code, sform_code = struct.unpack_from(f"{bo}2h", data, 252)
        quatern = struct.unpack_from(f"{bo}3f", data, 256)
        qoffset = struct.unpack_from(f"{bo}3f", data, 268)
        srow = struct.unpack_from(f"{bo}12f", data, 280)
        detached = magic == b"ni1\x00"
    else:  # NIfTI-2 (sizeof_hdr 540, magic right after it at offset 4)
        if len(data) < 540:
            raise ValueError(f"{path}: truncated NIfTI-2 header")
        magic = data[4:8]
        if magic not in (b"n+2\x00", b"ni2\x00") or data[8:12] != b"\r\n\x1a\n":
            raise ValueError(f"{path}: bad NIfTI-2 magic {data[4:12]!r}")
        datatype, _bitpix = struct.unpack_from(f"{bo}2h", data, 12)
        dim = struct.unpack_from(f"{bo}8q", data, 16)
        pixdim = struct.unpack_from(f"{bo}8d", data, 104)
        (vox_offset,) = struct.unpack_from(f"{bo}q", data, 168)
        scl_slope, scl_inter = struct.unpack_from(f"{bo}2d", data, 176)
        qform_code, sform_code = struct.unpack_from(f"{bo}2i", data, 344)
        quatern = struct.unpack_from(f"{bo}3d", data, 352)
        qoffset = struct.unpack_from(f"{bo}3d", data, 376)
        srow = struct.unpack_from(f"{bo}12d", data, 400)
        detached = magic == b"ni2\x00"
    return {
        "bo": bo,
        "dim": dim,
        "datatype": datatype,
        "pixdim": pixdim,
        "vox_offset": int(vox_offset),
        "scl_slope": float(scl_slope),
        "scl_inter": float(scl_inter),
        "qform_code": qform_code,
        "sform_code": sform_code,
        "quatern": quatern,
        "qoffset": qoffset,
        "srow": np.array(srow, dtype=np.float64).reshape(3, 4),
        "detached": detached,
    }


def read(path: str) -> MedicalImage:
    if path.endswith(".gz"):
        # gzip must decompress the whole stream anyway — keep the one-shot
        # read; voxel decode below works off the in-memory buffer.
        with _open(path, "rb") as f:
            data = f.read()
    else:
        # Uncompressed: read only the header here and stream the voxels
        # straight into a writable owned array (np.fromfile) — one memcpy
        # for the whole file instead of read()->bytes->writable copy (the
        # serving lane decodes one ~100 MB volume per request; the double
        # pass was its second-largest host cost).
        with open(path, "rb") as f:
            data = f.read(544)  # covers NIfTI-1 (348) and NIfTI-2 (540)
    return _decode(path, data, from_file=True)


def read_bytes(data, name: str = "<bytes>") -> MedicalImage:
    """Decode a whole in-memory .nii / .nii.gz stream (serving-lane fast
    path: the upload already sits in RAM, so spooling it to a temp file just
    to ``read()`` it back would add two full passes over ~100 MB).

    ``data`` may be ``bytes``, ``bytearray`` or ``memoryview``; a writable
    buffer (the serve lane hands a ``bytearray``) is wrapped zero-copy —
    the returned array aliases it. Detached .hdr/.img pairs are rejected
    (two-file formats have no single-buffer representation).
    """
    buf = memoryview(data)
    if len(buf) >= 2 and buf[0] == 0x1F and buf[1] == 0x8B:
        buf = memoryview(gzip.decompress(buf))
    return _decode(name, buf, from_file=False)


def _decode(path: str, data, from_file: bool) -> MedicalImage:
    """Shared header→array→geometry decode. ``from_file``: voxels are
    streamed from ``path`` with np.fromfile (``data`` is just the header
    prefix); otherwise ``data`` is the complete stream."""
    h = _parse_header(path, bytes(data[:544]) if not from_file else data)

    dim = h["dim"]
    ndim = dim[0]
    nx, ny, nz = dim[1], max(dim[2], 1), max(dim[3], 1)
    if ndim > 3 and any(d > 1 for d in dim[4 : 1 + ndim]):
        raise ValueError(f"{path}: >3-D NIfTI not supported")
    if h["datatype"] not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {h['datatype']}")
    pixdim = h["pixdim"]
    scl_slope, scl_inter = h["scl_slope"], h["scl_inter"]

    dtype = np.dtype(_DTYPES[h["datatype"]]).newbyteorder(h["bo"])
    count = nx * ny * nz
    if h["detached"]:
        if not from_file:
            raise ValueError(
                f"{path}: detached .hdr/.img pair cannot be decoded from a "
                "single in-memory buffer"
            )
        # Detached header/data pair: voxels live in the sibling .img file.
        base = path[:-7] if path.endswith(".hdr.gz") else path.rsplit(".", 1)[0]
        img_path = base + ".img"
        if not os.path.exists(img_path):
            img_path += ".gz"
        with _open(img_path, "rb") as f:
            data = f.read()
        # For detached pairs, vox_offset is the byte offset INTO the .img
        # file (NIfTI spec) — keep it, unlike the single-file case where it
        # offsets into this same buffer past the header.
    if h["detached"] or not from_file or path.endswith(".gz"):
        if not from_file and len(data) < h["vox_offset"] + count * dtype.itemsize:
            raise ValueError(f"{path}: truncated NIfTI voxel data")
        arr = np.frombuffer(
            data, dtype=dtype, count=count, offset=h["vox_offset"]
        ).reshape(nz, ny, nx)
    else:
        with open(path, "rb") as f:
            f.seek(h["vox_offset"])
            arr = np.fromfile(f, dtype=dtype, count=count)
        if arr.size != count:
            raise ValueError(f"{path}: truncated NIfTI voxel data")
        arr = arr.reshape(nz, ny, nx)
    if not arr.dtype.isnative:
        arr = arr.astype(arr.dtype.newbyteorder("="))
    # NIfTI-1: scl_slope == 0 means "no scaling" (intercept ignored too);
    # NaN slope/intercept likewise disable scaling (nibabel semantics).
    if (
        np.isfinite(scl_slope)
        and np.isfinite(scl_inter)
        and scl_slope != 0.0
        and (scl_slope != 1.0 or scl_inter != 0.0)
    ):
        arr = arr.astype(np.float32) * scl_slope + scl_inter

    if h["sform_code"] > 0:
        affine = h["srow"]
    elif h["qform_code"] > 0:
        qfac = -1.0 if pixdim[0] == -1.0 else 1.0
        rot = _quaternion_to_rotation(*h["quatern"], qfac)
        affine = np.concatenate(
            [rot * np.asarray(pixdim[1:4])[None, :], np.asarray(h["qoffset"])[:, None]],
            axis=1,
        )
    else:
        affine = np.concatenate(
            [np.diag(pixdim[1:4]), np.zeros((3, 1))], axis=1
        )

    lps = _LPS_FROM_RAS @ affine
    m = lps[:, :3]
    spacing = np.linalg.norm(m, axis=0)
    spacing[spacing == 0] = 1.0
    direction = m / spacing[None, :]
    return MedicalImage(
        array=np.ascontiguousarray(arr),
        spacing=tuple(spacing),
        origin=tuple(lps[:, 3]),
        direction=direction,
    )


def write(image: MedicalImage, path: str) -> None:
    """Write ``image`` as NIfTI-1: ``.nii`` plain, ``.nii.gz`` as one gzip
    member deflated at level 9 in slabs on :func:`_deflate_workers` threads
    (:func:`_write_gz`). Both write the buffers of :func:`_stream` without
    joining them."""
    bufs = _stream(image)
    with open(path, "wb") as f:
        if path.endswith(".gz"):
            _write_gz(f, bufs, _deflate_workers())
        else:
            for b in bufs:
                f.write(b)


def encode(image: MedicalImage) -> bytes:
    """Image → uncompressed NIfTI-1 stream bytes (what :func:`write` puts on
    disk). The serving lane returns this directly as the HTTP response body
    instead of writing a temp file and reading it back."""
    return b"".join(_stream(image))


def _stream(image: MedicalImage) -> list:
    """The NIfTI-1 stream as buffers: the 348-byte header, the 4 bytes of
    extension flag up to ``vox_offset`` 352, and a byte view of the voxels
    (no copy of a contiguous array of a NIfTI dtype)."""
    arr = coerce_for_write(image.array, _CODES)
    nz, ny, nx = arr.shape

    d = np.asarray(image.direction, dtype=np.float64)
    s = np.asarray(image.spacing, dtype=np.float64)
    o = np.asarray(image.origin, dtype=np.float64)
    affine_lps = np.concatenate([d * s[None, :], o[:, None]], axis=1)
    srow = _LPS_FROM_RAS @ affine_lps

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<2h", hdr, 70, _CODES[arr.dtype], arr.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *s, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform=0, sform=1
    struct.pack_into("<12f", hdr, 280, *srow.reshape(-1))
    hdr[344:348] = b"n+1\x00"

    return [memoryview(hdr), memoryview(bytes(4)), memoryview(arr.reshape(-1).view(np.uint8))]


# -- parallel gzip -------------------------------------------------------------
#
# pigz's layout: the stream is cut into fixed slabs, each deflated on its own
# as raw deflate at level 9 with the 32 KiB before it as its dictionary, so
# matches reach back across the cut as in one pass. Every slab but the last
# ends in a sync flush (byte-aligned, no final block), the last in a finish,
# so the slabs concatenate into one deflate stream inside one gzip member.
# The bytes depend on the slab size, never on how many threads ran.

_SLAB = 1 << 20
_WINDOW = 1 << 15
_LEVEL = 9
# 10-byte gzip header: magic, deflate, no flags, mtime 0, XFL 2 (the
# slowest level), OS 255 (unknown), as Python's gzip writes it without a name.
_GZ_HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x02\xff"

_counts_lock = threading.Lock()
_counts = {"gzip_writes": 0, "parallel_writes": 0, "slabs": 0, "max_workers": 0}


def deflate_counts() -> dict:
    """Process-wide counts of ``.nii.gz`` writes since the process started:
    ``gzip_writes``, ``parallel_writes`` (slabs deflated on more than one
    thread), ``slabs`` deflated, and ``max_workers``, the largest pool used."""
    with _counts_lock:
        return dict(_counts)


def _deflate_workers() -> int:
    """Deflate threads for this process: its CPUs less two (the cohort's
    loader and main threads), at least 1 and at most 8."""
    return min(8, max(1, len(os.sched_getaffinity(0)) - 2))


def _pieces(bufs, start: int, stop: int) -> list:
    """Views of the bytes ``[start, stop)`` of the concatenation of ``bufs``."""
    out, pos = [], 0
    for b in bufs:
        lo, hi = max(start - pos, 0), min(stop - pos, len(b))
        if lo < hi:
            out.append(b[lo:hi])
        pos += len(b)
    return out


def _deflate_slab(bufs, start: int, stop: int, last: bool) -> bytes:
    window = b"".join(_pieces(bufs, max(start - _WINDOW, 0), start))  # empty for the first
    c = zlib.compressobj(_LEVEL, zlib.DEFLATED, -zlib.MAX_WBITS, zlib.DEF_MEM_LEVEL,
                         zlib.Z_DEFAULT_STRATEGY, window)
    out = [c.compress(p) for p in _pieces(bufs, start, stop)]
    out.append(c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH))
    return b"".join(out)


def _write_gz(f, bufs, workers: int) -> None:
    """Write ``bufs``' concatenation to ``f`` as one gzip member, its slabs
    deflated on ``workers`` threads (inline when one slab or one worker)."""
    size = sum(len(b) for b in bufs)
    cuts = list(range(0, size, _SLAB)) + [size]
    spans = [(a, b, b == size) for a, b in zip(cuts, cuts[1:])]
    pool = min(workers, len(spans))
    f.write(_GZ_HEADER)
    with contextlib.ExitStack() as stack:
        if pool > 1:
            ex = stack.enter_context(ThreadPoolExecutor(pool, thread_name_prefix="nifti-deflate"))
            slabs = ex.map(lambda span: _deflate_slab(bufs, *span), spans)  # all submitted now
        else:
            slabs = (_deflate_slab(bufs, *span) for span in spans)
        crc = 0
        for b in bufs:  # zlib releases the GIL: the CRC overlaps the pool's deflates
            crc = zlib.crc32(b, crc)
        for slab in slabs:
            f.write(slab)
    f.write(struct.pack("<II", crc, size & 0xFFFFFFFF))
    with _counts_lock:
        _counts["gzip_writes"] += 1
        _counts["parallel_writes"] += int(pool > 1)
        _counts["slabs"] += len(spans)
        _counts["max_workers"] = max(_counts["max_workers"], pool)
