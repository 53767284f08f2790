"""Compressed DICOM pixel codecs: RLE Lossless and JPEG Lossless (process 14).

The reference reads compressed series through ITK/GDCM
(lungmask/utils.py:215-222); here the decoders are native C++
(csrc/dicom_codecs.cpp, ctypes-loaded, built on first use) with a pure-Python
RLE fallback so RLE series decode even without a compiler. An RLE and a
JPEG-lossless *encoder* live here too — used by the DICOM writer to emit
compressed fixtures and by tests to round-trip the decoders.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import List, Optional

import numpy as np


RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"  # lossy 8-bit sequential DCT
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"  # lossy 12-bit sequential DCT
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR_LOSSLESS = "1.2.840.10008.1.2.4.81"
JPEG_2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEG_2000 = "1.2.840.10008.1.2.4.91"  # may carry reversible 5/3 streams too

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> str:
    """Where :func:`get_lib` builds the codec core: the repository-root
    sources ``csrc/dicom_codecs.cpp`` and ``csrc/jpeg2000.cpp`` (shared with
    the JAX package) compiled into the port's ``_build/``."""
    from lungmask_tpu_torch.ops.native import BUILD_DIR

    return os.path.join(BUILD_DIR, "libdicomcodecs.so")


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    from lungmask_tpu_torch.ops.native import CSRC_DIR, build_or_load_library

    srcs = [os.path.join(CSRC_DIR, name) for name in ("dicom_codecs.cpp", "jpeg2000.cpp")]
    lib = build_or_load_library(srcs, library_path())
    if lib is None:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.lm_rle_decode.restype = ctypes.c_int32
    lib.lm_rle_decode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64,
                                  ctypes.c_int32]
    lib.lm_jpegll_decode.restype = ctypes.c_int32
    lib.lm_jpegll_decode.argtypes = [u8p, ctypes.c_int64, u16p, ctypes.c_int64,
                                     i32p, i32p, i32p]
    lib.lm_jpegls_decode.restype = ctypes.c_int32
    lib.lm_jpegls_decode.argtypes = [u8p, ctypes.c_int64, u16p, ctypes.c_int64,
                                     i32p, i32p, i32p, i32p]
    lib.lm_jpegdct_decode.restype = ctypes.c_int32
    lib.lm_jpegdct_decode.argtypes = [u8p, ctypes.c_int64, u16p,
                                      ctypes.c_int64, i32p, i32p, i32p]
    lib.lm_j2k_decode.restype = ctypes.c_int32
    lib.lm_j2k_decode.argtypes = [u8p, ctypes.c_int64, i32p, ctypes.c_int64,
                                  i32p, i32p, i32p, i32p]
    _LIB = lib
    return _LIB


# ---------------------------------------------------------------------------
# RLE Lossless (PS3.5 annex G)
# ---------------------------------------------------------------------------


def _packbits_decode_py(src: bytes, out_len: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < out_len:
        c = src[i]
        i += 1
        if c < 128:  # literal run of c+1 bytes
            out += src[i : i + c + 1]
            i += c + 1
        elif c != 128:  # replicate next byte 257-c times
            out += src[i : i + 1] * (257 - c)
            i += 1
    if len(out) != out_len:
        raise ValueError("RLE segment decoded to wrong length")
    return bytes(out)


def _packbits_encode(data: bytes) -> bytes:
    """PackBits encode one byte plane (literal/replicate runs, max 128)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        # find a run of >=3 identical bytes (2 would not compress)
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out.append(257 - run)
            out.append(data[i])
            i += run
            continue
        # literal stretch until the next >=3 run (or 128 bytes)
        j = i
        while j < n and j - i < 128:
            r = 1
            while j + r < n and r < 3 and data[j + r] == data[j]:
                r += 1
            if r >= 3:
                break
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def rle_encode_frame(pixels: np.ndarray) -> bytes:
    """Encode one frame as a DICOM RLE frame (byte planes, MSB first)."""
    pixels = np.ascontiguousarray(pixels)
    itemsize = pixels.dtype.itemsize
    if itemsize not in (1, 2):
        raise ValueError("RLE: only 8/16-bit samples supported")
    raw = pixels.astype(pixels.dtype.newbyteorder("<"), copy=False).tobytes()
    planes = []
    for s in range(itemsize):  # s=0 → MSB plane
        byte_ix = itemsize - 1 - s  # little-endian byte index
        plane = raw[byte_ix::itemsize]
        enc = _packbits_encode(plane)
        if len(enc) % 2:
            enc += b"\x00"
        planes.append(enc)
    header = struct.pack("<I", len(planes))
    offsets = []
    off = 64
    for p in planes:
        offsets.append(off)
        off += len(p)
    header += b"".join(struct.pack("<I", o) for o in offsets)
    header += b"\x00" * (64 - len(header))
    return header + b"".join(planes)


def rle_decode_frame(data: bytes, n_pixels: int, bytes_per_sample: int) -> np.ndarray:
    """Decode one RLE frame → uint8/uint16 array of n_pixels samples."""
    dtype = np.uint8 if bytes_per_sample == 1 else np.uint16
    lib = get_lib()
    if lib is not None:
        src = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(n_pixels, dtype=dtype)
        rc = lib.lm_rle_decode(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(data),
            out.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_pixels,
            bytes_per_sample,
        )
        if rc == 0:
            return out
        raise ValueError(f"RLE decode failed (native rc={rc})")
    # Pure-Python fallback
    if len(data) < 64:
        raise ValueError("RLE frame too short")
    n_seg = struct.unpack_from("<I", data, 0)[0]
    if n_seg != bytes_per_sample:
        raise ValueError(f"RLE: {n_seg} segments for {bytes_per_sample}-byte samples")
    offsets = list(struct.unpack_from(f"<{n_seg}I", data, 4)) + [len(data)]
    out = np.zeros(n_pixels, dtype=dtype)
    for s in range(n_seg):
        plane = np.frombuffer(
            _packbits_decode_py(data[offsets[s] : offsets[s + 1]], n_pixels),
            dtype=np.uint8,
        )
        out |= plane.astype(dtype) << (8 * (n_seg - 1 - s))
    return out


# ---------------------------------------------------------------------------
# JPEG Lossless (ITU T.81 process 14)
# ---------------------------------------------------------------------------


def jpegll_decode(data: bytes) -> np.ndarray:
    """Decode a single-component JPEG-lossless codestream → uint16 (rows, cols)."""
    lib = get_lib()
    if lib is None:
        raise ValueError(
            "JPEG Lossless decode requires the native codec core "
            "(csrc/dicom_codecs.cpp) and no compiler is available"
        )
    src = np.frombuffer(data, dtype=np.uint8)
    # Parse SOF3 dims up front for the output allocation.
    rows, cols = _peek_sof3_dims(data)
    out = np.empty(rows * cols, dtype=np.uint16)
    r = ctypes.c_int32()
    c = ctypes.c_int32()
    prec = ctypes.c_int32()
    rc = lib.lm_jpegll_decode(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.size,
        ctypes.byref(r),
        ctypes.byref(c),
        ctypes.byref(prec),
    )
    if rc != 0:
        raise ValueError(f"JPEG Lossless decode failed (rc={rc})")
    return out.reshape(r.value, c.value)


def _peek_sof3_dims(data: bytes):
    p = 2
    while p + 4 <= len(data):
        if data[p] != 0xFF:
            raise ValueError("bad JPEG marker stream")
        m = data[p + 1]
        if m in (0xD8,) or 0xD0 <= m <= 0xD7:
            p += 2
            continue
        seg = (data[p + 2] << 8) | data[p + 3]
        if m == 0xC3:
            if p + 9 > len(data):
                raise ValueError("truncated JPEG codestream (SOF3 cut short)")
            rows = (data[p + 5] << 8) | data[p + 6]
            cols = (data[p + 7] << 8) | data[p + 8]
            return rows, cols
        if m in (0xC0, 0xC1, 0xC2):
            raise ValueError("lossy/non-lossless JPEG process not supported")
        p += 2 + seg
    raise ValueError("no SOF3 marker found")


# ---------------------------------------------------------------------------
# JPEG 2000 Part 1 (ITU-T T.800) — from-scratch native decoder, reversible
# (5/3) path only (csrc/jpeg2000.cpp): the DICOM JPEG 2000 Lossless transfer
# syntax (.90) and reversible .91 streams. Validated bit-for-bit against
# OpenJPEG (via Pillow) in tests/test_codecs.py.
# ---------------------------------------------------------------------------

_J2K_ERRORS = {
    -1: "malformed JPEG 2000 codestream",
    -2: "output capacity too small for the declared image size",
    -3: "packet parse error (truncated or corrupt tile data)",
    -4: "EBCOT tier-1 decode error (corrupt code-block segment)",
    -20: "irreversible 9/7 wavelet — a LOSSY JPEG 2000 stream; HU values "
         "would not be exact. Re-export losslessly (5/3 reversible).",
    -21: "multi-component or subsampled image (CT is single-component)",
    -22: "code-block style with selective bypass / reset / termall / "
         "vertically-causal passes",
    -23: "packed packet headers (PPM/PPT)",
    -24: "PCRL/CPRL progression or POC marker",
    -25: "ROI shift (RGN marker)",
    -26: "per-tile or per-component COD/QCD overrides (COC/QCC)",
    -27: "HTJ2K code-block with SigProp/MagRef refinement passes — this "
         "build decodes the HT cleanup pass only; decoding without the "
         "refinement passes would silently truncate HU values",
    -28: "malformed HTJ2K code-block (corrupt cleanup segment)",
}


def _unwrap_jp2(data: bytes) -> bytes:
    """Extract the raw codestream from a JP2 box container (DICOM forbids the
    container, PS3.5 A.4.4, but some exporters embed it anyway)."""
    if data[:4] == b"\xff\x4f\xff\x51":
        return data  # already a raw codestream (SOC + SIZ)
    if len(data) > 12 and data[4:8] == b"jP  ":
        p = 0
        while p + 8 <= len(data):
            (ln,) = struct.unpack(">I", data[p : p + 4])
            btype = data[p + 4 : p + 8]
            if ln == 1:  # extended 64-bit length
                (ln,) = struct.unpack(">Q", data[p + 8 : p + 16])
                body = p + 16
            else:
                body = p + 8
            if btype == b"jp2c":
                end = p + ln if ln else len(data)
                return data[body:end]
            if ln == 0:
                break
            p += ln
    raise ValueError("not a JPEG 2000 codestream (no SOC, no jp2c box)")


def j2k_decode(data: bytes) -> np.ndarray:
    """Decode a JPEG 2000 Part 1 reversible codestream → int32 (rows, cols).

    Signed components come back as true signed sample values; unsigned are
    DC-level-shifted to their natural range, matching GDCM/OpenJPEG output.
    """
    lib = get_lib()
    if lib is None:
        raise ValueError(
            "JPEG 2000 decode requires the native codec core "
            "(csrc/jpeg2000.cpp) and no compiler is available"
        )
    data = _unwrap_jp2(data)
    rows, cols = _peek_siz_dims(data)
    # A corrupt SIZ can declare absurd dimensions; allocating for them is a
    # denial-of-service on untrusted bytes. 2^26 samples (e.g. 8192 x 8192)
    # is far above any CT frame.
    if rows <= 0 or cols <= 0 or (int(rows) * int(cols)) > (1 << 26):
        raise ValueError(
            f"JPEG 2000 decode failed: implausible image size {rows}x{cols}"
        )
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((rows, cols), dtype=np.int32)
    r = ctypes.c_int32()
    c = ctypes.c_int32()
    prec = ctypes.c_int32()
    sgnd = ctypes.c_int32()
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.lm_j2k_decode(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        out.ctypes.data_as(i32p),
        out.size,
        ctypes.byref(r),
        ctypes.byref(c),
        ctypes.byref(prec),
        ctypes.byref(sgnd),
    )
    if rc != 0:
        raise ValueError(
            f"JPEG 2000 decode failed: "
            f"{_J2K_ERRORS.get(rc, f'error {rc}')}"
        )
    return out[: r.value, : c.value]


def j2k_encode(pixels: np.ndarray) -> bytes:
    """Encode (rows, cols) uint8/uint16 samples as a raw JPEG 2000 lossless
    codestream via Pillow/OpenJPEG — fixture/writer encoder only (the decode
    path never needs Pillow)."""
    import io as _io

    from PIL import Image

    px = np.ascontiguousarray(pixels)
    if px.dtype == np.uint8:
        im = Image.fromarray(px)
    else:
        im = Image.frombytes(
            "I;16", (px.shape[1], px.shape[0]), px.astype("<u2").tobytes()
        )
    buf = _io.BytesIO()
    try:
        im.save(buf, "JPEG2000", irreversible=False, no_jp2=True)
    except TypeError:  # older Pillow without no_jp2
        im.save(buf, "JPEG2000", irreversible=False)
    return _unwrap_jp2(buf.getvalue())


def htj2k_encode(pixels: np.ndarray) -> bytes:
    """Encode (rows, cols) integer samples as a lossless HTJ2K codestream
    (cleanup-pass-only HT block coding; see io/htj2k_stream.py)."""
    from lungmask_tpu_torch.io import htj2k_stream

    return htj2k_stream.encode_codestream(pixels)


def _peek_siz_dims(data: bytes):
    """(rows, cols) from the SIZ marker (Xsiz-X0siz etc.)."""
    if len(data) < 42 or data[:2] != b"\xff\x4f":
        raise ValueError("not a JPEG 2000 codestream")
    p = 2
    while p + 4 <= len(data):
        if data[p] != 0xFF:
            raise ValueError("bad JPEG 2000 marker stream")
        m = data[p + 1]
        ln = (data[p + 2] << 8) | data[p + 3]
        if m == 0x51:  # SIZ
            xs, ys, x0, y0 = struct.unpack(">IIII", data[p + 6 : p + 22])
            return ys - y0, xs - x0
        p += 2 + ln
    raise ValueError("no SIZ marker found")


# ---------------------------------------------------------------------------
# JPEG-LS (ITU-T T.87) — from-scratch native decoder (csrc/dicom_codecs.cpp);
# the system CharLS reference library (when present) serves as the fixture
# encoder and the spec oracle in tests.
# ---------------------------------------------------------------------------


def jpegls_decode(data: bytes, with_near: bool = False):
    """Decode a single-component JPEG-LS codestream → uint16 (rows, cols).

    Lossless and near-lossless, LSE presets honored; validated bit-for-bit
    against CharLS in tests/test_codecs.py. ``with_near=True`` also returns
    the stream's NEAR parameter (0 = lossless; N = samples may deviate by up
    to ±N) so callers can surface HU-accuracy warnings."""
    lib = get_lib()
    if lib is None:
        raise ValueError(
            "JPEG-LS decode requires the native codec core "
            "(csrc/dicom_codecs.cpp) and no compiler is available"
        )
    rows, cols = _peek_jpegls_dims(data)
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(rows * cols, dtype=np.uint16)
    r = ctypes.c_int32()
    c = ctypes.c_int32()
    prec = ctypes.c_int32()
    near = ctypes.c_int32()
    rc = lib.lm_jpegls_decode(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.size,
        ctypes.byref(r),
        ctypes.byref(c),
        ctypes.byref(prec),
        ctypes.byref(near),
    )
    if rc != 0:
        raise ValueError(f"JPEG-LS decode failed (rc={rc})")
    decoded = out.reshape(r.value, c.value)
    return (decoded, near.value) if with_near else decoded


def _peek_jpegls_dims(data: bytes):
    p = 2
    while p + 4 <= len(data):
        if data[p] != 0xFF:
            raise ValueError("bad JPEG-LS marker stream")
        m = data[p + 1]
        if m == 0xD8 or 0xD0 <= m <= 0xD7:
            p += 2
            continue
        seg = (data[p + 2] << 8) | data[p + 3]
        if m == 0xF7:  # SOF55
            if p + 9 > len(data):
                raise ValueError("truncated JPEG-LS codestream (SOF55 cut short)")
            rows = (data[p + 5] << 8) | data[p + 6]
            cols = (data[p + 7] << 8) | data[p + 8]
            return rows, cols
        p += 2 + seg
    raise ValueError("no SOF55 marker found")


class _CharlsFrameInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_int32),
        ("component_count", ctypes.c_int32),
    ]


_CHARLS: Optional[ctypes.CDLL] = None
_CHARLS_TRIED = False


def charls_lib() -> Optional[ctypes.CDLL]:
    """The system CharLS reference implementation, if installed (test oracle
    and fixture encoder — the product decode path never needs it)."""
    global _CHARLS, _CHARLS_TRIED
    if _CHARLS is not None or _CHARLS_TRIED:
        return _CHARLS
    _CHARLS_TRIED = True
    for name in ("libcharls.so.2", "libCharLS.so.2", "libcharls.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        # 64-bit handles: the create() functions must not default to c_int.
        lib.charls_jpegls_encoder_create.restype = ctypes.c_void_p
        lib.charls_jpegls_decoder_create.restype = ctypes.c_void_p
        _CHARLS = lib
        return _CHARLS
    return None


def jpegls_encode(pixels: np.ndarray, precision: int = 16, near: int = 0) -> bytes:
    """Encode (rows, cols) unsigned samples as JPEG-LS via system CharLS.

    Fixture/writer encoder only. Raises when CharLS is not installed."""
    lib = charls_lib()
    if lib is None:
        raise ValueError("JPEG-LS encoding requires the system CharLS library")
    # CharLS sample width follows bits_per_sample: 1 byte ≤8 bits, else 2.
    sample_dtype = np.uint8 if precision <= 8 else np.uint16
    px = np.ascontiguousarray(pixels, dtype=sample_dtype)
    rows, cols = px.shape
    if int(px.max(initial=0)) >= (1 << precision):
        raise ValueError("pixel exceeds declared precision")
    enc = ctypes.c_void_p(lib.charls_jpegls_encoder_create())
    try:
        info = _CharlsFrameInfo(cols, rows, precision, 1)
        if lib.charls_jpegls_encoder_set_frame_info(enc, ctypes.byref(info)):
            raise ValueError("CharLS: set_frame_info failed")
        if near and lib.charls_jpegls_encoder_set_near_lossless(enc, near):
            raise ValueError("CharLS: set_near_lossless failed")
        cap = ctypes.c_size_t(px.nbytes * 2 + 1024)
        dest = (ctypes.c_uint8 * cap.value)()
        if lib.charls_jpegls_encoder_set_destination_buffer(enc, dest, cap):
            raise ValueError("CharLS: set_destination failed")
        rc = lib.charls_jpegls_encoder_encode_from_buffer(
            enc, px.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(px.nbytes), 0
        )
        if rc:
            raise ValueError(f"CharLS encode failed (rc={rc})")
        written = ctypes.c_size_t()
        lib.charls_jpegls_encoder_get_bytes_written(enc, ctypes.byref(written))
        return bytes(bytearray(dest)[: written.value])
    finally:
        lib.charls_jpegls_encoder_destroy(enc)


def charls_decode(data: bytes) -> np.ndarray:
    """Decode via system CharLS (spec-oracle for tests). uint16 (rows, cols)."""
    lib = charls_lib()
    if lib is None:
        raise ValueError("CharLS not installed")
    dec = ctypes.c_void_p(lib.charls_jpegls_decoder_create())
    try:
        buf = np.frombuffer(data, dtype=np.uint8)
        if lib.charls_jpegls_decoder_set_source_buffer(
            dec, buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(len(data))
        ):
            raise ValueError("CharLS: set_source failed")
        if lib.charls_jpegls_decoder_read_header(dec):
            raise ValueError("CharLS: read_header failed")
        info = _CharlsFrameInfo()
        lib.charls_jpegls_decoder_get_frame_info(dec, ctypes.byref(info))
        dtype = np.uint8 if info.bits_per_sample <= 8 else np.uint16
        out = np.empty((info.height, info.width), dtype=dtype)
        rc = lib.charls_jpegls_decoder_decode_to_buffer(
            dec, out.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(out.nbytes), 0
        )
        if rc:
            raise ValueError(f"CharLS decode failed (rc={rc})")
        return out.astype(np.uint16)
    finally:
        lib.charls_jpegls_decoder_destroy(dec)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:  # byte stuffing
                    self.out.append(0x00)
                self.acc = 0
                self.nbits = 0

    def flush(self):
        if self.nbits:
            self.acc = (self.acc << (8 - self.nbits)) | ((1 << (8 - self.nbits)) - 1)
            self.out.append(self.acc)
            if self.acc == 0xFF:
                self.out.append(0x00)
            self.acc = 0
            self.nbits = 0


def jpegll_encode(pixels: np.ndarray, precision: int = 16) -> bytes:
    """Encode (rows, cols) unsigned samples as JPEG Lossless SV1 (predictor 1).

    Fixture/round-trip encoder: fixed 5-bit Huffman table over all 17
    magnitude categories (valid canonical table, never all-ones).
    """
    px = np.ascontiguousarray(pixels).astype(np.uint16)
    rows, cols = px.shape
    if px.max() >= (1 << precision):
        raise ValueError("pixel exceeds declared precision")

    # Canonical table: 17 symbols, all code length 5 → codes 0..16.
    counts = [0] * 16
    counts[4] = 17
    values = list(range(17))
    codes = {sym: (i, 5) for i, sym in enumerate(values)}

    def category(diff: int) -> int:
        return 0 if diff == 0 else int(diff if diff > 0 else -diff).bit_length()

    bw = _BitWriter()
    default_pred = 1 << (precision - 1)
    px_i = px.astype(np.int32)
    for r_ in range(rows):
        for c_ in range(cols):
            if r_ == 0 and c_ == 0:
                pred = default_pred
            elif r_ == 0:
                pred = int(px_i[0, c_ - 1])
            elif c_ == 0:
                pred = int(px_i[r_ - 1, 0])
            else:
                pred = int(px_i[r_, c_ - 1])  # SV1: Ra
            diff = (int(px_i[r_, c_]) - pred) & 0xFFFF
            if diff >= 0x8000:
                diff -= 0x10000
            ssss = category(diff)
            if ssss > 16:
                raise ValueError("difference out of range")
            code, ln = codes[min(ssss, 16)]
            bw.put(code, ln)
            if ssss == 16:
                pass  # diff == 32768, no extra bits
            elif ssss:
                v = diff if diff > 0 else diff + (1 << ssss) - 1
                bw.put(v, ssss)
    bw.flush()

    out = bytearray(b"\xff\xd8")  # SOI
    # SOF3
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes([1, 0x11, 0])
    out += b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof
    # DHT (class 0, id 0)
    dht = bytes([0x00]) + bytes(counts) + bytes(values)
    out += b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht
    # SOS: 1 comp, DC table 0, Ss=1 (predictor), Se=0, Ah/Al=0
    sos = bytes([1, 1, 0x00, 1, 0, 0x00])
    out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
    out += bw.out
    out += b"\xff\xd9"  # EOI
    return bytes(out)


# ---------------------------------------------------------------------------
# JPEG sequential DCT (ITU T.81 baseline SOF0 / extended SOF1) — the LOSSY
# DICOM transfer syntaxes .50 (8-bit) and .51 (12-bit). The reference decodes
# them via ITK/GDCM (utils.py:215-222); decoded values approximate the
# original HU (the DICOM layer logs a warning). The native decoder's integer
# IDCT matches libjpeg's islow path bit-for-bit (tests/test_codecs.py
# asserts decode identity vs Pillow on 8-bit streams).
# ---------------------------------------------------------------------------

# Natural (row-major) coefficient indices in zigzag scan order (T.81 fig. 5).
_DCT_ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
]


def jpegdct_decode(data: bytes) -> np.ndarray:
    """Decode a single-component sequential-DCT JPEG → (rows, cols) samples.

    Returns uint8 for 8-bit precision, uint16 for 12-bit.
    """
    lib = get_lib()
    if lib is None:
        raise ValueError(
            "lossy JPEG decode requires the native codec core "
            "(csrc/dicom_codecs.cpp) and no compiler is available"
        )
    rows, cols = _peek_sofdct_dims(data)
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(rows * cols, dtype=np.uint16)
    r = ctypes.c_int32()
    c = ctypes.c_int32()
    prec = ctypes.c_int32()
    rc = lib.lm_jpegdct_decode(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.size,
        ctypes.byref(r),
        ctypes.byref(c),
        ctypes.byref(prec),
    )
    if rc == -12:
        raise ValueError(
            "progressive/hierarchical/arithmetic JPEG is not supported "
            "(sequential DCT only)"
        )
    if rc != 0:
        raise ValueError(f"JPEG sequential-DCT decode failed (rc={rc})")
    arr = out.reshape(r.value, c.value)
    return arr.astype(np.uint8) if prec.value == 8 else arr


def _peek_sofdct_dims(data: bytes):
    p = 2
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise ValueError("not a JPEG codestream")
    while p + 4 <= len(data):
        if data[p] != 0xFF:
            raise ValueError("bad JPEG marker stream")
        m = data[p + 1]
        if m == 0xD8 or 0xD0 <= m <= 0xD7:
            p += 2
            continue
        seg = (data[p + 2] << 8) | data[p + 3]
        if m in (0xC0, 0xC1):
            if p + 9 > len(data):
                raise ValueError("truncated JPEG codestream (SOF cut short)")
            rows = (data[p + 5] << 8) | data[p + 6]
            cols = (data[p + 7] << 8) | data[p + 8]
            if rows == 0 or cols == 0:
                raise ValueError("JPEG SOF declares a zero dimension")
            return rows, cols
        if m in (0xC2, 0xC3):
            raise ValueError("not a sequential-DCT JPEG (progressive/lossless)")
        p += 2 + seg
    raise ValueError("no SOF0/SOF1 marker found")


def jpegdct_encode(
    pixels: np.ndarray, precision: int = 12, quant: int = 1
) -> bytes:
    """Encode (rows, cols) unsigned samples as sequential-DCT JPEG.

    Fixture/round-trip encoder (the framework never writes lossy CT):
    SOF0 for 8-bit, SOF1 for 12-bit; a flat ``quant`` quantization table;
    fixed canonical Huffman tables (DC: 16 symbols at length 5; AC: 242
    symbols at length 9 — never the reserved all-ones code).
    """
    if precision not in (8, 12):
        raise ValueError("precision must be 8 or 12")
    px = np.ascontiguousarray(pixels)
    if px.ndim != 2:
        raise ValueError("expect a 2-D image")
    if px.min() < 0 or px.max() >= (1 << precision):
        raise ValueError("pixel exceeds declared precision")
    rows, cols = px.shape
    center = 1 << (precision - 1)

    # Edge-replicate to 8x8 multiples.
    pr, pc = (-rows) % 8, (-cols) % 8
    padded = np.pad(px.astype(np.float64) - center, ((0, pr), (0, pc)),
                    mode="edge")
    bh, bw = padded.shape[0] // 8, padded.shape[1] // 8

    # Orthonormal 2-D DCT-II basis (T.81 A.3.3 scaling).
    u = np.arange(8)
    D = 0.5 * np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    D[0] /= np.sqrt(2.0)

    qz = np.full(64, int(quant), dtype=np.int32)
    qnat = np.empty(64, np.int32)
    qnat[_DCT_ZIGZAG] = qz

    blocks = padded.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    coefs = np.einsum("ux,bcxy,vy->bcuv", D, blocks, D)
    quantized = np.round(coefs.reshape(bh * bw, 64) /
                         qnat.reshape(8 * 8)).astype(np.int64)

    # Canonical Huffman tables.
    dc_counts = [0] * 16
    dc_counts[4] = 16  # 16 symbols (ssss 0..15) at code length 5
    dc_values = list(range(16))
    dc_codes = {sym: (i, 5) for i, sym in enumerate(dc_values)}
    ac_counts = [0] * 16
    ac_values = [0x00, 0xF0] + [
        (r << 4) | s for r in range(16) for s in range(1, 16)
    ]
    ac_counts[8] = len(ac_values)  # 242 symbols at code length 9
    ac_codes = {sym: (i, 9) for i, sym in enumerate(ac_values)}

    def category(v: int) -> int:
        return 0 if v == 0 else int(abs(v)).bit_length()

    bwr = _BitWriter()
    dc_pred = 0
    for bi in range(bh * bw):
        zz = quantized[bi][_DCT_ZIGZAG]
        diff = int(zz[0]) - dc_pred
        dc_pred = int(zz[0])
        ssss = category(diff)
        if ssss > 15:
            raise ValueError("DC difference out of 15-bit range")
        code, ln = dc_codes[ssss]
        bwr.put(code, ln)
        if ssss:
            v = diff if diff > 0 else diff + (1 << ssss) - 1
            bwr.put(v, ssss)
        run = 0
        for k in range(1, 64):
            v = int(zz[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                c2, l2 = ac_codes[0xF0]
                bwr.put(c2, l2)  # ZRL
                run -= 16
            s = category(v)
            if s > 15:
                raise ValueError("AC coefficient out of 15-bit range")
            c2, l2 = ac_codes[(run << 4) | s]
            bwr.put(c2, l2)
            bits = v if v > 0 else v + (1 << s) - 1
            bwr.put(bits, s)
            run = 0
        if run:
            c2, l2 = ac_codes[0x00]
            bwr.put(c2, l2)  # EOB
    bwr.flush()

    out = bytearray(b"\xff\xd8")  # SOI
    dqt = bytes([0x00]) + bytes(int(q) for q in qz)  # Pq=0 (8-bit), Tq=0
    out += b"\xff\xdb" + struct.pack(">H", len(dqt) + 2) + dqt
    sof_marker = b"\xff\xc0" if precision == 8 else b"\xff\xc1"
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes([1, 0x11, 0])
    out += sof_marker + struct.pack(">H", len(sof) + 2) + sof
    dht = (bytes([0x00]) + bytes(dc_counts) + bytes(dc_values)
           + bytes([0x10]) + bytes(ac_counts) + bytes(ac_values))
    out += b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht
    sos = bytes([1, 1, 0x00, 0, 63, 0x00])  # Ss=0, Se=63, Ah/Al=0
    out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
    out += bwr.out
    out += b"\xff\xd9"  # EOI
    return bytes(out)
