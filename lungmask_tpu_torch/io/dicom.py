"""Minimal-dependency DICOM reader/writer for CT series (a copy of
``lungmask_tpu.io.dicom``; ``tqdm`` is optional).

Replaces the reference's pydicom header scanning + SimpleITK series decoding
(lungmask/utils.py:132-230) with a self-contained parser.

Supported transfer syntaxes: Implicit VR Little Endian (1.2.840.10008.1.2),
Explicit VR Little Endian (1.2.840.10008.1.2.1), Deflated Explicit VR Little
Endian (1.2.840.10008.1.2.1.99 — the post-meta dataset is raw-deflate
compressed, PS3.5 A.5), Explicit VR Big Endian (1.2.840.10008.1.2.2, retired
but still emitted by legacy archives — every tag, length, numeric value and
pixel word is byte-swapped), RLE Lossless (1.2.840.10008.1.2.5), JPEG
Lossless process 14 (1.2.840.10008.1.2.4.57 and .70), JPEG-LS
lossless/near-lossless (1.2.840.10008.1.2.4.80/.81), and JPEG 2000
(1.2.840.10008.1.2.4.90 always; .91 when the stream is reversible 5/3 —
HTJ2K .201/.202/.203 via the native HT cleanup-pass decoder —
irreversible 9/7 is rejected with a lossy-HU error), and lossy sequential-DCT
JPEG (1.2.840.10008.1.2.4.50 baseline 8-bit / .51 extended 12-bit, decoded
with a logged HU-accuracy warning; the libjpeg-islow-exact decoder lives in
csrc/dicom_codecs.cpp) — compressed frames decode through the native codec
core (io/codecs.py, csrc/jpeg2000.cpp). Remaining syntaxes raise a clear
error.

The reader exposes tags under ``"gggg|eeee"`` lowercase-hex keys (the
SimpleITK key format the reference CLI's metadata propagation relies on,
lungmask/__main__.py:129-141).

The writer emits Explicit VR LE secondary-capture-style CT slices — enough to
round-trip through this reader and through common DICOM tooling; it is used
for mask output and for synthesizing test fixtures (mirroring the recipe the
reference preserves in its tests/test_utils.py:18-56).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from lungmask_tpu_torch.logger import logger

try:
    from tqdm import tqdm
except ImportError:  # progress bars are optional

    def tqdm(iterable, **_kwargs):
        return iterable


IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
DEFLATED_EXPLICIT_VR_LE = "1.2.840.10008.1.2.1.99"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"  # retired (2006) but still in archives
# Compressed transfer syntaxes — single source of truth in io/codecs.py.
from lungmask_tpu_torch.io.codecs import (  # noqa: E402
    JPEG_2000,
    JPEG_2000_LOSSLESS,
    JPEG_BASELINE,
    JPEG_EXTENDED,
    JPEG_LOSSLESS_P14,
    JPEG_LOSSLESS_SV1,
    JPEG_LS_LOSSLESS,
    JPEG_LS_NEAR_LOSSLESS,
    RLE_LOSSLESS,
)
_ENCAPSULATED = {
    RLE_LOSSLESS,
    JPEG_BASELINE,   # lossy sequential DCT: decoded with an HU-accuracy
    JPEG_EXTENDED,   # warning (the reference decodes these via GDCM silently)
    JPEG_LOSSLESS_P14,
    JPEG_LOSSLESS_SV1,
    JPEG_LS_LOSSLESS,
    JPEG_LS_NEAR_LOSSLESS,
    JPEG_2000_LOSSLESS,
    JPEG_2000,  # decodable when the stream is reversible 5/3; the decoder
    # rejects irreversible 9/7 streams with a clear lossy-HU error
}
CT_STORAGE_UID = "1.2.840.10008.5.1.4.1.1.2"

# Part-15 High-Throughput JPEG 2000 (ITU-T T.814). Decoded natively: the
# HT cleanup-pass block coder lives in csrc/jpeg2000.cpp (HTDec) behind
# codecs.j2k_decode; blocks carrying SigProp/MagRef refinement passes are
# refused with a clear error rather than decoded lossily (docs/HTJ2K.md).
HTJ2K_LOSSLESS = "1.2.840.10008.1.2.4.201"
HTJ2K_LOSSLESS_RPCL = "1.2.840.10008.1.2.4.202"
HTJ2K = "1.2.840.10008.1.2.4.203"  # lossy permitted
_HTJ2K_SYNTAXES = {HTJ2K_LOSSLESS, HTJ2K_LOSSLESS_RPCL, HTJ2K}
_ENCAPSULATED |= _HTJ2K_SYNTAXES

# VRs whose explicit encoding uses a 2-byte reserved field + 4-byte length.
_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR", b"UT", b"UN"}

# Every VR code defined by PS3.5 — used to sniff explicit-vs-implicit encoding
# when a file carries no file-meta header.
_KNOWN_VRS = _LONG_VRS | {
    b"AE", b"AS", b"AT", b"CS", b"DA", b"DS", b"DT", b"FL", b"FD", b"IS",
    b"LO", b"LT", b"PN", b"SH", b"SL", b"SS", b"ST", b"TM", b"UI", b"UL",
    b"US",
}

_TAG_PIXEL_DATA = (0x7FE0, 0x0010)
_TAG_ITEM = (0xFFFE, 0xE000)
_TAG_ITEM_DELIM = (0xFFFE, 0xE00D)
_TAG_SEQ_DELIM = (0xFFFE, 0xE0DD)


def tag_key(group: int, elem: int) -> str:
    return f"{group:04x}|{elem:04x}"


@dataclass
class DicomFile:
    """Parsed single DICOM file: string-ified tags + optional pixel array."""

    path: str
    tags: Dict[str, str]
    pixels: Optional[np.ndarray] = None  # (rows, cols), rescaled to HU if CT

    def get(self, key: str, default: str = "") -> str:
        return self.tags.get(key, default)

    @property
    def image_type(self) -> List[str]:
        return [s.strip() for s in self.get("0008|0008").split("\\") if s.strip()]

    @property
    def study_uid(self) -> str:
        return self.get("0020|000d").strip()

    @property
    def series_uid(self) -> str:
        return self.get("0020|000e").strip()

    @property
    def position(self) -> Optional[Tuple[float, float, float]]:
        raw = self.get("0020|0032").strip()
        if not raw:
            return None
        parts = raw.split("\\")
        if len(parts) != 3:
            return None
        try:
            return tuple(float(p) for p in parts)
        except ValueError:
            # Malformed IPP must not crash the z-sort of a whole series
            # (scan_directory sorts on this property); treat as absent.
            return None


class DicomError(Exception):
    pass


def _decode_pixels(
    tags: Dict[str, str], raw: bytes, big_endian: bool = False
) -> np.ndarray:
    """Native pixel data → int16/int32 array; (rows, cols) for single-frame
    files, (frames, rows, cols) for multi-frame (Enhanced CT stores the whole
    volume in one file — the reference reads those through
    ``sitk.ImageFileReader``, lungmask/utils.py:247-249)."""
    rows = int(tags.get("0028|0010", "0"))
    cols = int(tags.get("0028|0011", "0"))
    n_frames = int(tags.get("0028|0008", "1") or 1)
    return _pixel_rules(tags, raw, None, rows, cols, n_frames, big_endian)


def _pixel_rules(
    tags: Dict[str, str],
    raw: Optional[bytes],
    samples: Optional[np.ndarray],
    rows: int,
    cols: int,
    n_frames: int,
    big_endian: bool = False,
) -> np.ndarray:
    """Photometric/sign/packed-bit/rescale rules shared by the native path
    (``raw`` bytes) and the compressed path (already-decoded ``samples`` cells,
    reinterpreted zero-copy instead of round-tripping through bytes)."""
    bits_alloc = int(tags.get("0028|0100", "16"))
    bits_stored = int(tags.get("0028|0101", str(bits_alloc)) or bits_alloc)
    high_bit = int(tags.get("0028|0102", str(bits_stored - 1)) or (bits_stored - 1))
    pixel_rep = int(tags.get("0028|0103", "0") or 0)
    spp = int(tags.get("0028|0002", "1") or 1)
    photometric = tags.get("0028|0004", "MONOCHROME2").strip().upper()
    if spp != 1:
        raise DicomError(f"SamplesPerPixel={spp} not supported")
    if photometric not in ("", "MONOCHROME2"):
        # MONOCHROME1 (inverted grayscale) and color spaces would silently
        # corrupt HU values if decoded as-is; refuse loudly instead.
        raise DicomError(
            f"PhotometricInterpretation={photometric} not supported "
            "(only MONOCHROME2)"
        )
    if bits_alloc == 16:
        dtype = np.int16 if pixel_rep == 1 else np.uint16
    elif bits_alloc == 8:
        dtype = np.int8 if pixel_rep == 1 else np.uint8
    else:
        raise DicomError(f"BitsAllocated={bits_alloc} not supported")
    n = rows * cols * n_frames
    if samples is not None:
        if samples.dtype.itemsize != bits_alloc // 8:
            raise DicomError(
                f"decoded sample width {samples.dtype.itemsize} does not "
                f"match BitsAllocated={bits_alloc}"
            )
        arr = samples.reshape(-1).view(dtype)
    else:
        stored = np.dtype(dtype).newbyteorder(">") if big_endian else dtype
        arr = np.frombuffer(raw[: n * (bits_alloc // 8)], dtype=stored)
        if big_endian:
            arr = arr.astype(dtype)  # swap to native for the shift/rescale ops
    if arr.size < n:
        raise DicomError(
            f"pixel data truncated: {arr.size} samples for "
            f"{n_frames}x{rows}x{cols}"
        )
    shape = (n_frames, rows, cols) if n_frames > 1 else (rows, cols)
    arr = arr.reshape(shape)
    if bits_stored < bits_alloc:
        # Packed representation: the value occupies bits
        # [high_bit-bits_stored+1, high_bit]; align to the top of the cell and
        # shift back down — an arithmetic shift for signed data performs the
        # required sign extension, a logical one zeroes the overlay bits.
        up = bits_alloc - 1 - high_bit
        down = bits_alloc - bits_stored
        arr = ((arr.astype(dtype) << up).astype(dtype) >> down).astype(dtype)
    slope = float(tags.get("0028|1053", "1") or 1)
    intercept = float(tags.get("0028|1052", "0") or 0)
    if slope != 1 or intercept != 0:
        out = arr.astype(np.float64) * slope + intercept
        # CT HU fits int16/int32
        if float(out.min()) >= -(2**15) and float(out.max()) < 2**15:
            return out.astype(np.int16)
        return out.astype(np.int32)
    return arr.astype(np.int16) if dtype == np.uint16 and arr.max() < 2**15 else arr


_NUMERIC_VRS = {
    b"US": ("H", 2),
    b"SS": ("h", 2),
    b"UL": ("I", 4),
    b"SL": ("i", 4),
    b"FL": ("f", 4),
    b"FD": ("d", 8),
}


def _stringify(vr: bytes, value: bytes, bo: str = "<") -> str:
    if vr in _NUMERIC_VRS:
        fmt, width = _NUMERIC_VRS[vr]
        if len(value) % width:
            return ""
        vals = [
            struct.unpack_from(bo + fmt, value, i)[0]
            for i in range(0, len(value), width)
        ]
        return "\\".join(str(v) for v in vals)
    if vr in (b"OB", b"OW", b"UN", b"OF", b"OL", b"OD"):
        return ""  # binary payloads are not exposed as string metadata
    try:
        s = value.decode("latin-1")
    except Exception:
        return ""
    return s.rstrip("\x00").rstrip()


def _read_element(buf: memoryview, pos: int, explicit: bool, bo: str = "<"):
    """Returns (group, elem, vr, value_offset, value_length, next_pos).
    ``bo`` is the dataset byte order ("<" LE, ">" for Explicit VR Big
    Endian, where tags and lengths are byte-swapped too, PS3.5 7.3)."""
    if pos + 8 > len(buf):
        raise DicomError("truncated element header")
    group, elem = struct.unpack_from(bo + "HH", buf, pos)
    if (group, elem) in (_TAG_ITEM, _TAG_ITEM_DELIM, _TAG_SEQ_DELIM):
        (length,) = struct.unpack_from(bo + "I", buf, pos + 4)
        return group, elem, b"  ", pos + 8, length, pos + 8
    if explicit:
        vr = bytes(buf[pos + 4 : pos + 6])
        if vr in _LONG_VRS:
            (length,) = struct.unpack_from(bo + "I", buf, pos + 8)
            return group, elem, vr, pos + 12, length, pos + 12
        (length,) = struct.unpack_from(bo + "H", buf, pos + 6)
        return group, elem, vr, pos + 8, length, pos + 8
    (length,) = struct.unpack_from(bo + "I", buf, pos + 4)
    return group, elem, b"UN", pos + 8, length, pos + 8


def _skip_undefined_sequence(
    buf: memoryview, pos: int, explicit: bool, bo: str = "<"
) -> int:
    """Skip an undefined-length sequence body, returning the position after its
    sequence delimiter."""
    depth = 1
    while depth > 0:
        if pos + 8 > len(buf):
            raise DicomError("unterminated sequence")
        group, elem = struct.unpack_from(bo + "HH", buf, pos)
        (length,) = struct.unpack_from(bo + "I", buf, pos + 4)
        pos += 8
        if (group, elem) == _TAG_SEQ_DELIM:
            depth -= 1
        elif (group, elem) == _TAG_ITEM:
            if length != 0xFFFFFFFF:
                pos += length
            # undefined-length item: keep scanning, item delimiter handled below
        elif (group, elem) == _TAG_ITEM_DELIM:
            pass
        else:
            # nested element inside an undefined-length item
            pos -= 8
            g, e, vr, voff, vlen, after = _read_element(buf, pos, explicit, bo)
            if vlen == 0xFFFFFFFF:
                pos = _skip_undefined_sequence(buf, after, explicit, bo)
            else:
                pos = voff + vlen
    return pos


def read_file(
    path: str, stop_before_pixels: bool = False
) -> DicomFile:
    """Parse one DICOM file (implicit/explicit VR little endian).

    Error contract: any malformed input — truncation, corrupted tag/length
    fields, bad element values — raises ``DicomError`` (byte-level failures
    from struct/decode internals are translated), so callers scanning
    untrusted directories can catch one type. Mirrors the reference's
    skip-bad-files tolerance (utils.py:187-189) at the per-file level.
    """
    try:
        if stop_before_pixels:
            # Header-only scans read a prefix first: headers precede
            # (7FE0,0010), so directory scans need not read pixel bytes at
            # all (they are re-read only at volume assembly).
            try:
                return _read_file_impl(path, True, _prefix=_HEADER_SCAN_BYTES)
            except _PrefixInsufficient:
                return _read_file_impl(path, True)
        return _read_file_impl(path, False)
    except DicomError:
        raise
    except (struct.error, IndexError, KeyError, OverflowError,
            UnicodeDecodeError, EOFError, ValueError) as e:
        # ValueError covers int()/float()/reshape on corrupt tag values and
        # codec rejections — without it, one such file broke the documented
        # one-type contract (and aborted directory scans that catch DicomError).
        raise DicomError(f"{path}: malformed DICOM stream ({e})") from e


# Initial read size for header-only scans. CT headers are a few KB; private
# payloads (icon images etc.) occasionally push the pixel-data tag further,
# which the _PrefixInsufficient fallback covers with one full re-read.
_HEADER_SCAN_BYTES = 1 << 18


class _PrefixInsufficient(Exception):
    """Internal: a header-prefix read did not provably reach pixel data."""


def _read_file_impl(
    path: str, stop_before_pixels: bool, _prefix: Optional[int] = None
) -> DicomFile:
    with open(path, "rb") as f:
        data = f.read() if _prefix is None else f.read(_prefix)
    complete = _prefix is None or len(data) < _prefix
    if complete:
        return _parse_dataset(path, data, stop_before_pixels, complete=True)
    try:
        return _parse_dataset(path, data, stop_before_pixels, complete=False)
    except _PrefixInsufficient:
        raise
    except Exception:
        # Any failure on a truncated prefix may be the truncation's fault
        # (the parser cannot always tell) — retry full-size; genuine errors
        # re-raise identically from the complete parse.
        raise _PrefixInsufficient() from None


def _parse_dataset(
    path: str, data: bytes, stop_before_pixels: bool, complete: bool
) -> DicomFile:
    buf = memoryview(data)
    pos = 0
    if len(data) > 132 and data[128:132] == b"DICM":
        pos = 132
    elif len(data) >= 8:
        # Headerless (force=True-style) — require a plausible group number.
        group = struct.unpack_from("<H", buf, 0)[0]
        if group not in (0x0002, 0x0008, 0x0010, 0x0018, 0x0020, 0x0028):
            raise DicomError(f"{path}: not a DICOM file")
    else:
        raise DicomError(f"{path}: not a DICOM file")

    tags: Dict[str, str] = {}
    transfer_syntax = ""
    explicit = True

    # File meta group (0002) is always explicit LE.
    while pos + 8 <= len(buf):
        group = struct.unpack_from("<H", buf, pos)[0]
        if group != 0x0002:
            break
        g, e, vr, voff, vlen, _ = _read_element(buf, pos, explicit=True)
        value = bytes(buf[voff : voff + vlen])
        tags[tag_key(g, e)] = _stringify(vr, value)
        if (g, e) == (0x0002, 0x0010):
            transfer_syntax = value.decode("ascii").rstrip("\x00").strip()
        pos = voff + vlen

    if not transfer_syntax:
        # No file-meta transfer syntax (headerless / force-read files): sniff
        # the first dataset element — a valid VR code in bytes 4-6 means
        # explicit VR, anything else is implicit VR LE.
        if pos + 6 <= len(buf) and bytes(buf[pos + 4 : pos + 6]) in _KNOWN_VRS:
            transfer_syntax = EXPLICIT_VR_LE
        else:
            transfer_syntax = IMPLICIT_VR_LE

    bo = "<"
    if transfer_syntax == IMPLICIT_VR_LE:
        explicit = False
    elif transfer_syntax == DEFLATED_EXPLICIT_VR_LE:
        # PS3.10 A.5: everything after the file-meta group is one raw-deflate
        # stream (no zlib header) holding an Explicit VR LE dataset.
        try:
            inflated = zlib.decompressobj(-15).decompress(bytes(buf[pos:]))
        except zlib.error as e:
            raise DicomError(f"{path}: corrupt deflated dataset ({e})") from e
        buf = memoryview(inflated)
        pos = 0
        explicit = True
    elif transfer_syntax == EXPLICIT_VR_BE:
        explicit = True
        bo = ">"
    elif transfer_syntax == EXPLICIT_VR_LE or transfer_syntax in _ENCAPSULATED:
        explicit = True  # encapsulated syntaxes encode the dataset explicit LE
    else:
        raise DicomError(
            f"{path}: transfer syntax {transfer_syntax} not supported "
            "(uncompressed little/big-endian, deflated, RLE, JPEG Lossless, "
            "JPEG-LS, or JPEG 2000 lossless)"
        )

    pixels = None
    saw_pixel_data = False
    while pos + 8 <= len(buf):
        g, e, vr, voff, vlen, _ = _read_element(buf, pos, explicit, bo)
        if (g, e) == _TAG_PIXEL_DATA:
            saw_pixel_data = True
            if stop_before_pixels:
                break
            if vlen == 0xFFFFFFFF:
                if transfer_syntax not in _ENCAPSULATED:
                    raise DicomError(
                        f"{path}: undefined-length pixel data in an "
                        "uncompressed transfer syntax"
                    )
                fragments, frag_offsets, bot, pos = _read_fragments(buf, voff)
                pixels = _decode_encapsulated(
                    tags, fragments, frag_offsets, bot, transfer_syntax, path
                )
                continue
            if transfer_syntax in _ENCAPSULATED:
                # A defined-length (7FE0,0010) in a compressed syntax is
                # non-conformant; decoding the codestream as raw samples
                # would yield silently wrong HU values — refuse loudly
                # (mirror of the undefined-length-in-uncompressed guard).
                raise DicomError(
                    f"{path}: defined-length pixel data in compressed "
                    f"transfer syntax {transfer_syntax}"
                )
            pixels = _decode_pixels(
                tags, bytes(buf[voff : voff + vlen]), big_endian=(bo == ">")
            )
            pos = voff + vlen
            continue
        if vlen == 0xFFFFFFFF:
            pos = _skip_undefined_sequence(buf, voff, explicit, bo)
            continue
        if vr == b"UN" and (g, e) in _VR_FOR_TAG:
            vr = _VR_FOR_TAG[(g, e)]  # implicit VR: resolve known tags
        if vr != b"SQ":  # defined-length sequences are skipped as opaque
            tags[tag_key(g, e)] = _stringify(
                vr, bytes(buf[voff : voff + vlen]), bo
            )
        pos = voff + vlen

    if not complete and not saw_pixel_data:
        # A truncated prefix ends the loop SILENTLY mid-element; tags past
        # the cut would be dropped without error. Only reaching (7FE0,0010)
        # proves the prefix held the whole header.
        raise _PrefixInsufficient()
    return DicomFile(path=path, tags=tags, pixels=pixels)


def _read_fragments(buf: memoryview, pos: int):
    """Parse encapsulated pixel-data items: Basic Offset Table then one or
    more fragments, ending at the sequence delimiter. Returns
    (fragments, fragment_offsets, bot, position after the delimiter) where
    ``fragment_offsets`` are each fragment's item-header byte offset measured
    from the end of the BOT item — the coordinate system the BOT's per-frame
    offsets use (needed to group fragments into frames for multi-frame files)."""
    fragments: List[bytes] = []
    frag_offsets: List[int] = []
    bot: List[int] = []
    first = True
    base = None
    while pos + 8 <= len(buf):
        group, elem = struct.unpack_from("<HH", buf, pos)
        (length,) = struct.unpack_from("<I", buf, pos + 4)
        pos += 8
        if (group, elem) == _TAG_SEQ_DELIM:
            return fragments, frag_offsets, bot, pos
        if (group, elem) != _TAG_ITEM:
            raise DicomError("malformed encapsulated pixel data")
        if first:
            first = False
            if length and length % 4 == 0:
                bot = list(struct.unpack_from(f"<{length // 4}I", buf, pos))
            base = pos + length
        else:
            frag_offsets.append(pos - 8 - base)
            fragments.append(bytes(buf[pos : pos + length]))
        pos += length
    raise DicomError("unterminated encapsulated pixel data")


def _group_frames(
    fragments: List[bytes],
    frag_offsets: List[int],
    bot: List[int],
    n_frames: int,
    path: str,
) -> List[bytes]:
    """Group pixel-data fragments into per-frame byte strings (PS3.5 A.4):
    single frame → all fragments; otherwise one fragment per frame (the
    common layout), or the Basic Offset Table maps frame starts."""
    if n_frames == 1:
        return [b"".join(fragments)]
    if len(fragments) == n_frames:
        return fragments
    if bot and len(bot) == n_frames:
        try:
            starts = [frag_offsets.index(off) for off in bot]
        except ValueError:
            raise DicomError(
                f"{path}: Basic Offset Table offsets do not align with "
                "fragment boundaries"
            )
        ends = starts[1:] + [len(fragments)]
        return [b"".join(fragments[s:e]) for s, e in zip(starts, ends)]
    raise DicomError(
        f"{path}: cannot split {len(fragments)} fragments into {n_frames} "
        "frames (no usable Basic Offset Table)"
    )


def _decode_encapsulated(
    tags: Dict[str, str],
    fragments: List[bytes],
    frag_offsets: List[int],
    bot: List[int],
    transfer_syntax: str,
    path: str,
) -> np.ndarray:
    from lungmask_tpu_torch.io import codecs

    n_frames = int(tags.get("0028|0008", "1") or 1)
    rows = int(tags.get("0028|0010", "0"))
    cols = int(tags.get("0028|0011", "0"))
    bits_alloc = int(tags.get("0028|0100", "16"))
    frames = _group_frames(fragments, frag_offsets, bot, n_frames, path)

    if transfer_syntax in (JPEG_BASELINE, JPEG_EXTENDED):
        logger.warning(
            f"{path}: lossy JPEG transfer syntax {transfer_syntax} — decoded "
            "values approximate the originally acquired HU"
        )
    if transfer_syntax == HTJ2K:
        # .203 permits lossy HT coding; the lossless .201/.202 syntaxes
        # carry the lossless guarantee in the UID itself.
        logger.warning(
            f"{path}: transfer syntax {transfer_syntax} permits "
            "lossy HTJ2K — decoded values may approximate HU"
        )

    decoded_frames = []
    for data in frames:
        if transfer_syntax == RLE_LOSSLESS:
            samples = codecs.rle_decode_frame(data, rows * cols, bits_alloc // 8)
        elif transfer_syntax in (JPEG_LS_LOSSLESS, JPEG_LS_NEAR_LOSSLESS):
            decoded, near = codecs.jpegls_decode(data, with_near=True)
            if near > 0:
                # .81 streams can be truly lossless (NEAR=0) or near-lossless;
                # only the stream itself says which — warn like the lossy DCT
                # syntaxes when HU values are approximate.
                logger.warning(
                    f"{path}: near-lossless JPEG-LS (NEAR={near}) — decoded "
                    f"values may deviate from acquired HU by up to ±{near}"
                )
            if decoded.shape != (rows, cols):
                raise DicomError(
                    f"{path}: JPEG-LS frame is {decoded.shape}, header says "
                    f"({rows}, {cols})"
                )
            samples = decoded if bits_alloc == 16 else decoded.astype(np.uint8)
        elif transfer_syntax in (JPEG_BASELINE, JPEG_EXTENDED):
            decoded = codecs.jpegdct_decode(data)
            if decoded.shape != (rows, cols):
                raise DicomError(
                    f"{path}: JPEG frame is {decoded.shape}, header says "
                    f"({rows}, {cols})"
                )
            samples = decoded  # uint8 (8-bit) or uint16 (12-bit)
        elif (transfer_syntax in (JPEG_2000_LOSSLESS, JPEG_2000)
              or transfer_syntax in _HTJ2K_SYNTAXES):
            decoded = codecs.j2k_decode(data)  # int32, signedness applied
            if decoded.shape != (rows, cols):
                raise DicomError(
                    f"{path}: JPEG 2000 frame is {decoded.shape}, header says "
                    f"({rows}, {cols})"
                )
            pixel_rep = int(tags.get("0028|0103", "0") or 0)
            if bits_alloc == 16:
                samples = decoded.astype(np.int16 if pixel_rep else np.uint16)
            else:
                samples = decoded.astype(np.int8 if pixel_rep else np.uint8)
        else:  # JPEG Lossless (process 14 / SV1)
            decoded = codecs.jpegll_decode(data)
            if decoded.shape != (rows, cols):
                raise DicomError(
                    f"{path}: JPEG frame is {decoded.shape}, header says "
                    f"({rows}, {cols})"
                )
            samples = decoded if bits_alloc == 16 else decoded.astype(np.uint8)
        decoded_frames.append(np.ascontiguousarray(np.asarray(samples)))
    stacked = (
        np.stack(decoded_frames) if len(decoded_frames) > 1 else decoded_frames[0]
    )
    # Shared photometric/sign/packed-bit/rescale rules, zero-copy reinterpret.
    return _pixel_rules(tags, None, stacked, rows, cols, n_frames)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

_VR_FOR_TAG = {
    (0x0008, 0x0008): b"CS", (0x0008, 0x0016): b"UI", (0x0008, 0x0018): b"UI",
    (0x0008, 0x0020): b"DA", (0x0008, 0x0030): b"TM", (0x0008, 0x0050): b"SH",
    (0x0008, 0x0060): b"CS", (0x0008, 0x0090): b"PN", (0x0008, 0x1030): b"LO",
    (0x0008, 0x103E): b"LO",
    (0x0010, 0x0010): b"PN", (0x0010, 0x0020): b"LO", (0x0010, 0x0030): b"DA",
    (0x0010, 0x0040): b"CS",
    (0x0018, 0x0050): b"DS", (0x0018, 0x0088): b"DS", (0x0018, 0x5100): b"CS",
    (0x0020, 0x000D): b"UI", (0x0020, 0x000E): b"UI", (0x0020, 0x0010): b"SH",
    (0x0020, 0x0013): b"IS", (0x0020, 0x0032): b"DS", (0x0020, 0x0037): b"DS",
    (0x0028, 0x0002): b"US", (0x0028, 0x0004): b"CS", (0x0028, 0x0008): b"IS",
    (0x0028, 0x0010): b"US",
    (0x0028, 0x0011): b"US", (0x0028, 0x0030): b"DS", (0x0028, 0x0100): b"US",
    (0x0028, 0x0101): b"US", (0x0028, 0x0102): b"US", (0x0028, 0x0103): b"US",
    (0x0028, 0x1050): b"DS", (0x0028, 0x1051): b"DS", (0x0028, 0x1052): b"DS",
    (0x0028, 0x1053): b"DS",
}

_UID_ROOT = "1.2.826.0.1.3680043.10.1464"  # generated instance UIDs
_uid_counter = [0]


def generate_uid() -> str:
    _uid_counter[0] += 1
    return f"{_UID_ROOT}.{os.getpid()}.{_uid_counter[0]}"


def _encode_element(
    group: int, elem: int, vr: bytes, value: bytes, bo: str = "<"
) -> bytes:
    if len(value) % 2:
        # PS3.5 6.2: UI (and binary VRs) pad with NUL, text VRs with space.
        value += b"\x00" if vr in (b"UI", b"OB", b"UN") else b" "
    head = struct.pack(bo + "HH", group, elem)
    if vr in _LONG_VRS:
        return head + vr + b"\x00\x00" + struct.pack(bo + "I", len(value)) + value
    return head + vr + struct.pack(bo + "H", len(value)) + value


def _us(v: int, bo: str = "<") -> bytes:
    return struct.pack(bo + "H", v)


def write_slice(
    path: str,
    pixels: np.ndarray,
    *,
    tags: Optional[Dict[Tuple[int, int], str]] = None,
    series_uid: Optional[str] = None,
    study_uid: Optional[str] = None,
    sop_uid: Optional[str] = None,
    position=(0.0, 0.0, 0.0),
    orientation=(1, 0, 0, 0, 1, 0),
    spacing=(1.0, 1.0),
    slice_thickness: float = 1.0,
    image_type: str = "ORIGINAL\\PRIMARY\\AXIAL",
    rescale: Tuple[float, float] = (1.0, 0.0),
    transfer_syntax: str = EXPLICIT_VR_LE,
) -> None:
    """Write one int16 CT slice — or, for a 3-D ``pixels`` array, a
    multi-frame (Enhanced-CT-style) file with NumberOfFrames and
    SpacingBetweenSlices. ``transfer_syntax`` may be Explicit VR LE
    (default), Deflated Explicit VR LE, Explicit VR Big Endian, RLE Lossless,
    or JPEG Lossless SV1 — the non-default forms are used to synthesize
    round-trip test fixtures."""
    pixels = np.ascontiguousarray(pixels.astype(np.int16))
    if pixels.ndim == 3:
        n_frames, rows, cols = pixels.shape
        frames_arr = pixels
    else:
        n_frames = 1
        rows, cols = pixels.shape
        frames_arr = pixels[None]
    sop_uid = sop_uid or generate_uid()
    series_uid = series_uid or generate_uid()
    study_uid = study_uid or generate_uid()

    if transfer_syntax not in (
        EXPLICIT_VR_LE, DEFLATED_EXPLICIT_VR_LE, EXPLICIT_VR_BE,
        RLE_LOSSLESS, JPEG_LOSSLESS_SV1, JPEG_LS_LOSSLESS,
        JPEG_2000_LOSSLESS, JPEG_2000, JPEG_BASELINE, JPEG_EXTENDED,
        HTJ2K_LOSSLESS,
    ):
        raise DicomError(f"writer does not support {transfer_syntax}")
    bo = ">" if transfer_syntax == EXPLICIT_VR_BE else "<"
    # Lossy DCT fixtures store unsigned prec-bit samples; everything else is
    # the usual signed 16-bit CT representation.
    if transfer_syntax == JPEG_BASELINE:
        bits_alloc, bits_stored, pixel_rep = 8, 8, 0
    elif transfer_syntax == JPEG_EXTENDED:
        bits_alloc, bits_stored, pixel_rep = 16, 12, 0
    else:
        bits_alloc, bits_stored, pixel_rep = 16, 16, 1
    if pixel_rep == 0 and (pixels.min() < 0 or
                           pixels.max() >= (1 << bits_stored)):
        raise DicomError(
            f"lossy JPEG fixture samples must fit unsigned {bits_stored}-bit"
        )

    meta = b""
    meta_elems = [
        ((0x0002, 0x0001), b"OB", b"\x00\x01"),
        ((0x0002, 0x0002), b"UI", CT_STORAGE_UID.encode()),
        ((0x0002, 0x0003), b"UI", sop_uid.encode()),
        ((0x0002, 0x0010), b"UI", transfer_syntax.encode()),
        ((0x0002, 0x0012), b"UI", f"{_UID_ROOT}.1".encode()),
    ]
    for (g, e), vr, v in meta_elems:
        meta += _encode_element(g, e, vr, v)
    group_len = _encode_element(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta)))

    slope, intercept = rescale
    body_tags: Dict[Tuple[int, int], bytes] = {
        (0x0008, 0x0008): image_type.encode(),
        (0x0008, 0x0016): CT_STORAGE_UID.encode(),
        (0x0008, 0x0018): sop_uid.encode(),
        (0x0008, 0x0060): b"CT",
        (0x0018, 0x0050): f"{slice_thickness}".encode(),
        (0x0020, 0x000D): study_uid.encode(),
        (0x0020, 0x000E): series_uid.encode(),
        (0x0020, 0x0032): "\\".join(str(float(p)) for p in position).encode(),
        (0x0020, 0x0037): "\\".join(str(float(o)) for o in orientation).encode(),
        (0x0028, 0x0002): _us(1, bo),
        (0x0028, 0x0004): b"MONOCHROME2",
        (0x0028, 0x0010): _us(rows, bo),
        (0x0028, 0x0011): _us(cols, bo),
        (0x0028, 0x0030): f"{spacing[0]}\\{spacing[1]}".encode(),
        (0x0028, 0x0100): _us(bits_alloc, bo),
        (0x0028, 0x0101): _us(bits_stored, bo),
        (0x0028, 0x0102): _us(bits_stored - 1, bo),
        (0x0028, 0x0103): _us(pixel_rep, bo),
        (0x0028, 0x1052): f"{intercept}".encode(),
        (0x0028, 0x1053): f"{slope}".encode(),
    }
    if n_frames > 1:
        body_tags[(0x0028, 0x0008)] = str(n_frames).encode()
        body_tags[(0x0018, 0x0088)] = f"{slice_thickness}".encode()
    for (g, e), v in (tags or {}).items():
        body_tags[(g, e)] = v

    body = b""
    for (g, e) in sorted(body_tags):
        vr = _VR_FOR_TAG.get((g, e), b"LO")
        val = body_tags[(g, e)]
        if isinstance(val, str):
            val = _us(int(val), bo) if vr == b"US" else val.encode()
        body += _encode_element(g, e, vr, val, bo)
    if transfer_syntax in (EXPLICIT_VR_LE, DEFLATED_EXPLICIT_VR_LE):
        body += _encode_element(0x7FE0, 0x0010, b"OW", pixels.tobytes())
    elif transfer_syntax == EXPLICIT_VR_BE:
        body += _encode_element(
            0x7FE0, 0x0010, b"OW", pixels.astype(">i2").tobytes(), bo
        )
    else:
        from lungmask_tpu_torch.io import codecs

        encoded = []
        for fr in frames_arr:
            if transfer_syntax == RLE_LOSSLESS:
                frame = codecs.rle_encode_frame(fr.view(np.uint16))
            elif transfer_syntax == JPEG_BASELINE:
                frame = codecs.jpegdct_encode(
                    fr.view(np.uint16).astype(np.uint8), precision=8
                )
            elif transfer_syntax == JPEG_EXTENDED:
                frame = codecs.jpegdct_encode(fr.view(np.uint16), precision=12)
            elif transfer_syntax == JPEG_LS_LOSSLESS:
                frame = codecs.jpegls_encode(fr.view(np.uint16), precision=16)
            elif transfer_syntax in (JPEG_2000_LOSSLESS, JPEG_2000):
                frame = codecs.j2k_encode(fr.view(np.uint16))
            elif transfer_syntax == HTJ2K_LOSSLESS:
                frame = codecs.htj2k_encode(fr.view(np.uint16))
            else:
                frame = codecs.jpegll_encode(fr.view(np.uint16), precision=16)
            if len(frame) % 2:
                frame += b"\x00"
            encoded.append(frame)
        # OB, undefined length: Basic Offset Table item (populated for
        # multi-frame: per-frame offsets from the end of the BOT item,
        # PS3.5 A.4) + one fragment per frame.
        body += struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00"
        body += struct.pack("<I", 0xFFFFFFFF)
        if n_frames > 1:
            offsets, off = [], 0
            for frame in encoded:
                offsets.append(off)
                off += 8 + len(frame)
            bot_payload = struct.pack(f"<{n_frames}I", *offsets)
            body += struct.pack("<HHI", *_TAG_ITEM, len(bot_payload)) + bot_payload
        else:
            body += struct.pack("<HHI", *_TAG_ITEM, 0)
        for frame in encoded:
            body += struct.pack("<HHI", *_TAG_ITEM, len(frame)) + frame
        body += struct.pack("<HHI", *_TAG_SEQ_DELIM, 0)

    if transfer_syntax == DEFLATED_EXPLICIT_VR_LE:
        comp = zlib.compressobj(6, zlib.DEFLATED, -15)
        body = comp.compress(body) + comp.flush()

    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + group_len + meta + body)


def scan_directory(
    path: str,
    primary: bool = True,
    original: bool = True,
    disable_tqdm: bool = False,
) -> List[List[DicomFile]]:
    """Recursive scan → filtered, deduped, series-grouped, z-sorted header list.

    Reference semantics (lungmask/utils.py:132-213):
    * skip files named DICOMDIR; non-DICOM files are logged and skipped,
    * require ImageType present; filter PRIMARY/ORIGINAL per flags; always
      exclude LOCALIZER,
    * dedupe by (StudyUID, SeriesUID, ImagePositionPatient),
    * group into volumes by SeriesUID (sorted), slices sorted by the z
      component of ImagePositionPatient.
    """
    all_files: List[str] = []
    for d, _, fnames in os.walk(path):
        all_files.extend(os.path.join(d, f) for f in fnames)

    headers: List[DicomFile] = []
    seen = set()
    for fname in tqdm(sorted(all_files), disable=disable_tqdm, desc="DICOM scan"):
        base = os.path.splitext(os.path.basename(fname))[0]
        if base == "DICOMDIR":
            continue
        try:
            hdr = read_file(fname, stop_before_pixels=True)
        except Exception as e:
            logger.error(f"Unexpected error: {e}")
            logger.warning(f"Doesn't seem to be DICOM, will be skipped: {fname}")
            continue
        itype = hdr.image_type
        if not itype:
            continue
        if primary and "PRIMARY" not in itype:
            continue
        if original and "ORIGINAL" not in itype:
            continue
        if "LOCALIZER" in itype:
            continue
        key = (hdr.study_uid, hdr.series_uid, hdr.get("0020|0032"))
        if key in seen:
            continue
        seen.add(key)
        headers.append(hdr)

    series: Dict[str, List[DicomFile]] = {}
    for h in headers:
        series.setdefault(h.series_uid, []).append(h)

    volumes = []
    for uid in sorted(series):
        slices = series[uid]
        slices.sort(key=lambda h: (h.position or (0, 0, 0))[2])
        volumes.append(slices)
    n = len(volumes)
    logger.info(
        f"There {'is' if n == 1 else 'are'} {n} volume{'' if n == 1 else 's'} in the study"
    )
    return volumes
