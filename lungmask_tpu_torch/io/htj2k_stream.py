"""HTJ2K (ITU-T T.814) codestream encoder — cleanup-pass-only, lossless.

Produces raw JPEG 2000 codestreams whose code-blocks use the HT block
coder with a single (cleanup) pass, which codes every magnitude exactly:
the result is a conformant, fully lossless HTJ2K stream suitable for the
DICOM HTJ2K transfer syntaxes (1.2.840.10008.1.2.4.201/.202). Layout:
single tile, no wavelet decomposition (levels=0), one quality layer,
64x64 code-blocks, LRCP progression.

The block coder itself is `lungmask_tpu_torch.io.htj2k.CleanupEncoder`, whose
bit-exactness against OpenJPEG's HT decoder is fuzz-pinned
(tests/test_htj2k.py); this module adds the tier-2 wrapper: markers
(SIZ/CAP/COD/QCD), tag trees, and packet headers. The decoder side lives
in csrc/jpeg2000.cpp (HTDec) behind `codecs.j2k_decode`.

Reference surface: the reference reads HTJ2K DICOM through ITK/GDCM
(lungmask/utils.py:215-222).
"""

from __future__ import annotations

import json
import os
import struct
from typing import List, Optional

import numpy as np

from lungmask_tpu_torch.io.htj2k import CleanupEncoder, HTTables, _TABLE_PATH

_GUARD = 2
_CBLK = 64  # code-block side (exponent 6; 64x64 = T.800's 4096-sample cap)

_tables: Optional[HTTables] = None


def _get_tables() -> HTTables:
    global _tables
    if _tables is None:
        with open(_TABLE_PATH) as f:
            _tables = HTTables(json.load(f))
    return _tables


class _HeaderBits:
    """MSB-first bit packer with the packet-header stuffing rule: a byte
    of 0xFF is followed by a 7-bit byte (T.800 B.10.1)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0
        self.limit = 8

    def put(self, bit: int):
        self.acc = (self.acc << 1) | (bit & 1)
        self.n += 1
        if self.n == self.limit:
            # a 7-bit acc (stuffed byte after 0xFF) naturally has a 0 MSB
            self.out.append(self.acc)
            self.limit = 7 if self.out[-1] == 0xFF else 8
            self.acc = 0
            self.n = 0

    def put_bits(self, v: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.put((v >> i) & 1)

    def flush(self) -> bytes:
        if self.n:
            pad = self.limit - self.n
            self.out.append(self.acc << pad)
            self.acc = 0
            self.n = 0
            self.limit = 7 if self.out[-1] == 0xFF else 8
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)  # a header may not end in 0xFF
        return bytes(self.out)


class _TagTreeEnc:
    """Encoder mirror of csrc/jpeg2000.cpp's TagTree decoder: per node a
    '0' bit raises the lower bound, a '1' bit marks the value reached."""

    def __init__(self, w: int, h: int):
        self.w, self.h = w, h
        self.parent: List[int] = [-1] * (w * h)
        self.leaf_of = list(range(w * h))
        lw, lh, base = w, h, 0
        while lw > 1 or lh > 1:
            nw, nh = (lw + 1) // 2, (lh + 1) // 2
            nbase = base + lw * lh
            self.parent.extend([-1] * (nw * nh))
            for y in range(lh):
                for x in range(lw):
                    self.parent[base + y * lw + x] = nbase + (y // 2) * nw + (x // 2)
            base, lw, lh = nbase, nw, nh
        self.nnodes = len(self.parent)
        self.value = [0] * self.nnodes
        self.low = [0] * self.nnodes
        self.known = [0] * self.nnodes

    def set_values(self, leaves: List[int]):
        self.value = [0] * self.nnodes
        for i, v in enumerate(leaves):
            self.value[i] = v
        # internal nodes = min of children; iterate child->parent
        filled = [False] * self.nnodes
        for i in range(self.w * self.h):
            filled[i] = True
        for i in range(self.nnodes):
            p = self.parent[i]
            if p < 0:
                continue
            if not filled[p] or self.value[i] < self.value[p]:
                self.value[p] = self.value[i] if not filled[p] else min(
                    self.value[p], self.value[i])
                filled[p] = True

    def _path(self, leaf: int) -> List[int]:
        path = []
        node = self.leaf_of[leaf]
        while node >= 0:
            path.append(node)
            node = self.parent[node]
        return path[::-1]  # root first

    def encode(self, bw: _HeaderBits, x: int, y: int, threshold: int):
        lo = 0
        for nd in self._path(y * self.w + x):
            if self.low[nd] < lo:
                self.low[nd] = lo
            while not self.known[nd] and self.low[nd] < threshold:
                if self.value[nd] == self.low[nd]:
                    bw.put(1)
                    self.known[nd] = 1
                else:
                    bw.put(0)
                    self.low[nd] += 1
            lo = self.low[nd]
            if not self.known[nd]:
                return  # value >= threshold: leaf unresolved at this layer

    def encode_value(self, bw: _HeaderBits, x: int, y: int):
        """Fully resolve a leaf (zero-bitplane tree semantics)."""
        self.encode(bw, x, y, self.value[self.leaf_of[y * self.w + x]] + 1)


def _marker(code: int, payload: bytes) -> bytes:
    return struct.pack(">HH", code, len(payload) + 2) + payload


def encode_codestream(pixels: np.ndarray, signed: Optional[bool] = None) -> bytes:
    """Encode (rows, cols) integer samples as a lossless HTJ2K codestream.

    Accepts uint8/uint16/int16 (or anything losslessly castable to them).
    """
    px = np.asarray(pixels)
    if px.ndim != 2:
        raise ValueError("expected a 2-D image")
    if signed is None:
        signed = px.dtype.kind == "i"
    if signed:
        px = px.astype(np.int64)
        if px.min() < -(1 << 15) or px.max() >= (1 << 15):
            raise ValueError("samples exceed 16-bit signed range")
        prec = 16 if (px.min() < -128 or px.max() > 127) else 8
        coeff = px
    else:
        px = px.astype(np.int64)
        if px.min() < 0 or px.max() >= (1 << 16):
            raise ValueError("samples exceed 16-bit unsigned range")
        prec = 8 if px.max() < 256 else 16
        coeff = px - (1 << (prec - 1))  # DC level shift
    rows, cols = px.shape
    B = prec + _GUARD - 1  # Mb for the LL band (exponent = prec, reversible)
    zbp = B - 1            # cleanup plane p = Mb - zbp - 1 = 0: exact

    T = _get_tables()
    cbw = (cols + _CBLK - 1) // _CBLK
    cbh = (rows + _CBLK - 1) // _CBLK

    segments: List[bytes] = []
    for cy in range(cbh):
        for cx in range(cbw):
            y0, x0 = cy * _CBLK, cx * _CBLK
            blk = coeff[y0:y0 + _CBLK, x0:x0 + _CBLK]
            mu = np.abs(blk).astype(np.int64)
            sg = (blk < 0).astype(np.uint8)
            h, w = blk.shape
            segments.append(CleanupEncoder(T, w, h).encode(mu, sg))

    # --- packet header: layer 0, resolution 0, single precinct ---
    bw = _HeaderBits()
    bw.put(1)  # non-empty packet
    incl = _TagTreeEnc(cbw, cbh)
    incl.set_values([0] * (cbw * cbh))
    imsb = _TagTreeEnc(cbw, cbh)
    imsb.set_values([zbp] * (cbw * cbh))
    for cy in range(cbh):
        for cx in range(cbw):
            seg = segments[cy * cbw + cx]
            incl.encode(bw, cx, cy, 1)     # included in layer 0
            imsb.encode_value(bw, cx, cy)  # zero bit-planes
            bw.put(0)                      # 1 new pass (the cleanup)
            lblock = 3
            while len(seg) >= (1 << lblock):
                lblock += 1
            for _ in range(lblock - 3):
                bw.put(1)
            bw.put(0)
            bw.put_bits(len(seg), lblock)
    body = bw.flush() + b"".join(segments)

    # --- markers ---
    out = bytearray()
    out += struct.pack(">H", 0xFF4F)  # SOC
    ssiz = (prec - 1) | (0x80 if signed else 0)
    siz = struct.pack(">HIIIIIIIIH", 0x4000, cols, rows, 0, 0, cols, rows,
                      0, 0, 1)
    siz += bytes([ssiz, 1, 1])
    out += _marker(0xFF51, siz)
    # CAP: Pcap bit 17 => Ccap15 present; Ccap15 low 5 bits = MAGB encoding
    # (P = B - 8 clamped), bit 5 = 0 (HTONLY).
    out += _marker(0xFF50, struct.pack(">IH", 1 << 17, max(0, B - 8)))
    sgcod = bytes([0]) + struct.pack(">H", 1) + bytes([0])  # LRCP, 1 layer
    spcod = bytes([0, 6 - 2, 6 - 2, 0x40, 1])  # levels=0, 64x64, HT, 5/3
    out += _marker(0xFF52, bytes([0]) + sgcod + spcod)
    out += _marker(0xFF5C, bytes([_GUARD << 5]) + bytes([prec << 3]))
    psot = 12 + 2 + len(body)
    out += _marker(0xFF90, struct.pack(">HIBB", 0, psot, 0, 1))  # SOT
    out += struct.pack(">H", 0xFF93)  # SOD
    out += body
    out += struct.pack(">H", 0xFFD9)  # EOC
    return bytes(out)
