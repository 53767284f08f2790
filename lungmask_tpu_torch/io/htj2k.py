"""HTJ2K (ITU-T T.814) HT cleanup-pass codec — pure-Python reference.

Decodes and encodes the HT block-coder cleanup pass for the DICOM HTJ2K
transfer syntaxes (1.2.840.10008.1.2.4.201/.202), which the reference
reads through ITK/GDCM (lungmask/utils.py:215-222).

Every coding rule and table in this module was reconstructed EMPIRICALLY by
black-box probing of OpenJPEG's conformant HT decoder (the only HT
implementation in this image) — see tools/htj2k_probe.py,
tools/htj2k_extract.py and docs/HTJ2K.md for the campaign. The tables are
therefore the published standard's tables (any conformant decoder embodies
them), obtained without copying any implementation.

Mechanism summary (probed, then verified by differential fuzzing vs
OpenJPEG in tests/test_htj2k.py):

  * A code-block's cleanup segment is [MagSgn | MEL -> | <- VLC], with
    Scup = (B[L-1]<<4) | (B[L-2] & 0xF) giving the MEL+VLC suffix length.
  * Quads (2x2, column-major samples) are scanned in line pairs, in
    horizontal pairs of quads. Per pair the VLC stream carries
    cw(q0) cw(q1) then the pair's u-VLC section.
  * A quad with all-zero causal context consults the MEL coder for its
    significance instead of carrying a rho=0 codeword.
  * u-VLC: '1'->1, '01'->2, '001'+1bit->3+b, '000'+5bits(LSB-first)->5+k;
    in the INITIAL line pair, if both quads of a pair have u_off=1 one MEL
    event e is decoded first: e=1 (both u>2) -> interleaved pair
    (pfx0 pfx1 sfx0 sfx1) with u_i = value_i + 2; e=0 -> u0's prefix,
    then (if the prefix says u0>2) u1-1 as ONE bit before u0's suffix
    bits, else a full u-VLC for u1. Non-initial pairs with both u_off=1
    use the interleaved pair form directly (no MEL event, no offset).
  * U_q = u_q + kappa_q (kappa_q = 1 in the initial line pair; see
    decode() for the non-initial rule). Per significant sample n:
    m_n = U_q - kappa_n bits are read LSB-first from MagSgn as
    v = (mag << 1) | sign, and mu_n = 1 + mag + e1_n * 2^(m_n - 1).
  * Reconstruction (cleanup-only): coeff = +/- (mu * 2^p + 2^(p-1)) with
    p = B - 1 - missing_msbs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# bit-stream readers (semantics probed: see docs/HTJ2K.md "stream mechanics")
# ---------------------------------------------------------------------------


class MELDecoder:
    """Adaptive run-length coder: 13 states, exponents below.

    Events: 1 = "hit" (e.g. AZC quad significant / u>2). A '1' bit at state
    k codes a run of 2^E[k] zero-events; a '0' bit codes E[k] literal bits
    giving the count of zero-events before a one-event.
    """

    E = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5]

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 7
        self.state = 0
        self.runs: List[int] = []  # pending zero-events before next 1-event
        self._queue: List[int] = []

    def _read_bit(self) -> int:
        if self.pos >= len(self.data):
            return 1  # pad: behaves as max-run continuation
        b = (self.data[self.pos] >> self.bit) & 1
        # unstuffing: after an 0xFF byte only 7 bits of the next byte count
        if self.bit == 0:
            skip7 = self.data[self.pos] == 0xFF
            self.pos += 1
            self.bit = 6 if skip7 else 7
        else:
            self.bit -= 1
        return b

    def event(self) -> int:
        """Next binary event."""
        if not self._queue:
            e = MELDecoder.E[self.state]
            if self._read_bit():
                self._queue.extend([0] * (1 << e))
                self.state = min(self.state + 1, 12)
            else:
                run = 0
                for i in range(e - 1, -1, -1):
                    run |= self._read_bit() << i
                self._queue.extend([0] * run + [1])
                self.state = max(self.state - 1, 0)
        return self._queue.pop(0)


class MELEncoder:
    def __init__(self):
        self.bits: List[int] = []
        self.state = 0
        self.run = 0

    def event(self, e: int):
        if not hasattr(self, "events"):
            self.events = []
        self.events.append(e)
        if e == 0:
            self.run += 1
            if self.run == (1 << MELDecoder.E[self.state]):
                self.bits.append(1)
                self.run = 0
                self.state = min(self.state + 1, 12)
        else:
            k = MELDecoder.E[self.state]
            self.bits.append(0)
            for i in range(k - 1, -1, -1):
                self.bits.append((self.run >> i) & 1)
            self.run = 0
            self.state = max(self.state - 1, 0)

    def flush(self) -> bytes:
        bits = list(self.bits)
        if self.run:
            # terminate a pending partial run as a full-run bit: decoder
            # over-reads zero-events past the last quad harmlessly
            bits.append(1)
        out = bytearray()
        acc = 0
        n = 0
        limit = 8
        for b in bits:
            acc = (acc << 1) | b
            n += 1
            if n == limit:
                # after an 0xFF byte only 7 bits are carried, in bit
                # positions 6..0 (the MSB is a stuffed 0 — the stream may
                # not contain 0xFF followed by a byte > 0x8F)
                out.append(acc)
                limit = 7 if out[-1] == 0xFF else 8
                acc = 0
                n = 0
        if n:
            pad = limit - n
            out.append(((acc << pad) | ((1 << pad) - 1)))
        return bytes(out)


class VLCReader:
    """Backward bit reader for the VLC segment.

    Physically: bits are served LSB-first from the high nibble of
    B[Scup-2], then LSB-first from each previous byte. Two stuffing rules
    (fuzz-confirmed vs OpenJPEG):

      * initial nibble: if its low 3 bits are all 1, its bit 3 is a
        stuffed 0 and only 3 data bits are carried;
      * a byte contributes 7 bits (MSB stuffed 0) when the
        previously-consumed byte (higher address) exceeds 0x8F AND its own
        low 7 bits are all ones (the marker-pair rule: the stream may not
        contain 0xFF followed by a byte above 0x8F). For the nibble byte
        the >0x8F comparison is pessimistic (nibble >= 9) — its low nibble
        belongs to Scup; the two forms are provably equivalent there.
    """

    def __init__(self, segment: bytes):
        # segment = the Scup-byte MEL+VLC region; VLC reads from the end
        self.data = segment
        self.ipos = len(segment) - 2  # byte holding the first nibble
        nib = (segment[self.ipos] >> 4) if len(segment) >= 2 else 0
        # first-nibble stuffing (probed via the reconstructed true ctx0
        # table): when the nibble's low 3 bits are all ones, bit 3 is a
        # stuffed 0 and only 3 data bits are carried. The unstuff flag for
        # the next byte is pessimistic (the X byte's low nibble belongs
        # to Scup and reads as if it were 0xF).
        if (nib & 7) == 7:
            self.acc = nib & 7
            self.nbits = 3
        else:
            self.acc = nib
            self.nbits = 4
        self.unstuff = nib >= 9

    def _refill(self):
        while self.nbits <= 24 and self.ipos > 0:
            self.ipos -= 1
            byte = self.data[self.ipos]
            # a byte carries 7 bits (MSB = stuffed 0) only when the
            # previously-consumed byte exceeded 0x8F AND this byte's
            # low 7 bits are all ones
            take = 7 if (self.unstuff and (byte & 0x7F) == 0x7F) else 8
            self.acc |= (byte & ((1 << take) - 1)) << self.nbits
            self.nbits += take
            self.unstuff = byte > 0x8F

    def read(self, n: int) -> int:
        if n > self.nbits:
            self._refill()
        if n > self.nbits:
            # pad with zeros beyond the stream (encoder guarantees no reads)
            self.acc |= 0
            self.nbits = n
        v = self.acc & ((1 << n) - 1)
        self.acc >>= n
        self.nbits -= n
        return v

    def peek(self, n: int) -> int:
        if n > self.nbits:
            self._refill()
        return self.acc & ((1 << n) - 1)


class VLCWriter:
    def __init__(self):
        self.bits: List[int] = []

    def write(self, value: int, n: int):
        for i in range(n):
            self.bits.append((value >> i) & 1)

    def write_bits(self, bitlist):
        self.bits.extend(bitlist)

    def flush(self) -> bytes:
        """Pack into the backward byte order (last byte = the one whose
        high nibble holds the first VLC bits; the caller merges it with
        the Scup low nibble). Mirrors VLCReader's stuffing exactly:
        a nibble whose low 3 bits are all 1 keeps a stuffed-0 MSB, and a
        byte after one that the reader sees as > 0x8F (nibble byte:
        nibble >= 9, since its Scup low nibble reads as 0xF) carries only
        7 bits with a stuffed-0 MSB."""
        out: List[int] = []  # bytes from the END toward the start
        bits = list(self.bits)
        idx = 0
        nib = 0
        for i in range(3):
            if idx < len(bits) and bits[idx]:
                nib |= 1 << i
            idx += 1
        if (nib & 7) != 7:
            if idx < len(bits) and bits[idx]:
                nib |= 1 << 3
            idx += 1
        out.append(nib << 4)
        unstuff = nib >= 9
        while idx < len(bits):
            # gather 7 bits; if the previous byte exceeded 0x8F and
            # they are all ones, emit them as 0x7F (stuffed-0 MSB);
            # otherwise the byte carries an 8th bit
            b = 0
            for i in range(7):
                if idx < len(bits) and bits[idx]:
                    b |= 1 << i
                idx += 1
            if not (unstuff and b == 0x7F):
                if idx < len(bits) and bits[idx]:
                    b |= 1 << 7
                idx += 1
            out.append(b)
            unstuff = b > 0x8F
        return bytes(reversed(out))


class MagSgnReader:
    """Forward LSB-first bit reader; after an 0xFF byte the next byte
    contributes 7 bits."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0
        self.prev_ff = False

    def read(self, n: int) -> int:
        while self.nbits < n:
            if self.pos < len(self.data):
                byte = self.data[self.pos]
                take = 7 if self.pos > 0 and self.data[self.pos - 1] == 0xFF else 8
                self.acc |= (byte & ((1 << take) - 1)) << self.nbits
                self.nbits += take
                self.pos += 1
            else:
                self.nbits = n  # zero-pad
        v = self.acc & ((1 << n) - 1)
        self.acc >>= n
        self.nbits -= n
        return v


class MagSgnWriter:
    def __init__(self):
        self.bits: List[int] = []

    def write(self, value: int, n: int):
        for i in range(n):
            self.bits.append((value >> i) & 1)

    def flush(self) -> bytes:
        out = bytearray()
        idx = 0
        while idx < len(self.bits):
            take = 7 if out and out[-1] == 0xFF else 8
            b = 0
            for i in range(take):
                if idx < len(self.bits) and self.bits[idx]:
                    b |= 1 << i
                idx += 1
            out.append(b)
        if out and out[-1] == 0xFF:
            out.append(0)
        return bytes(out)


# ---------------------------------------------------------------------------
# tables (populated from tools/htj2k_extract.py output; see docs/HTJ2K.md)
# ---------------------------------------------------------------------------

_TABLE_PATH = os.path.join(os.path.dirname(__file__), "htj2k_tables.json")


def load_tables() -> dict:
    with open(_TABLE_PATH) as f:
        return json.load(f)


def uvlc_encode_joint(u0: int, u1: int) -> List[int]:
    """Inverse of uvlc_decode_joint (e=0: not both u>2)."""
    p0 = uvlc_encode(u0)
    if u0 <= 2:
        return p0 + uvlc_encode(u1)
    if not 1 <= u1 <= 2:
        raise ValueError("u1 must be <=2 when u0>2 and e=0")
    # u0's code = prefix + suffix; insert the u1 bit between them
    if u0 in (3, 4):
        return [0, 0, 1, u1 - 1, u0 - 3]
    return [0, 0, 0, u1 - 1] + [(u0 - 5 >> i) & 1 for i in range(5)]


def uvlc_parts(u: int) -> Tuple[List[int], List[int]]:
    """(prefix bits, suffix bits) of the u-VLC for u in [1, 36]."""
    if u == 1:
        return [1], []
    if u == 2:
        return [0, 1], []
    if u in (3, 4):
        return [0, 0, 1], [u - 3]
    k = u - 5
    if not 0 <= k < 32:
        raise ValueError(f"u={u} out of range")
    return [0, 0, 0], [(k >> i) & 1 for i in range(5)]


def uvlc_encode(u: int) -> List[int]:
    pfx, sfx = uvlc_parts(u)
    return pfx + sfx


def uvlc_decode(r: VLCReader) -> int:
    if r.read(1):
        return 1
    if r.read(1):
        return 2
    if r.read(1):
        return 3 + r.read(1)
    return 5 + r.read(5)


def _uvlc_read_prefix(r: VLCReader) -> int:
    """Read just the u-VLC prefix; returns base u (suffix still pending)."""
    if r.read(1):
        return 1
    if r.read(1):
        return 2
    if r.read(1):
        return 3
    return 5


def _uvlc_read_suffix(r: VLCReader, base: int) -> int:
    if base == 3:
        return base + r.read(1)
    if base == 5:
        return base + r.read(5)
    return base


def uvlc_decode_pair(r: VLCReader) -> Tuple[int, int]:
    """Interleaved two-u form (initial pair, MEL e=1, both u>2):
    pfx0 pfx1 sfx0 sfx1; u_i = value_i + 2 applied by the caller.
    (Probed: sequential parsing is wrong for values with suffixes —
    OpenJPEG reads both prefixes before either suffix.)"""
    b0 = _uvlc_read_prefix(r)
    b1 = _uvlc_read_prefix(r)
    u0 = _uvlc_read_suffix(r, b0)
    u1 = _uvlc_read_suffix(r, b1)
    return u0, u1


def uvlc_encode_pair(v0: int, v1: int) -> List[int]:
    p0, s0 = uvlc_parts(v0)
    p1, s1 = uvlc_parts(v1)
    return p0 + p1 + s0 + s1


def uvlc_decode_joint(r: VLCReader):
    """Initial-pair, both u_off=1, MEL event 0: u0 prefix; if u0>2 its
    suffix bits FOLLOW a 1-bit u1 (u1<=2 implied); else u1 is a full
    u-VLC."""
    if r.read(1):
        return 1, uvlc_decode(r)
    if r.read(1):
        return 2, uvlc_decode(r)
    if r.read(1):
        u1 = 1 + r.read(1)
        return 3 + r.read(1), u1
    u1 = 1 + r.read(1)
    return 5 + r.read(5), u1


# ---------------------------------------------------------------------------
# cleanup-pass codec (single code-block)
# ---------------------------------------------------------------------------


class HTTables:
    """Codeword table banks + context maps (see docs/HTJ2K.md).

    Schema: {"banks": {name: {cw: {"rho","u_off","kappa","e1"}}},
             "ctx_initial": {"<rho_left>": bank-name, "azc": ...},
             "ctx_row": {"<n1><n3>...": bank-name}}
    """

    def __init__(self, data: dict):
        self.banks = {}
        for name, tbl in data["banks"].items():
            fwd = {}
            for cw, e in tbl.items():
                if "rho" not in e:
                    continue
                fwd[cw] = (e["rho"], e.get("u_off", 0),
                           tuple(e.get("kappa", [])), tuple(e.get("e1", [])))
            self.banks[name] = fwd
        self.ctx_initial = data["ctx_initial"]
        self.ctx_row = data["ctx_row"]
        # reverse index for the encoder: bank -> (rho, u_off) -> [(cw, kappa, e1)]
        self.enc = {}
        for name, fwd in self.banks.items():
            by = {}
            for cw, (rho, uoff, kappa, e1) in fwd.items():
                by.setdefault((rho, uoff), []).append((cw, kappa, e1))
            for v in by.values():
                v.sort(key=lambda t: len(t[0]))
            self.enc[name] = by


def _exp(mu: int) -> int:
    """Magnitude exponent E_n of a decoded magnitude: bitlen(2*mu - 1),
    i.e. E = ceil(log2(2*mu)). 0 for insignificant samples."""
    return (2 * mu - 1).bit_length() if mu > 0 else 0


def _kappa_q(rho: int, e_row, qy: int, qx: int, initial: bool) -> int:
    """U_q = u_q + kappa_q. Initial line pair: kappa_q = 1. Non-initial:
    kappa_q = max(1, E_q - 1) if the quad has more than one significant
    sample (gamma_q = 1), else 1; E_q is the largest exponent over the
    above-row samples spanning the quad's context neighborhood — the NW
    sample, the two samples directly above, and the NE sample (probed:
    tools/htj2k_kappa_probe.py and the NE/NW sweeps in docs/HTJ2K.md)."""
    if initial:
        return 1
    ncols = e_row.shape[2]
    lo = max(0, 2 * qx - 1)
    hi = min(ncols, 2 * qx + 3)
    e_above = int(e_row[qy - 1, 1, lo:hi].max())
    gamma = (rho & (rho - 1)) != 0
    if not gamma:
        return 1
    return max(1, e_above - 1)


class CleanupDecoder:
    """Decode one code-block's cleanup pass -> (mu, sign) int arrays."""

    def __init__(self, tables: HTTables, w: int, h: int):
        self.T = tables
        self.w = w
        self.h = h

    def decode(self, data: bytes):
        w, h = self.w, self.h
        if len(data) < 2:
            raise ValueError("cleanup segment too short")
        lcup = len(data)
        scup = (data[lcup - 1] << 4) | (data[lcup - 2] & 0x0F)
        if not (2 <= scup <= min(lcup, 4079)):
            raise ValueError(f"bad Scup {scup}")
        mel = MELDecoder(data[lcup - scup:])
        vlc = VLCReader(data[lcup - scup:])
        mag = MagSgnReader(data[: lcup - scup])

        qw = (w + 1) // 2
        qh = (h + 1) // 2
        mu = np.zeros((h, w), np.int64)
        sg = np.zeros((h, w), np.uint8)
        # per-quad state for context/kappa: rho and per-sample magnitude
        # exponent E_n = bitlen(2*mu_n - 1) (0 for insignificant samples)
        rho_row = [[0] * qw for _ in range(qh)]
        e_row = np.zeros((qh, 2, 2 * qw), np.int32)  # E per sample position

        for qy in range(qh):
            initial = qy == 0
            qx = 0
            while qx < qw:
                pair = [qx] + ([qx + 1] if qx + 1 < qw else [])
                specs = []
                for i, x in enumerate(pair):
                    ctx = self._ctx(rho_row, e_row, qy, x, initial)
                    if ctx == "azc":
                        if mel.event() == 0:
                            specs.append((0, 0, (), ()))
                            rho_row[qy][x] = 0
                            continue
                        bank = self.T.banks[
                            self.T.ctx_initial["azc"] if initial
                            else self.T.ctx_row["azc"]]
                    else:
                        bank = self.T.banks[ctx]
                    cw = ""
                    while True:
                        cw += str(vlc.read(1))
                        if cw in bank:
                            specs.append(bank[cw])
                            break
                        if len(cw) > 10:
                            raise ValueError(
                                f"unknown codeword {cw!r} (quad {qy},{x})")
                    # the pair-mate's context depends on this quad's rho
                    rho_row[qy][x] = specs[-1][0]
                # u section
                uoffs = [s[1] for s in specs]
                us = [0] * len(specs)
                if initial and len(specs) == 2 and uoffs == [1, 1]:
                    e = mel.event()
                    if e:
                        v0, v1 = uvlc_decode_pair(vlc)
                        us[0] = v0 + 2
                        us[1] = v1 + 2
                    else:
                        us[0], us[1] = uvlc_decode_joint(vlc)
                elif not initial and len(specs) == 2 and uoffs == [1, 1]:
                    # non-initial both-u_off: interleaved pfx0 pfx1 sfx0
                    # sfx1, no MEL event, no +2 offset
                    us[0], us[1] = uvlc_decode_pair(vlc)
                else:
                    for i, uo in enumerate(uoffs):
                        if uo:
                            us[i] = uvlc_decode(vlc)
                # magnitudes
                for i, x in enumerate(pair):
                    rho, uoff, kappa, e1 = specs[i]
                    rho_row[qy][x] = rho
                    if rho == 0:
                        continue
                    kq = _kappa_q(rho, e_row, qy, x, initial)
                    U = us[i] + kq
                    si = 0
                    for k in range(4):
                        if not rho >> k & 1:
                            continue
                        m = U - kappa[si]
                        v = mag.read(m) if m > 0 else 0
                        s = v & 1
                        mg = v >> 1
                        muv = 1 + mg + (e1[si] << (m - 1) if m > 0 else 0)
                        r = qy * 2 + (k & 1)
                        c = x * 2 + (k >> 1)
                        if r < h and c < w:
                            mu[r, c] = muv
                            sg[r, c] = s
                        e_row[qy, k & 1, 2 * x + (k >> 1)] = _exp(muv)
                        si += 1
                qx += len(pair)
        return mu, sg

    def _ctx(self, rho_row, e_row, qy, qx, initial):
        if initial:
            left = rho_row[0][qx - 1] if qx > 0 else 0
            key = str(left)
            name = self.T.ctx_initial.get(key)
            if name is None:
                raise ValueError(f"no initial ctx for left rho {left}")
            return name
        # Non-initial context (probed; tools/htj2k_ctx.py sweep):
        #   bit0 = sig(NW sample) | sig(sample above n0-column)
        #   bit1 = sig(sample above n2-column) | sig(NE sample)
        #   bit2 = sig(left quad's right column: n2 | n3)
        # NW = above-left quad's n3; NE = above-right quad's n1; the left
        # quad's LEFT column and the above quads' TOP rows do not enter.
        qw = len(rho_row[qy])
        above = rho_row[qy - 1][qx]
        nw = (rho_row[qy - 1][qx - 1] >> 3) & 1 if qx > 0 else 0
        n0 = (above >> 1) & 1
        n1 = (above >> 3) & 1
        ne = (rho_row[qy - 1][qx + 1] >> 1) & 1 if qx + 1 < qw else 0
        left = rho_row[qy][qx - 1] if qx > 0 else 0
        wbit = 1 if left & 0b1100 else 0
        c = (nw | n0) | ((n1 | ne) << 1) | (wbit << 2)
        name = self.T.ctx_row.get(str(c))
        if name is None:
            raise ValueError(f"no row ctx for context {c}")
        return name


class CleanupEncoder:
    """Encode (mu, sign) -> a cleanup segment the decoder above (and
    OpenJPEG) reconstructs exactly. Encoder policy: smallest usable U per
    quad, e1=0 codings preferred; chooses only table entries whose
    (rho, u_off) exist in the bank."""

    def __init__(self, tables: HTTables, w: int, h: int):
        self.T = tables
        self.w = w
        self.h = h

    def encode(self, mu, sg, trace=None) -> bytes:
        """trace: optional dict; if given, trace[(qy,qx)] = (vlc_bits,
        mel_events, magsgn_bits) BEFORE that quad's codeword is emitted."""
        w, h = self.w, self.h
        qw = (w + 1) // 2
        qh = (h + 1) // 2
        melw = MELEncoder()
        vlcw = VLCWriter()
        magw = MagSgnWriter()
        rho_row = [[0] * qw for _ in range(qh)]
        e_row = np.zeros((qh, 2, 2 * qw), np.int32)

        dec = CleanupDecoder(self.T, w, h)  # reuse ctx logic
        for qy in range(qh):
            initial = qy == 0
            qx = 0
            while qx < qw:
                pair = [qx] + ([qx + 1] if qx + 1 < qw else [])
                # gather quad info
                infos = []
                for x in pair:
                    rho = 0
                    mus = []
                    for k in range(4):
                        r = qy * 2 + (k & 1)
                        c = x * 2 + (k >> 1)
                        v = int(mu[r, c]) if r < h and c < w else 0
                        if v:
                            rho |= 1 << k
                            mus.append(v)
                    infos.append((rho, mus))
                    rho_row[qy][x] = rho
                # contexts + MEL significance
                specs = []
                for i, x in enumerate(pair):
                    rho, mus = infos[i]
                    ctx = dec._ctx(rho_row, e_row, qy, x, initial)
                    if ctx == "azc":
                        melw.event(1 if rho else 0)
                        if rho == 0:
                            specs.append(None)
                            continue
                        bank_name = (self.T.ctx_initial["azc"] if initial
                                     else self.T.ctx_row["azc"])
                    else:
                        bank_name = ctx
                    specs.append(("bank", bank_name, rho, mus, x))
                    if ctx != "azc" and rho == 0:
                        pass
                # pick codewords + u values
                chosen = []
                for i, sp in enumerate(specs):
                    if trace is not None:
                        trace[(qy, pair[i])] = (
                            len(vlcw.bits), list(getattr(melw, "events", [])),
                            len(magw.bits))
                    if sp is None:
                        chosen.append(None)
                        continue
                    _, bank_name, rho, mus, x = sp
                    kq = _kappa_q(rho, e_row, qy, x, initial)
                    emax = max((_exp(v) for v in mus), default=1) if rho else 0
                    cand = self._pick(bank_name, rho, emax, kq, mus)
                    chosen.append(cand + (kq,))
                # u coding
                uoffs = [(c[3] if c else 0) for c in chosen]

                for i, c in enumerate(chosen):
                    if trace is not None and c:
                        trace[("cw", qy, pair[i])] = c[0]
                    if c:
                        vlcw.write_bits([int(b) for b in c[0]])
                us = [(c[4] if c else 0) for c in chosen]
                if initial and len(chosen) == 2 and uoffs == [1, 1]:
                    if us[0] > 2 and us[1] > 2:
                        melw.event(1)
                        vlcw.write_bits(uvlc_encode_pair(us[0] - 2,
                                                         us[1] - 2))
                    else:
                        melw.event(0)
                        vlcw.write_bits(uvlc_encode_joint(us[0], us[1]))
                elif not initial and len(chosen) == 2 and uoffs == [1, 1]:
                    vlcw.write_bits(uvlc_encode_pair(us[0], us[1]))
                else:
                    for i, uo in enumerate(uoffs):
                        if uo:
                            vlcw.write_bits(uvlc_encode(us[i]))
                # magnitudes
                for i, c in enumerate(chosen):
                    if not c:
                        continue
                    cw, kappa, e1, uoff, u, kq = c
                    x = pair[i]
                    rho = rho_row[qy][x]
                    U = u + kq
                    si = 0
                    for k in range(4):
                        if not rho >> k & 1:
                            continue
                        r = qy * 2 + (k & 1)
                        cc = x * 2 + (k >> 1)
                        muv = int(mu[r, cc])
                        m = U - kappa[si]
                        base = (e1[si] << (m - 1)) if m > 0 else 0
                        mg = muv - 1 - base
                        assert 0 <= mg < (1 << max(m - 1, 0)) or (
                            m == 0 and mg == 0), (muv, m, base)
                        v = (mg << 1) | int(sg[r, cc])
                        magw.write(v, m)
                        e_row[qy, k & 1, 2 * x + (k >> 1)] = _exp(muv)
                        si += 1
                qx += len(pair)

        return assemble_segment(magw.flush(), melw.flush(), vlcw)

    def _pick(self, bank_name, rho, emax, kq, mus):
        """Choose (cw, kappa, e1, u_off, u) able to code these magnitudes.

        A sample with m bits codes mu in [1+b, 2^(m-1)+b] where
        b = e1*2^(m-1); m may be 0 only for mu == 1 (zero bits read)."""
        by = self.T.enc[bank_name]

        def fits(kappa, e1, U):
            for si, v in enumerate(mus):
                m = U - kappa[si]
                if m < 0:
                    return False
                if m == 0:
                    if v != 1 or e1[si]:
                        return False
                    continue
                base = e1[si] << (m - 1)
                mg = v - 1 - base
                if mg < 0 or mg >= (1 << (m - 1)):
                    return False
            return True

        for uoff in (0, 1):
            umax = 1 if uoff == 0 else 37
            for u in range(0 if uoff == 0 else 1, umax):
                U = u + kq
                for cw, kappa, e1 in by.get((rho, uoff), []):
                    if fits(kappa, e1, U):
                        return (cw, kappa, e1, uoff, u)
        raise ValueError(f"no codeword for rho={rho} mus={mus} in {bank_name}")


def assemble_segment(mag_bytes: bytes, mel_bytes: bytes, vlcw: VLCWriter) -> bytes:
    vlc_bytes = vlcw.flush()  # deepest-first; last byte holds the first nibble
    # MEL/VLC boundary marker rule: the MEL reader reads forward past its
    # logical end into the VLC region, and no byte > 0x8F may follow an
    # 0xFF anywhere it can reach. Pad with 0x7F (seven 1-bits = harmless
    # zero-event run continuations) when the boundary would violate that.
    if mel_bytes and mel_bytes[-1] == 0xFF:
        nxt = vlc_bytes[0] if len(vlc_bytes) > 1 else (
            ((vlc_bytes[-1] >> 4) << 4) | 0xF if vlc_bytes else 0xFF)
        if nxt > 0x8F:
            mel_bytes = mel_bytes + b"\x7f"
    if vlc_bytes:
        scup = len(mel_bytes) + len(vlc_bytes) + 1  # X replaces the nibble byte
        first_nib = vlc_bytes[-1] >> 4
        body = mel_bytes + vlc_bytes[:-1]
    else:
        scup = len(mel_bytes) + 2
        first_nib = 0
        body = mel_bytes
    if scup > 4079:
        raise ValueError("cleanup MEL+VLC too long")
    tail = bytes([(first_nib << 4) | (scup & 0x0F), scup >> 4])
    out = mag_bytes + body + tail
    assert len(out) == len(mag_bytes) + scup
    return out
