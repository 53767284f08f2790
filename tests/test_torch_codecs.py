"""The port's DICOM pixel codecs and transfer syntaxes against the JAX
package's (``lungmask_tpu.io.codecs`` / ``io.dicom``).

Each syntax case writes one seeded 64×64 slice (or a 3-frame file) with the
JAX writer and with the port's writer. The UIDs are given, so the two files
must be byte-identical. Each file is then read by both readers, which must
return the same pixels, dtype and tags, and the same ``MedicalImage`` through
both loaders. Lossless syntaxes return the source pixels; the lossy DCT
syntaxes return them within 2 (flat quant=1 fixtures, the bound of
``tests/test_codecs.py``). The port's fixture encoders (RLE, JPEG-lossless,
HTJ2K, DCT) emit the JAX encoders' bytes.

``tests/data/torch_port/`` holds the two fixtures the card's machine cannot
encode (no Pillow, no CharLS there): a JPEG 2000 and a JPEG-LS slice made by
the port's writer from :data:`FIXTURE_SEED`. ``python tests/test_torch_codecs.py``
rewrites them.

Tolerance: none between the packages.
"""

import os

import numpy as np
import pytest

import torch_parity
from lungmask_tpu.io import codecs as jcodecs
from lungmask_tpu.io import dicom as jdicom
from lungmask_tpu.io import loader as jloader
from lungmask_tpu_torch.io import codecs, dicom, loader
from lungmask_tpu_torch.models.synthetic import codec_slice

UID_ROOT = "1.2.826.0.1.3680043.10.1464.7"
UIDS = dict(study_uid=f"{UID_ROOT}.1", series_uid=f"{UID_ROOT}.2", sop_uid=f"{UID_ROOT}.3")
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_port")
FIXTURE_SEED = 5
FIXTURES = {"j2k_90.dcm": codecs.JPEG_2000_LOSSLESS, "jpegls_80.dcm": codecs.JPEG_LS_LOSSLESS}

needs_charls = pytest.mark.skipif(codecs.charls_lib() is None, reason="needs system CharLS")

# case → (syntax the writer emits, the UID it is relabelled to or None,
#         lossy DCT precision or None). Relabelled streams are valid under
# both UIDs (SV1 is a process-14 predictor; a lossless JPEG-LS stream is a
# NEAR=0 .81 stream; the HTJ2K codestream is the same under .201 and .202).
SYNTAXES = {
    "explicit_le": (dicom.EXPLICIT_VR_LE, None, None),
    "deflated": (dicom.DEFLATED_EXPLICIT_VR_LE, None, None),
    "big_endian": (dicom.EXPLICIT_VR_BE, None, None),
    "rle": (dicom.RLE_LOSSLESS, None, None),
    "rle_python": (dicom.RLE_LOSSLESS, None, None),
    "jpegll_70": (dicom.JPEG_LOSSLESS_SV1, None, None),
    "jpegll_57": (dicom.JPEG_LOSSLESS_SV1, dicom.JPEG_LOSSLESS_P14, None),
    "jpegls_80": (dicom.JPEG_LS_LOSSLESS, None, None),
    "jpegls_81": (dicom.JPEG_LS_LOSSLESS, dicom.JPEG_LS_NEAR_LOSSLESS, None),
    "j2k_90": (dicom.JPEG_2000_LOSSLESS, None, None),
    "j2k_91": (dicom.JPEG_2000, None, None),
    "htj2k_201": (dicom.HTJ2K_LOSSLESS, None, None),
    "htj2k_202": (dicom.HTJ2K_LOSSLESS, "1.2.840.10008.1.2.4.202", None),
    "dct_50": (dicom.JPEG_BASELINE, None, 8),
    "dct_51": (dicom.JPEG_EXTENDED, None, 12),
}


def _needs_encoder(syntax: str) -> None:
    """Skip where the syntax's fixture encoder is a system library that is
    missing: CharLS for JPEG-LS, Pillow (OpenJPEG) for JPEG 2000."""
    if syntax == dicom.JPEG_LS_LOSSLESS and codecs.charls_lib() is None:
        pytest.skip("JPEG-LS fixtures need system CharLS")
    if syntax in (dicom.JPEG_2000_LOSSLESS, dicom.JPEG_2000):
        pytest.importorskip("PIL.Image")


def _source(frames: int, precision=None) -> np.ndarray:
    px = np.stack([codec_slice(FIXTURE_SEED + i) for i in range(frames)])
    if precision == 8:
        px = np.clip((px.astype(np.int32) + 1024) // 8, 0, 255)
    elif precision == 12:
        px = np.clip(px.astype(np.int32) + 1024, 0, 4095)
    px = px.astype(np.int16)
    return px[0] if frames == 1 else px


def _relabel(path: str, old: str, new: str) -> None:
    data = open(path, "rb").read()
    assert len(old) == len(new) and data.count(old.encode()) == 1
    with open(path, "wb") as f:
        f.write(data.replace(old.encode(), new.encode()))


def _write(dicom_mod, path, pixels, case, **kw):
    syntax, relabel, precision = SYNTAXES[case]
    rescale = (1.0, -1024.0) if precision == 12 else (1.0, 0.0)
    dicom_mod.write_slice(path, pixels, transfer_syntax=syntax, rescale=rescale,
                          position=(-10.0, 5.0, 2.5), spacing=(0.7, 0.8), **UIDS, **kw)
    if relabel:
        _relabel(path, syntax, relabel)


def _implicit_le_file(path: str, pixels: np.ndarray) -> None:
    """A Part-10 file in Implicit VR Little Endian (no writer emits one)."""
    import struct

    def elem(g, e, value, explicit_vr=None):
        if len(value) % 2:
            value += b"\x00"
        if explicit_vr:
            if explicit_vr == b"OB":
                return struct.pack("<HH2sHI", g, e, explicit_vr, 0, len(value)) + value
            return struct.pack("<HH2sH", g, e, explicit_vr, len(value)) + value
        return struct.pack("<HHI", g, e, len(value)) + value

    rows, cols = pixels.shape
    meta = b"".join([
        elem(2, 1, b"\x00\x01", b"OB"),
        elem(2, 2, dicom.CT_STORAGE_UID.encode(), b"UI"),
        elem(2, 3, UIDS["sop_uid"].encode(), b"UI"),
        elem(2, 0x10, dicom.IMPLICIT_VR_LE.encode(), b"UI"),
    ])
    us = lambda v: np.uint16(v).tobytes()  # noqa: E731
    body = b"".join([
        elem(0x0008, 0x0008, b"ORIGINAL\\PRIMARY\\AXIAL"),
        elem(0x0008, 0x0018, UIDS["sop_uid"].encode()),
        elem(0x0020, 0x000D, UIDS["study_uid"].encode()),
        elem(0x0020, 0x000E, UIDS["series_uid"].encode()),
        elem(0x0020, 0x0032, b"-10.0\\5.0\\2.5"),
        elem(0x0028, 0x0002, us(1)),
        elem(0x0028, 0x0004, b"MONOCHROME2"),
        elem(0x0028, 0x0010, us(rows)),
        elem(0x0028, 0x0011, us(cols)),
        elem(0x0028, 0x0030, b"0.7\\0.8"),
        elem(0x0028, 0x0100, us(16)),
        elem(0x0028, 0x0101, us(16)),
        elem(0x0028, 0x0102, us(15)),
        elem(0x0028, 0x0103, us(1)),
        elem(0x7FE0, 0x0010, pixels.astype("<i2").tobytes()),
    ])
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + elem(2, 0, struct.pack("<I", len(meta)), b"UL")
                + meta + body)


def _read_both(path):
    """The file through both readers and both loaders, held equal; returns
    the port's parsed file."""
    got, want = dicom.read_file(path), jdicom.read_file(path)
    assert got.pixels.dtype == want.pixels.dtype
    np.testing.assert_array_equal(got.pixels, want.pixels)
    assert got.tags == want.tags
    hdr, jhdr = dicom.read_file(path, stop_before_pixels=True), jdicom.read_file(
        path, stop_before_pixels=True)
    assert hdr.pixels is None and hdr.tags == jhdr.tags
    torch_parity.assert_same_image(loader.load_input_image(path),
                                   jloader.load_input_image(path))
    return got


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("case", list(SYNTAXES))
def test_syntax_equals_jax(tmp_path, monkeypatch, case, frames):
    syntax, relabel, precision = SYNTAXES[case]
    _needs_encoder(syntax)
    if case == "rle_python":  # both packages without their native core
        monkeypatch.setattr(codecs, "get_lib", lambda: None)
        monkeypatch.setattr(jcodecs, "get_lib", lambda: None)
    src = _source(frames, precision)
    port, jax = str(tmp_path / "port.dcm"), str(tmp_path / "jax.dcm")
    _write(dicom, port, src, case, slice_thickness=2.5)
    _write(jdicom, jax, src, case, slice_thickness=2.5)
    with open(port, "rb") as a, open(jax, "rb") as b:
        assert a.read() == b.read()
    got = _read_both(port)
    if relabel:
        assert got.get("0002|0010") == relabel
    want = src.astype(np.int32) - (1024 if precision == 12 else 0)
    err = np.abs(got.pixels.astype(np.int32) - want).max()
    assert err <= (2 if precision else 0)


def test_implicit_vr_le_equals_jax(tmp_path):
    src = _source(1)
    path = str(tmp_path / "implicit.dcm")
    _implicit_le_file(path, src)
    got = _read_both(path)
    assert got.get("0002|0010") == dicom.IMPLICIT_VR_LE
    np.testing.assert_array_equal(got.pixels, src)


def write_fixture(path: str, syntax: str) -> None:
    dicom.write_slice(path, codec_slice(FIXTURE_SEED), transfer_syntax=syntax, **UIDS)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_committed_fixtures(tmp_path, name):
    """The committed fixtures decode to their seeded pixels in both packages,
    and the port's writer still makes them byte for byte."""
    path = os.path.join(FIXTURE_DIR, name)
    got = _read_both(path)
    np.testing.assert_array_equal(got.pixels, codec_slice(FIXTURE_SEED))
    _needs_encoder(FIXTURES[name])
    again = str(tmp_path / name)
    write_fixture(again, FIXTURES[name])
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# Codec level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_rle_frame_equals_jax(dtype):
    px = codec_slice(1).view(np.uint16)
    px = (px & 0xFF).astype(np.uint8) if dtype == np.uint8 else px
    frame = codecs.rle_encode_frame(px)
    assert frame == jcodecs.rle_encode_frame(px)
    out = codecs.rle_decode_frame(frame, px.size, px.itemsize)
    np.testing.assert_array_equal(out, jcodecs.rle_decode_frame(frame, px.size, px.itemsize))
    np.testing.assert_array_equal(out.reshape(px.shape), px)


@pytest.mark.parametrize("precision", [8, 12, 16])
def test_jpegll_equals_jax(precision):
    px = ((codec_slice(2).astype(np.int32) + 1229) % (1 << precision)).astype(np.uint16)
    stream = codecs.jpegll_encode(px, precision=precision)
    assert stream == jcodecs.jpegll_encode(px, precision=precision)
    np.testing.assert_array_equal(codecs.jpegll_decode(stream), px)
    np.testing.assert_array_equal(codecs.jpegll_decode(stream), jcodecs.jpegll_decode(stream))


@pytest.mark.parametrize(
    "shape, dtype, lo, hi",
    [((64, 64), np.int16, -1024, 3071), ((33, 77), np.uint8, 0, 255),
     ((70, 90), np.uint16, 0, 65535)],
)
def test_htj2k_encode_bytes_equal_jax(shape, dtype, lo, hi):
    img = np.random.default_rng(3).integers(lo, hi + 1, size=shape).astype(dtype)
    stream = codecs.htj2k_encode(img)
    assert stream == jcodecs.htj2k_encode(img)
    dec = codecs.j2k_decode(stream)
    np.testing.assert_array_equal(dec, jcodecs.j2k_decode(stream))
    np.testing.assert_array_equal(dec, img.astype(np.int32))


@pytest.mark.parametrize("precision", [8, 12])
def test_jpegdct_equals_jax(precision):
    px = _source(1, precision).astype(np.uint16)
    px = px.astype(np.uint8) if precision == 8 else px
    stream = codecs.jpegdct_encode(px, precision=precision, quant=1)
    assert stream == jcodecs.jpegdct_encode(px, precision=precision, quant=1)
    out = codecs.jpegdct_decode(stream)
    jout = jcodecs.jpegdct_decode(stream)
    assert out.dtype == jout.dtype
    np.testing.assert_array_equal(out, jout)
    assert np.abs(out.astype(int) - px.astype(int)).max() <= 2


@needs_charls
@pytest.mark.parametrize("near", [0, 2])
def test_jpegls_equals_jax(near):
    px = (codec_slice(3).astype(np.int32) + 1229).astype(np.uint16) % 4096
    stream = codecs.jpegls_encode(px, precision=12, near=near)
    assert stream == jcodecs.jpegls_encode(px, precision=12, near=near)
    out, got_near = codecs.jpegls_decode(stream, with_near=True)
    jout, jnear = jcodecs.jpegls_decode(stream, with_near=True)
    assert got_near == jnear == near
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, codecs.charls_decode(stream))
    assert np.abs(out.astype(int) - px.astype(int)).max() <= near


def test_j2k_equals_jax():
    pytest.importorskip("PIL.Image")
    px = (codec_slice(4).astype(np.int32) + 1229).astype(np.uint16)
    stream = codecs.j2k_encode(px)
    assert stream == jcodecs.j2k_encode(px)
    np.testing.assert_array_equal(codecs.j2k_decode(stream), jcodecs.j2k_decode(stream))
    np.testing.assert_array_equal(codecs.j2k_decode(stream), px.astype(np.int32))


def _outcome(fn, data):
    try:
        return fn(data)
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("codec", ["jpegll", "jpegdct", "htj2k", "rle"])
def test_corrupt_streams_fail_alike(codec):
    """Truncated and bit-flipped streams decode to the same array in both
    packages, or raise ValueError in both."""
    px = (codec_slice(6).astype(np.int32) + 1229).astype(np.uint16) % 4096
    if codec == "jpegll":
        data, fns = codecs.jpegll_encode(px, 12), (codecs.jpegll_decode, jcodecs.jpegll_decode)
    elif codec == "jpegdct":
        data = codecs.jpegdct_encode(px, 12)
        fns = (codecs.jpegdct_decode, jcodecs.jpegdct_decode)
    elif codec == "htj2k":
        data, fns = codecs.htj2k_encode(px), (codecs.j2k_decode, jcodecs.j2k_decode)
    else:
        data = codecs.rle_encode_frame(px)
        fns = tuple(lambda d, m=m: m.rle_decode_frame(d, px.size, 2) for m in (codecs, jcodecs))
    variants = [data[:cut] for cut in range(0, len(data), max(1, len(data) // 16))]
    for off in range(0, len(data), max(1, len(data) // 24)):
        mut = bytearray(data)
        mut[off] ^= 0xA5
        variants.append(bytes(mut))
    for v in variants:
        got, want = _outcome(fns[0], v), _outcome(fns[1], v)
        if isinstance(want, str):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)


def test_codec_library_is_the_ports_own():
    """The port builds the shared codec sources into its own ``_build/`` and
    never writes under the JAX package."""
    from lungmask_tpu_torch.ops import native

    lib = codecs.get_lib()
    if lib is None:
        pytest.skip("no C++ compiler")
    assert os.path.dirname(codecs.library_path()) == native.BUILD_DIR
    assert os.path.realpath(lib._name) == os.path.realpath(codecs.library_path())
    assert os.path.isfile(codecs.library_path() + ".buildinfo")


if __name__ == "__main__":
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    for fixture_name, fixture_syntax in FIXTURES.items():
        write_fixture(os.path.join(FIXTURE_DIR, fixture_name), fixture_syntax)
        print("wrote", os.path.join(FIXTURE_DIR, fixture_name))
