"""The port's file formats, DICOM series scan and assembly, series writer,
``--noHU`` stacks and ``compat`` names against the JAX package's
(``lungmask_tpu.io``, ``lungmask_tpu.compat``).

Every case writes a seeded volume with one package and reads it with both:
voxels, dtype, spacing, origin, direction and tags must be equal. Where a
writer draws fresh UIDs, ``dicom.generate_uid`` is replaced by the same
counter in both packages, so the two packages' files must be byte-identical.
The pixel codecs and transfer syntaxes are ``test_torch_codecs.py``'s.

Tolerance: none.
"""

import gzip
import io
import os
import shutil
import sys
import threading
import zlib

import numpy as np
import pytest

import torch_parity
from lungmask_tpu import compat as jcompat
from lungmask_tpu.io import dicom as jdicom
from lungmask_tpu.io import image as jimage
from lungmask_tpu.io import loader as jloader
from lungmask_tpu.io import mha as jmha
from lungmask_tpu.io import nifti as jnifti
from lungmask_tpu.io import nohu as jnohu
from lungmask_tpu.io import nrrd as jnrrd
from lungmask_tpu_torch import compat
from lungmask_tpu_torch.io import dicom, image, loader, mha, nifti, nohu, nrrd

PKGS = {"jax": (jimage, jloader), "port": (image, loader)}
RASTER = (".png", ".tif", ".bmp", ".jpg")
EXTS = (".nii", ".nii.gz", ".mha", ".mhd", ".nrrd", ".nhdr", ".hdr", ".hdr.gz", ".img",
        ".img.gz", ".vtk", ".gipl") + RASTER
UID_ROOT = "1.2.826.0.1.3680043.10.1464.9"
DIRECTED = (".nii", ".nii.gz", ".mha", ".mhd", ".nrrd", ".nhdr")  # carry a direction matrix


def _volume(ext: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if ext in RASTER:
        return rng.integers(0, 256, size=(1, 10, 12)).astype(np.uint8)
    return rng.integers(-1024, 2000, size=(3, 10, 12)).astype(np.int16)


def _read_both(path):
    got, want = loader.load_input_image(path), jloader.load_input_image(path)
    torch_parity.assert_same_image(got, want)
    return got


@pytest.mark.parametrize("ext", EXTS)
@pytest.mark.parametrize("writer", sorted(PKGS))
def test_format_roundtrip_equals_jax(tmp_path, writer, ext):
    img_mod, load_mod = PKGS[writer]
    arr = _volume(ext)
    direction = np.diag([1.0, -1.0, 1.0]) if ext in DIRECTED else np.eye(3)
    src = img_mod.MedicalImage(arr, spacing=(0.7, 0.8, 2.5), origin=(-10.0, 5.0, 2.0),
                               direction=direction)
    path = str(tmp_path / f"v{ext}")
    load_mod.write_image(src, path)
    got = _read_both(path)
    if ext == ".jpg":
        assert got.array.shape == arr.shape
    else:
        np.testing.assert_array_equal(got.array, arr)


@pytest.mark.parametrize("fmt", ["mha", "nrrd"])
@pytest.mark.parametrize("compressed", [False, True])
def test_compressed_writers_equal_jax(tmp_path, fmt, compressed):
    mods = {"mha": (mha, jmha), "nrrd": (nrrd, jnrrd)}[fmt]
    arr = _volume(".mha", seed=1)
    paths = []
    for mod, img_mod in zip(mods, (image, jimage)):
        paths.append(str(tmp_path / f"{mod.__name__.split('.')[0]}.{fmt}"))
        mod.write(img_mod.MedicalImage(arr, spacing=(0.5, 0.6, 3.0)), paths[-1],
                  compressed=compressed)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(_read_both(paths[0]).array, arr)


def test_unknown_formats_fail_alike(tmp_path):
    """A file of no known format falls to the single-file DICOM reader and
    fails there the same way in both packages."""
    path = str(tmp_path / "x.xyz")
    with open(path, "wb") as f:
        f.write(b"not an image")
    with pytest.raises(Exception) as port_err:
        loader.load_input_image(path)
    with pytest.raises(Exception) as jax_err:
        jloader.load_input_image(path)
    assert type(port_err.value).__name__ == type(jax_err.value).__name__
    assert str(port_err.value) == str(jax_err.value)
    assert loader.get_DICOM_tags_to_keep() == jloader.get_DICOM_tags_to_keep()


# ---------------------------------------------------------------------------
# .nii.gz: level-9 slabs deflated on a thread pool into one gzip member

# Shapes whose NIfTI stream (352 + voxel bytes) is under one slab, exactly one
# 1 MiB slab, and three slabs plus a ragged tail, at every dtype below
# (32757 = 183 * 179).
SLAB_SHAPES = {
    "below": lambda itemsize: (3, 10, 12),
    "one_slab": lambda itemsize: (32 // itemsize, 183, 179),
    "three_slabs_tail": lambda itemsize: (104 // itemsize, 183, 179),
}


def _patterned(shape, dtype, seed=0):
    """Voxels with a period of 7000 and 2% noise: matches reach back across
    the slab cuts, as in a mask, without being trivial runs."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    arr = np.resize(rng.integers(-100, 100, 7000), n)
    arr[rng.choice(n, n // 50, replace=False)] = rng.integers(-100, 100, n // 50)
    if dtype == np.uint8:
        arr = np.abs(arr) % 7
    return arr.astype(dtype).reshape(shape)


def _nifti_image(shape, dtype, seed=0):
    return image.MedicalImage(_patterned(shape, dtype, seed), spacing=(0.7, 0.8, 2.5),
                              origin=(-10.0, 5.0, 2.0), direction=np.diag([1.0, -1.0, 1.0]))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
@pytest.mark.parametrize("size", sorted(SLAB_SHAPES))
def test_nifti_gz_one_member_round_trip(tmp_path, size, dtype):
    img = _nifti_image(SLAB_SHAPES[size](np.dtype(dtype).itemsize), dtype)
    stream = nifti.encode(img)
    slabs = -(-len(stream) // nifti._SLAB)
    assert slabs == {"below": 1, "one_slab": 1, "three_slabs_tail": 4}[size]
    assert (len(stream) == nifti._SLAB) == (size == "one_slab")
    path = str(tmp_path / "v.nii.gz")
    nifti.write(img, path)
    np.testing.assert_array_equal(_read_both(path).array, img.array)
    with open(path, "rb") as f:
        data = f.read()
    assert gzip.decompress(data) == stream
    member = zlib.decompressobj(31)  # one gzip member, nothing after it
    assert member.decompress(data) == stream
    assert member.eof and member.unused_data == b""
    assert data[:10] == b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x02\xff"  # mtime 0, no name, XFL 2
    # The first slab is zlib's level-9 raw deflate of the stream's first MiB.
    first = zlib.compressobj(9, zlib.DEFLATED, -15)
    head = first.compress(stream[: nifti._SLAB])
    head += first.flush(zlib.Z_FINISH if slabs == 1 else zlib.Z_SYNC_FLUSH)
    assert data[10 : 10 + len(head)] == head


@pytest.mark.parametrize("workers", [2, 4, 8])
def test_nifti_gz_bytes_do_not_depend_on_workers(tmp_path, workers):
    """The pool deflates the same slabs as one thread: the same file."""
    img = _nifti_image(SLAB_SHAPES["three_slabs_tail"](1), np.uint8, seed=3)
    one, many = io.BytesIO(), io.BytesIO()
    nifti._write_gz(one, nifti._stream(img), 1)
    nifti._write_gz(many, nifti._stream(img), workers)
    assert one.getvalue() == many.getvalue()
    path = str(tmp_path / "v.nii.gz")
    nifti.write(img, path)
    with open(path, "rb") as f:
        assert f.read() == one.getvalue()
    assert gzip.decompress(one.getvalue()) == nifti.encode(img)


def test_nifti_gz_slab_primed_with_previous_window():
    """A slab inflates only with the 32 KiB before it as its dictionary, and
    the file stays within 1% of one level-9 pass over the whole stream."""
    img = _nifti_image(SLAB_SHAPES["three_slabs_tail"](1), np.uint8, seed=5)
    stream, bufs, slab = nifti.encode(img), nifti._stream(img), nifti._SLAB
    second = nifti._deflate_slab(bufs, slab, 2 * slab, False)
    primed = zlib.decompressobj(-15, zdict=stream[slab - (1 << 15) : slab])
    assert primed.decompress(second) == stream[slab : 2 * slab]
    with pytest.raises(zlib.error, match="distance too far back"):
        zlib.decompressobj(-15).decompress(second)
    out = io.BytesIO()
    nifti._write_gz(out, bufs, 4)
    assert len(out.getvalue()) <= 1.01 * len(gzip.compress(stream, 9))


def test_nifti_deflate_counts(tmp_path):
    """An inline write (one slab) and a parallel one (four slabs, four
    workers) each count; so do writes from eight threads at once."""
    small = _nifti_image((3, 10, 12), np.int16)
    big = nifti._stream(_nifti_image(SLAB_SHAPES["three_slabs_tail"](1), np.uint8))
    before = nifti.deflate_counts()
    nifti.write(small, str(tmp_path / "small.nii.gz"))
    nifti._write_gz(io.BytesIO(), big, 4)
    nifti.write(small, str(tmp_path / "plain.nii"))  # not a gzip write
    after = nifti.deflate_counts()
    assert after["gzip_writes"] - before["gzip_writes"] == 2
    assert after["parallel_writes"] - before["parallel_writes"] == 1
    assert after["slabs"] - before["slabs"] == 1 + 4
    assert after["max_workers"] >= 4

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=nifti.write,
                                    args=(small, str(tmp_path / f"t{i}.nii.gz")))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    end = nifti.deflate_counts()
    assert end["gzip_writes"] - after["gzip_writes"] == 8
    assert end["slabs"] - after["slabs"] == 8


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_nii_bytes_equal_jax_encode(tmp_path, dtype):
    """The plain .nii writes the three buffers straight to the file: the
    same bytes as the JAX package's encode, header + 4 zeros + voxels."""
    img = _nifti_image(SLAB_SHAPES["one_slab"](np.dtype(dtype).itemsize), dtype)
    want = jnifti.encode(jimage.MedicalImage(img.array, spacing=img.spacing,
                                             origin=img.origin, direction=img.direction))
    assert nifti.encode(img) == want
    path = str(tmp_path / "v.nii")
    nifti.write(img, path)
    with open(path, "rb") as f:
        assert f.read() == want


# ---------------------------------------------------------------------------
# DICOM series: scan, assembly, writer
# ---------------------------------------------------------------------------


@pytest.fixture
def same_uids(monkeypatch):
    """One deterministic UID counter per package, so both writers draw the
    same UIDs."""
    for mod in (dicom, jdicom):
        counter = iter(range(1, 10**6))
        monkeypatch.setattr(mod, "generate_uid", lambda c=counter: f"{UID_ROOT}.{next(c)}")


def _slice(rng, hw=16):
    return rng.integers(-1000, 500, size=(hw, hw)).astype(np.int16)


def _cohort_dir(root, dicom_mod):
    """A directory a scanner must sort out: series A (2 slices), series B
    (4 slices, shuffled names, one in a subdirectory, one duplicated), a
    DERIVED slice, a localizer, a DICOMDIR, a text file."""
    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(root, "sub"))
    kw = dict(study_uid="1.2.3", spacing=(0.7, 0.7))
    for z in range(2):
        dicom_mod.write_slice(os.path.join(root, f"a{z}.dcm"), _slice(rng), series_uid="1.2.3.1",
                              sop_uid=f"1.2.3.1.{z}", position=(0.0, 0.0, 3.0 * z), **kw)
    for k, z in enumerate((2, 0, 3, 1)):
        name = os.path.join(root, "sub" if k == 3 else "", f"b_{k}.dcm")
        dicom_mod.write_slice(name, _slice(rng), series_uid="1.2.3.2", sop_uid=f"1.2.3.2.{z}",
                              position=(1.0, 2.0, -1.25 * z), tags={(0x0010, 0x0010): "DOE^J"},
                              **kw)
    shutil.copy(os.path.join(root, "b_0.dcm"), os.path.join(root, "b_dup.dcm"))
    dicom_mod.write_slice(os.path.join(root, "derived.dcm"), _slice(rng), series_uid="1.2.3.3",
                          image_type="DERIVED\\SECONDARY\\AXIAL", **kw)
    dicom_mod.write_slice(os.path.join(root, "loc.dcm"), _slice(rng), series_uid="1.2.3.4",
                          image_type="ORIGINAL\\PRIMARY\\LOCALIZER", **kw)
    dicom_mod.write_slice(os.path.join(root, "DICOMDIR"), _slice(rng), series_uid="1.2.3.5", **kw)
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("not a dicom")


@pytest.mark.parametrize("writer", sorted(PKGS))
@pytest.mark.parametrize("primary, original", [(True, True), (False, False)])
def test_scan_directory_equals_jax(tmp_path, writer, primary, original):
    _cohort_dir(str(tmp_path), {"jax": jdicom, "port": dicom}[writer])
    got = dicom.scan_directory(str(tmp_path), primary=primary, original=original,
                               disable_tqdm=True)
    want = jdicom.scan_directory(str(tmp_path), primary=primary, original=original,
                                 disable_tqdm=True)
    assert [[(h.path, h.tags) for h in s] for s in got] == [
        [(h.path, h.tags) for h in s] for s in want]
    sizes = sorted(len(s) for s in got)
    assert sizes == ([2, 4] if primary else [1, 2, 4])  # localizer, dup, DICOMDIR gone
    vols = loader.read_dicoms(str(tmp_path), primary=primary, original=original,
                              disable_tqdm=True, read_metadata=True)
    jvols = jloader.read_dicoms(str(tmp_path), primary=primary, original=original,
                                disable_tqdm=True, read_metadata=True)
    assert len(vols) == len(jvols)
    for v, jv in zip(vols, jvols):
        torch_parity.assert_same_image(v, jv)
    biggest = _read_both(str(tmp_path))  # the largest series wins
    assert biggest.array.shape == (4, 16, 16)
    assert biggest.spacing == (0.7, 0.7, 1.25)
    assert biggest.metadata == {}


@pytest.mark.parametrize(
    "tags",
    [{(0x0028, 0x0030): "0.7"}, {(0x0020, 0x0037): "1\\0\\0\\0"},
     {(0x0020, 0x0037): "a\\b\\c\\d\\e\\f"}, {(0x0020, 0x0037): "0\\1\\0\\0\\0\\-1"}],
    ids=["short_spacing", "short_orientation", "bad_orientation", "sagittal"],
)
def test_malformed_and_oblique_tags_equal_jax(tmp_path, tags):
    rng = np.random.default_rng(8)
    for z in range(3):
        dicom.write_slice(str(tmp_path / f"{z}.dcm"), _slice(rng), series_uid="1.5",
                          study_uid="1.4", position=(0.0, 0.0, 2.0 * z), tags=tags)
    _read_both(str(tmp_path))
    vols = loader.read_dicoms(str(tmp_path), read_metadata=True)
    torch_parity.assert_same_image(vols[0], jloader.read_dicoms(str(tmp_path),
                                                                read_metadata=True)[0])


def test_multiframe_file_equals_jax(tmp_path):
    rng = np.random.default_rng(9)
    path = str(tmp_path / "mf.dcm")
    dicom.write_slice(path, np.stack([_slice(rng) for _ in range(4)]), slice_thickness=2.5,
                      spacing=(0.7, 0.8), series_uid="1.6", study_uid="1.7")
    got = _read_both(path)
    assert got.array.shape == (4, 16, 16) and got.spacing == (0.8, 0.7, 2.5)


def test_empty_directory_exits_in_both(tmp_path):
    (tmp_path / "notes.txt").write_text("no dicom here")
    for load_mod in (loader, jloader):
        with pytest.raises(SystemExit, match="No dicoms found"):
            load_mod.load_input_image(str(tmp_path))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_write_dicom_series_equals_jax(tmp_path, same_uids, dtype):
    """The series writer drops the tags it recomputes (rescale, geometry,
    UIDs, file meta) and carries the rest, byte for byte as JAX's."""
    rng = np.random.default_rng(10)
    meta = {
        "0028|1052": "-1024",  # RescaleIntercept: would shift every mask value
        "0028|0100": "8",  # BitsAllocated
        "0008|0018": "9.9.9",  # SOPInstanceUID: fresh per slice
        "0020|000e": "9.9.8",  # SeriesInstanceUID: fresh
        "0002|0010": "1.2.840.10008.1.2.5",  # file meta: never copied
        "0010|0010": "DOE^JANE",  # patient tag: carried
        "0020|000d": "1.2.3.4",  # StudyInstanceUID: kept
        "0008|103e": "Created with lungmask",
        "0028|1050": "1",
        "0028|1051": "2",
        "junk": "not a tag",
    }
    arr = rng.integers(0, 3, size=(3, 16, 16)).astype(dtype)
    direction = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    for name, (img_mod, load_mod) in PKGS.items():
        (tmp_path / name).mkdir()
        img = img_mod.MedicalImage(arr, spacing=(0.7, 0.8, 2.5), origin=(1.0, 2.0, 3.0),
                                   direction=direction, metadata=dict(meta))
        load_mod.write_image(img, str(tmp_path / name / "mask.dcm"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == [f"mask_{z:04d}.dcm" for z in range(3)]
    assert names == sorted(os.listdir(tmp_path / "jax"))
    for leaf in names:
        with open(tmp_path / "port" / leaf, "rb") as a, open(tmp_path / "jax" / leaf, "rb") as b:
            assert a.read() == b.read()
    back = _read_both(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.array, arr.astype(np.int16))
    back = loader.read_dicoms(str(tmp_path / "port"), read_metadata=True)[0]
    assert back.metadata["0010|0010"] == "DOE^JANE"
    assert back.metadata["0020|000d"] == "1.2.3.4"
    assert back.metadata["0028|1052"] == "0.0" and back.metadata["0028|0100"] == "16"
    assert back.metadata["0020|000e"] != "9.9.8"
    np.testing.assert_allclose(back.direction, direction, atol=1e-12)
    assert back.spacing == (0.7, 0.8, 2.5)


# ---------------------------------------------------------------------------
# --noHU stacks and compat
# ---------------------------------------------------------------------------


def _png_stack(root, shapes):
    from PIL import Image

    rng = np.random.default_rng(11)
    for i, shape in enumerate(shapes):
        Image.fromarray(rng.integers(0, 256, size=shape).astype(np.uint8)).save(
            os.path.join(root, f"slice{i}.png"))


def test_nohu_equals_jax(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
    np.testing.assert_array_equal(nohu.to_pseudo_hu(x), jnohu.to_pseudo_hu(x))
    _png_stack(str(tmp_path), [(12, 10)] * 11)  # slice10 sorts after slice9
    (tmp_path / "notes.txt").write_text("ignored")
    got, want = nohu.load_image_directory(str(tmp_path)), jnohu.load_image_directory(str(tmp_path))
    torch_parity.assert_same_image(got, want)
    assert got.array.shape == (11, 12, 10) and got.array.dtype == np.int16
    frames = [Image.fromarray(np.full((6, 5), 40 * i, np.uint8)) for i in range(3)]
    tif = str(tmp_path / "stack.tif")
    frames[0].save(tif, save_all=True, append_images=frames[1:])
    torch_parity.assert_same_image(nohu.load_image_stack([tif]), jnohu.load_image_stack([tif]))


@pytest.mark.parametrize("case", ["shapes", "empty"])
def test_nohu_errors_equal_jax(tmp_path, case):
    pytest.importorskip("PIL")
    if case == "shapes":
        _png_stack(str(tmp_path), [(8, 8), (9, 8)])
    for mod in (nohu, jnohu):
        with pytest.raises(ValueError, match="inconsistent" if case == "shapes" else "no image"):
            mod.load_image_directory(str(tmp_path))


def _compat_vectors(mod):
    """The reference's unit-test vectors (tests/test_compat.py) through
    ``mod``'s compat layer."""
    m = np.zeros((10, 10, 10), dtype=np.uint8)
    m[2:8, 3:7, 4:6] = 1
    img = np.full((10, 10), -1000, dtype=np.int16)
    img[2:8, 3:7] = 1
    img[9, 9] = 1
    cropped, bb = mod.crop_and_resize(img, width=20, height=20)
    vol = np.repeat(img[None], 2, axis=0)
    pre, boxes = mod.preprocess(vol, resolution=[20, 20])
    two = np.zeros((6, 6, 6), np.uint8)
    two[0:2, 0:2, 0:2] = 1
    two[3:6, 3:6, 3:6] = 1
    return {
        "bbox": np.asarray(mod.bbox_3D(m, margin=2)),
        "bodymask": mod.simple_bodymask(img),
        "crop": cropped, "crop_box": np.asarray(bb),
        "pre": np.asarray(pre), "pre_boxes": np.asarray(boxes),
        "reshape": mod.reshape_mask(np.ones((10, 10), np.uint8), (2, 2, 22, 22), origsize=(30, 30)),
        "largest": mod.keep_largest_connected_component(two),
    }


def test_compat_vectors_equal_jax():
    got, want = _compat_vectors(compat), _compat_vectors(jcompat)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert tuple(got["bbox"]) == (0, 10, 1, 9, 2, 8)
    assert int(got["bodymask"].sum()) == 24
    assert tuple(got["crop_box"]) == (2, 3, 8, 7) and int(got["crop"].sum()) == 400
    assert got["reshape"].shape == (30, 30) and int(got["reshape"].sum()) == 400
    assert int(got["largest"].sum()) == 27


def test_compat_surface_equals_jax(tmp_path):
    assert compat.__all__ == jcompat.__all__
    for name in compat.__all__:
        assert getattr(compat, name) is not None
    assert compat.get_DICOM_tags_to_keep() == jcompat.get_DICOM_tags_to_keep()
    assert dict(compat.MODEL_URLS) == dict(jcompat.MODEL_URLS)
    from lungmask_tpu_torch.models import convert, synthetic

    path = str(tmp_path / "w.npz")
    convert.save_npz(path, synthetic.laterality_params(wf=2))
    runner = compat.get_model(modelpath=path, device="cpu")
    assert runner.device.type == "cpu" and runner.n_classes == 3
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compat.get_model(modelpath=path)
