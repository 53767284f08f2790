"""The port's HTTP serving lane: routes, NIfTI round trips equal to
``apply`` and to the JAX service, concurrent requests, the in-memory lane
against the spool lane, zipped DICOM series uploads, ``.dcm`` and the other
response formats, and client errors.

Tolerance: none — masks are compared voxel for voxel (decoded, since the
gzip header of a .nii.gz embeds a timestamp).
"""

import io
import json
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
import lungmask_tpu
from lungmask_tpu.runtime.serve import InferenceService as JaxService
from lungmask_tpu_torch import LMInferer, cli
from lungmask_tpu_torch.io import dicom, loader
from lungmask_tpu_torch.io.image import MedicalImage
from lungmask_tpu_torch.models import convert, synthetic
from lungmask_tpu_torch.runtime import serve

F32 = dict(precision="float32", tqdm_disable=True, batch_size=2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "laterality_wf2.npz")
    convert.save_npz(path, synthetic.laterality_params(wf=2))
    return path


@pytest.fixture(scope="module")
def server(weights):
    inferer = LMInferer(modelpath=weights, device="cpu", **F32)
    httpd, service = serve.make_server(inferer, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", service
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _vol(n=2, size=64):
    return synthetic.lung_phantom(n, size=size)


def _nii_bytes(vol, ext=".nii.gz"):
    return loader.encode_image_bytes(MedicalImage(vol, spacing=(0.7, 0.7, 2.5)), ext)


def _mask(body, ext=".nii.gz"):
    return loader.load_input_bytes(bytearray(body), "m" + ext).array


def test_health_models_metrics(server):
    base, _ = server
    status, health = _get(base + "/healthz")
    assert status == 200 and health["status"] == "ok" and health["backend"] == "cpu"
    assert health["postprocessing_mode"] == "exact"
    status, models = _get(base + "/v1/models")
    assert status == 200 and models["R231"]["n_classes"] == 3
    status, metrics = _get(base + "/metrics")
    assert status == 200 and "volumes_segmented" in metrics and "lock_wait_seconds" in metrics
    assert _get(base + "/nope")[0] == 404


@pytest.mark.parametrize("size", [64, 160])
def test_segment_nii_roundtrip_equals_apply_and_jax(server, weights, size):
    base, service = server
    vol = _vol(size=size)
    status, body, ctype = _post(base + "/v1/segment?name=v.nii.gz", _nii_bytes(vol))
    assert status == 200, body
    assert ctype == "application/octet-stream"
    got = _mask(body)
    assert got.shape == vol.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, service.inferer.apply(vol))
    jax_service = JaxService(lungmask_tpu.LMInferer(modelpath=weights, **F32))
    jbody, _ = jax_service.segment_bytes(_nii_bytes(vol), "v.nii.gz", ".nii.gz")
    np.testing.assert_array_equal(got, _mask(jbody))
    assert service.metrics()["volumes_segmented"] >= 1


def test_concurrent_requests_identical(server):
    base, service = server
    payload = _nii_bytes(_vol(n=3))
    results = [None] * 3

    def hit(i):
        results[i] = _post(base + "/v1/segment?name=v.nii.gz", payload)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert all(r[0] == 200 for r in results)
    masks = [_mask(r[1]) for r in results]
    for m in masks[1:]:
        np.testing.assert_array_equal(m, masks[0])
    np.testing.assert_array_equal(masks[0], service.inferer.apply(_vol(n=3)))


def test_memory_lane_matches_spool_lane(server, tmp_path, monkeypatch):
    """The in-memory lane (decode from the request buffer, encode without a
    temp file) returns the same voxels as the spool-to-scratch lane (forced
    by ``LUNGMASK_TPU_SERVE_SPOOL_DIR``)."""
    base, _ = server
    masks = {}
    for lane in ("memory", "spool"):
        if lane == "spool":
            monkeypatch.setenv("LUNGMASK_TPU_SERVE_SPOOL_DIR", str(tmp_path / "sp"))
        else:
            monkeypatch.delenv("LUNGMASK_TPU_SERVE_SPOOL_DIR", raising=False)
        for ext in (".nii", ".nii.gz"):
            status, body, _ = _post(
                base + f"/v1/segment?name=v{ext}&out={ext}", _nii_bytes(_vol(), ext)
            )
            assert status == 200, body
            masks[(lane, ext)] = _mask(body, ext)
    assert (tmp_path / "sp").is_dir() and not any((tmp_path / "sp").iterdir())
    for ext in (".nii", ".nii.gz"):
        np.testing.assert_array_equal(masks[("memory", ext)], masks[("spool", ext)])


def _series_zip(vol, tmp_path):
    """A zipped DICOM series whose slices sit in two archive folders under
    clashing leaf names (the lane flattens and renames them)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for z, sl in enumerate(vol):
            path = str(tmp_path / f"slice{z}.dcm")
            dicom.write_slice(path, sl, series_uid="1.2.826.9.2", study_uid="1.2.826.9.1",
                              position=(0.0, 0.0, 2.5 * z), spacing=(0.7, 0.7),
                              slice_thickness=2.5)
            zf.write(path, f"../part{z % 2}/IM{z // 2:04d}")
        zf.writestr("part0/", b"")
    return buf.getvalue()


def test_dicom_and_other_formats_answer_501(server, weights, tmp_path):
    """What answered 501 before the DICOM and format readers were ported is
    served now: a zipped series upload (200, equal to ``apply`` and to the
    JAX service), ``out=.dcm`` (a zip of a series) and ``.mha`` both ways.
    A zip without DICOM is a client error (400), never a dead request."""
    base, service = server
    vol = _vol(n=3)
    want = service.inferer.apply(vol)
    upload = _series_zip(vol, tmp_path)
    status, body, ctype = _post(base + "/v1/segment?name=series.zip", upload)
    assert status == 200 and ctype == "application/octet-stream", body
    np.testing.assert_array_equal(_mask(body), want)
    jax_service = JaxService(lungmask_tpu.LMInferer(modelpath=weights, **F32))
    jbody, _ = jax_service.segment_bytes(upload, "series.zip", ".nii.gz")
    np.testing.assert_array_equal(_mask(body), _mask(jbody))

    status, body, ctype = _post(base + "/v1/segment?name=v.nii.gz&out=.dcm", _nii_bytes(vol))
    assert status == 200 and ctype == "application/zip", body
    with zipfile.ZipFile(io.BytesIO(body)) as zf:
        assert zf.namelist() == [f"mask_{z:04d}.dcm" for z in range(3)]
        zf.extractall(tmp_path / "dcm")
    np.testing.assert_array_equal(loader.load_input_image(str(tmp_path / "dcm")).array, want)

    status, body, _ = _post(base + "/v1/segment?name=v.nii.gz&out=.mha", _nii_bytes(vol))
    assert status == 200
    (tmp_path / "m.mha").write_bytes(body)
    np.testing.assert_array_equal(loader.load_input_image(str(tmp_path / "m.mha")).array, want)
    loader.write_image(MedicalImage(vol, spacing=(0.7, 0.7, 2.5)), str(tmp_path / "v.mha"))
    status, body, _ = _post(base + "/v1/segment?name=v.mha", (tmp_path / "v.mha").read_bytes())
    assert status == 200
    np.testing.assert_array_equal(_mask(body), want)

    before = service.metrics()["errors"]
    empty = io.BytesIO()
    with zipfile.ZipFile(empty, "w") as zf:
        zf.writestr("notes.txt", b"no dicom here")
    status, body, _ = _post(base + "/v1/segment?name=series.zip", empty.getvalue())
    assert status == 400 and b"No dicoms found" in body
    status, body, _ = _post(base + "/v1/segment?name=series.zip", b"not a zip")
    assert status == 400 and b"bad zip" in body
    assert service.metrics()["errors"] == before + 2


def test_zip_bomb_is_refused(server):
    """A zipped upload is admitted on its compressed length; what it would
    unpack to is held to the upload cap before anything is extracted."""
    base, service = server
    bomb = io.BytesIO()
    with zipfile.ZipFile(bomb, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("IM0001", b"\x00" * (1 << 20))
    assert len(bomb.getvalue()) < 4096
    orig_cap = service.max_upload_bytes
    before = service.metrics()["errors"]
    try:
        service.max_upload_bytes = 64 << 10
        status, body, _ = _post(base + "/v1/segment?name=series.zip", bomb.getvalue())
        assert status == 400 and b"unpacks to 1048576 bytes" in body
        with pytest.raises(ValueError, match="above the limit"):
            service.segment_bytes(bomb.getvalue(), "series.zip", ".nii.gz")
    finally:
        service.max_upload_bytes = orig_cap
    assert service.metrics()["errors"] == before + 1


def test_segment_client_errors(server):
    base, service = server
    before = service.metrics()["errors"]
    status, body, _ = _post(base + "/v1/segment?out=.xyz", _nii_bytes(_vol()))
    assert status == 400 and b"unsupported" in body
    status, body, _ = _post(base + "/v1/segment?name=v.nii.gz", b"not a nifti")
    assert status == 400
    status, body, _ = _post(base + "/v1/segment?name=v.nii.gz", b"")
    assert status == 400
    assert _post(base + "/v2/segment", b"x")[0] == 404
    status, body, _ = _post(base + "/v1/segment?model=LTRCLobes", _nii_bytes(_vol()))
    assert status == 400 and b"this server runs" in body
    orig_cap = service.max_upload_bytes
    try:
        service.max_upload_bytes = 16
        status, body, _ = _post(base + "/v1/segment?name=v.nii.gz", b"x" * 64)
        assert status == 413 and b"limit" in body
    finally:
        service.max_upload_bytes = orig_cap
    assert service.metrics()["errors"] == before + 5


def test_hostile_name_and_truncated_stream(server):
    base, service = server
    status, _, _ = _post(base + "/v1/segment?name=..", b"\x00" * 64)
    assert status == 400  # taken as volume.nii.gz: a decode error, never an escape

    class Short:
        def __init__(self, data):
            self.data, self.pos = data, 0

        def read(self, n):
            chunk = self.data[self.pos : self.pos + n]
            self.pos += len(chunk)
            return chunk

    with pytest.raises(ValueError, match="truncated"):
        service.segment_stream(Short(b"abc"), 100, "v.nii.gz", ".nii.gz")


def test_device_mode_service_health(weights):
    inferer = LMInferer(modelpath=weights, device="cpu", postprocessing_mode="device", **F32)
    service = serve.InferenceService(inferer)
    assert service.health()["postprocessing_mode"] == "device"
    body, _ = service.segment_bytes(_nii_bytes(_vol()), "v.nii.gz", ".nii")
    np.testing.assert_array_equal(_mask(body, ".nii"), inferer.apply(_vol()))


def test_cli_serve_and_warmup(weights, monkeypatch):
    """``--serve`` parses HOST:PORT and hands the (warmed) inferer to
    serve_forever; ``--warmup`` alone runs the phantom and returns."""
    seen = {}

    def fake_serve(inferer, host, port):
        seen.update(inferer=inferer, host=host, port=port)

    monkeypatch.setattr(serve, "serve_forever", fake_serve)
    args = ["--modelpath", weights, "--cpu", "--noprogress"]
    cli.main(["--serve", "0.0.0.0:9123", "--postprocessing", "device", *args])
    assert (seen["host"], seen["port"]) == ("0.0.0.0", 9123)
    assert seen["inferer"].postprocessing_mode == "device"
    cli.main(["--warmup", "2", "--serve", "9124", *args])
    assert (seen["host"], seen["port"]) == ("127.0.0.1", 9124)
    assert seen["inferer"].timings.counts["unet"] == 2  # the warm inferer goes on
    cli.main(["--warmup", "1", *args])
    with pytest.raises(SystemExit):
        cli.main(["--serve", "nope", *args])
    with pytest.raises(SystemExit):
        cli.main(["--modelpath", weights, "--cpu"])  # neither input/output nor a lane
