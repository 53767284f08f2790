"""HTTP serving lane: segment CT volumes over a REST endpoint (the port of
``lungmask_tpu.runtime.serve``).

The reference ships no serving surface (its entry points are the CLI and the
``LMInferer`` library API). This lane uses the same split-phase pipeline as
the cohort runtime (``runtime/cohort.py``): request threads run host
decoding, preprocessing and postprocessing concurrently, while device
forwards serialize through one lock, so the GPU stays busy without two
requests' U-Nets interleaving.

Stdlib only (``http.server``). Start from the CLI::

    lungmask-torch --serve 8080                       # or HOST:PORT
    lungmask-torch --serve 8080 --modelname LTRCLobes_R231 --postprocessing device

Endpoints:

``GET /healthz``
    ``{"status": "ok", "model": ..., "backend": "cuda" | "cpu"}``: liveness
    and configuration.
``GET /v1/models``
    The model registry (name → n_classes).
``GET /metrics``
    JSON counters: requests, errors, volumes segmented, per-stage seconds.
``POST /v1/segment?name=<filename>&out=<ext>``
    Body is the volume file's bytes. ``name`` names the upload (its
    extension selects the reader; defaults to ``volume.nii.gz``); a ``.zip``
    upload is unpacked and scanned as a DICOM series directory. ``out``
    selects the response format (default ``.nii.gz``); ``out=.dcm`` returns
    a zip of the output DICOM series. The response body is the mask file's
    bytes. A zip that holds no DICOM series is a client error (400), where
    the JAX lane lets the loader's ``SystemExit`` end the request thread
    without a reply.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import tempfile
import threading
import time
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from lungmask_tpu_torch.logger import logger

# Single-file response formats (pair-writing formats like .mhd/.nhdr/.hdr
# would drop their data half; .dcm is special-cased to a zipped series).
_SINGLE_FILE_OUT = (".nii", ".nii.gz", ".mha", ".nrrd", ".gipl", ".vtk")


def _free_ram() -> int:
    """Bytes of physical memory free now (0 where the OS does not say)."""
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return 0


def _spool_dir() -> Optional[str]:
    """``LUNGMASK_TPU_SERVE_SPOOL_DIR`` when set and usable (it also turns
    the in-memory lane off), else None: the default temp dir."""
    override = os.environ.get("LUNGMASK_TPU_SERVE_SPOOL_DIR")
    if not override:
        return None
    try:
        os.makedirs(override, exist_ok=True)
        return override
    except OSError as e:
        logger.warning(
            f"serve: LUNGMASK_TPU_SERVE_SPOOL_DIR={override!r} unusable ({e}); "
            "falling back to the default temp dir"
        )
        return None


def _safe_name(name: str) -> str:
    """Sanitize a client-supplied upload name: it selects the decoder by
    extension and names the spool file, so it must not escape the scratch
    dir or smuggle path separators."""
    base = os.path.basename(name)
    if base in ("", ".", "..") or any(c in base for c in "/\\\x00"):
        return "volume.nii.gz"  # untrusted name must stay inside tmp
    return base


class InferenceService:
    """Thread-safe segmentation service around one :class:`LMInferer`.

    Host phases (decode, preprocess, postprocess, encode) run on the calling
    thread; the device forward is serialized by ``_device_lock``, the same
    overlap structure as the cohort pipeline, driven by request threads
    instead of a fixed 3-stage crew.
    """

    def __init__(self, inferer, max_upload_mb: int = 2048):
        self.inferer = inferer
        # A 512-slice 512x512 int16 series is ~260 MB; 2 GB covers any real
        # CT upload while bounding what one request can make us buffer.
        self.max_upload_bytes = max_upload_mb * 1024 * 1024
        self._device_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        # Admission: the free-RAM probe and the reservation update happen
        # under one lock, so concurrent uploads cannot all pass one probe.
        self._reserve_lock = threading.Lock()
        self._ram_reserved = 0
        self.stats = {
            "requests": 0,
            "errors": 0,
            "volumes_segmented": 0,
            "busy_seconds": 0.0,
            "device_seconds": 0.0,
            # Per-stage request breakdown (summed seconds), the serving
            # lane's CohortStats.stage_seconds; lock_wait vs device tells
            # queueing from compute.
            "spool_seconds": 0.0,
            "decode_seconds": 0.0,
            "preprocess_seconds": 0.0,
            "lock_wait_seconds": 0.0,
            "finish_seconds": 0.0,
            "encode_seconds": 0.0,
        }

    def _count(self, key, value=1):
        with self._stats_lock:
            self.stats[key] += value

    def segment_bytes(self, body: bytes, name: str, out_ext: str) -> Tuple[bytes, str]:
        """Segment an in-memory upload (see :meth:`segment_stream`)."""
        return self.segment_stream(io.BytesIO(body), len(body), name, out_ext)

    def segment_stream(self, stream, length: int, name: str, out_ext: str) -> Tuple[bytes, str]:
        """Segment an uploaded volume; returns (response bytes, content type).

        ``stream`` is read for exactly ``length`` bytes, either into memory
        (NIfTI, when ~3× the upload fits in free RAM beside what other
        requests reserved) or into a scratch file (the spool lane, which a
        zipped series always takes). Raises ``ValueError`` for client errors
        (bad format, extension or bytes, a zip without DICOM).
        """
        from lungmask_tpu_torch.io import loader

        out_ext = out_ext.lower()
        if out_ext not in _SINGLE_FILE_OUT + (".dcm",):
            raise ValueError(
                f"out={out_ext!r} unsupported (supported: {', '.join(_SINGLE_FILE_OUT)}, .dcm)"
            )
        safe = _safe_name(name)
        t0 = time.monotonic()
        spool = _spool_dir()
        need = length * 3
        with self._reserve_lock:
            reserved = 0
            if spool is None and loader.supports_memory_io(safe):
                if _free_ram() - self._ram_reserved > need + (1 << 30):
                    reserved = need
                    self._ram_reserved += reserved
        tmp = None
        try:
            if reserved:
                buf = self._slurp(stream, length)
                t1 = time.monotonic()
                self._count("spool_seconds", t1 - t0)
                image = self._decode(lambda: loader.load_input_bytes(buf, safe), name)
            else:
                tmp = tempfile.mkdtemp(prefix="lungmask_serve_", dir=spool)
                src = self._materialize(stream, length, safe, tmp)
                t1 = time.monotonic()
                self._count("spool_seconds", t1 - t0)
                image = self._decode(lambda: loader.load_input_image(src), name)
            t2 = time.monotonic()
            self._count("decode_seconds", t2 - t1)
            pre = self.inferer.preprocess_image(image)
            t_dev = time.monotonic()
            self._count("preprocess_seconds", t_dev - t2)
            with self._device_lock:
                t_lock = time.monotonic()
                self._count("lock_wait_seconds", t_lock - t_dev)
                pred = self.inferer.forward_preprocessed(pre)
            t3 = time.monotonic()
            self._count("device_seconds", t3 - t_lock)
            mask = self.inferer.finish_forward(pre, pred)
            result = image.with_array(mask)
            result.metadata = {}
            t4 = time.monotonic()
            self._count("finish_seconds", t4 - t3)
            if loader.supports_memory_io(out_ext):
                payload = loader.encode_image_bytes(result, out_ext)
            else:
                if tmp is None:
                    tmp = tempfile.mkdtemp(prefix="lungmask_serve_", dir=spool)
                payload = self._encode(result, out_ext, tmp)
            self._count("encode_seconds", time.monotonic() - t4)
            self._count("volumes_segmented")
            self._count("busy_seconds", time.monotonic() - t0)
            return payload, "application/zip" if out_ext == ".dcm" else "application/octet-stream"
        finally:
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
            if reserved:
                with self._reserve_lock:
                    self._ram_reserved -= reserved

    @staticmethod
    def _decode(read, name: str):
        """Run a decoder; malformed upload bytes surface as format-specific
        errors (BadGzipFile, struct truncations, ...), which are client
        errors, not server faults. So does the loader's ``SystemExit`` for a
        directory without DICOM: it must not end the request thread."""
        try:
            return read()
        except ValueError:
            raise
        except (OSError, EOFError, KeyError, IndexError, SystemExit) as e:
            raise ValueError(f"could not decode {name!r}: {e}") from e

    def _slurp(self, stream, length: int) -> bytearray:
        """Read exactly ``length`` body bytes into one RAM buffer (the
        in-memory lane; the decoder aliases the buffer without a copy)."""
        buf = bytearray(length)
        view = memoryview(buf)
        readinto = getattr(stream, "readinto", None)
        got = 0
        while got < length:
            window = view[got : got + (8 << 20)]
            if readinto is not None:
                n = readinto(window)
            else:
                chunk = stream.read(len(window))
                n = len(chunk)
                window[:n] = chunk
            if not n:
                raise ValueError(f"truncated upload ({got} of {length} bytes)")
            got += n
        return buf

    def _materialize(self, stream, length: int, name: str, tmp: str) -> str:
        """Spool the upload into ``tmp``; returns the path to load (a zip is
        unpacked into a series directory). ``name`` must already be
        sanitized (:func:`_safe_name`)."""
        is_zip = name.lower().endswith(".zip")
        upload = os.path.join(tmp, "upload.bin" if is_zip else name)
        remaining = length
        with open(upload, "wb") as f:
            while remaining > 0:
                # 8 MB chunks: a 100 MB upload is ~13 GIL round-trips.
                chunk = stream.read(min(remaining, 8 << 20))
                if not chunk:
                    raise ValueError(f"truncated upload ({length - remaining} of {length} bytes)")
                f.write(chunk)
                remaining -= len(chunk)
        if not is_zip:
            return upload
        series_dir = os.path.join(tmp, "series")
        os.makedirs(series_dir)
        try:
            with zipfile.ZipFile(upload) as zf:
                members = [
                    (i, info, os.path.basename(info.filename))
                    for i, info in enumerate(zf.infolist())
                    if os.path.basename(info.filename) and not info.is_dir()
                ]
                # A zip bomb is admitted on its compressed length: bound what
                # it unpacks to (the declared sizes, which zipfile never reads
                # past) by the upload cap and by the spool's free disk.
                total = sum(info.file_size for _, info, _ in members)
                room = shutil.disk_usage(series_dir).free
                if total > min(self.max_upload_bytes, room):
                    raise ValueError(
                        f"zip upload unpacks to {total} bytes, above the limit "
                        f"of {min(self.max_upload_bytes, room)}"
                    )
                for i, info, leaf in members:
                    # Flatten and sanitize: member paths from the client are
                    # untrusted and must not escape the scratch dir. The
                    # index prefix keeps same-named leaves of different
                    # archive folders apart (the DICOM scan keys slices by
                    # UID and position, not by name).
                    with zf.open(info) as f, open(
                        os.path.join(series_dir, f"{i:05d}_{leaf}"), "wb"
                    ) as o:
                        shutil.copyfileobj(f, o)
        except zipfile.BadZipFile as e:
            raise ValueError(f"bad zip upload: {e}") from e
        return series_dir

    def _encode(self, result, out_ext: str, tmp: str) -> bytes:
        from lungmask_tpu_torch.io import loader

        if out_ext == ".dcm":
            out_dir = os.path.join(tmp, "out")
            os.makedirs(out_dir)
            loader.write_dicom_series(result, os.path.join(out_dir, "mask.dcm"))
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
                for leaf in sorted(os.listdir(out_dir)):
                    zf.write(os.path.join(out_dir, leaf), leaf)
            return buf.getvalue()
        out_path = os.path.join(tmp, "mask" + out_ext)
        loader.write_image(result, out_path)
        with open(out_path, "rb") as f:
            return f.read()

    def health(self) -> dict:
        inf = self.inferer
        return {
            "status": "ok",
            "model": inf.modelname,
            "fillmodel": inf.fillmodel,
            "postprocessing_mode": getattr(inf, "postprocessing_mode", "exact"),
            "backend": inf.device.type,
        }

    def metrics(self) -> dict:
        with self._stats_lock:
            return dict(self.stats)


def _make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        # Keep-alive so one client can stream a cohort of volumes over a
        # single connection (error replies opt out, see _reply).
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route to our logger, not stderr
            logger.info("serve: " + fmt % args)

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if code >= 400:
                # Error replies may go out before the request body is
                # drained; keeping such a connection alive would desync the
                # next pipelined request.
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._reply_json(200, service.health())
            elif path == "/v1/models":
                from lungmask_tpu_torch.models.registry import MODEL_URLS

                self._reply_json(200, {k: {"n_classes": v[1]} for k, v in MODEL_URLS.items()})
            elif path == "/metrics":
                self._reply_json(200, service.metrics())
            else:
                self._reply_json(404, {"error": f"no route {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/v1/segment":
                self._reply_json(404, {"error": f"no route {url.path}"})
                return
            service._count("requests")
            q = parse_qs(url.query)
            name = q.get("name", ["volume.nii.gz"])[0]
            out_ext = q.get("out", [".nii.gz"])[0]
            if not out_ext.startswith("."):
                out_ext = "." + out_ext
            want_model = q.get("model", [None])[0]
            have = service.inferer.modelname
            if service.inferer.fillmodel:
                have = f"{have}_{service.inferer.fillmodel}"
            if want_model is not None and want_model != have:
                # One server binds one (possibly fused) model; routing a
                # request for another would silently return the wrong labels.
                service._count("errors")
                self._reply_json(
                    400,
                    {"error": f"this server runs model {have!r}, not {want_model!r} "
                     "(start one with --modelname)"},
                )
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length <= 0:
                    raise ValueError("empty request body")
                if length > service.max_upload_bytes:
                    service._count("errors")
                    self._reply_json(
                        413,
                        {"error": f"upload of {length} bytes exceeds the "
                         f"{service.max_upload_bytes}-byte limit"},
                    )
                    return
                payload, ctype = service.segment_stream(self.rfile, length, name, out_ext)
                self._reply(200, payload, ctype)
            except ValueError as e:
                service._count("errors")
                logger.info(f"serve: rejected request: {e}")
                self._reply_json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — a request must never kill the server
                service._count("errors")
                logger.warning(f"serve: internal error: {e!r}")
                self._reply_json(500, {"error": f"internal error: {e!r}"})

    return Handler


def make_server(
    inferer, host: str = "127.0.0.1", port: int = 8080, max_upload_mb: int = 2048
) -> Tuple[ThreadingHTTPServer, InferenceService]:
    """Build (but do not start) the HTTP server; port 0 picks a free port."""
    service = InferenceService(inferer, max_upload_mb=max_upload_mb)
    httpd = ThreadingHTTPServer((host, port), _make_handler(service))
    return httpd, service


def serve_forever(inferer, host: str = "127.0.0.1", port: int = 8080) -> None:
    """Blocking entry point of ``lungmask-torch --serve`` (``--warmup``
    warms the inferer before it comes here)."""
    httpd, _ = make_server(inferer, host, port)
    actual = httpd.server_address
    logger.info(f"serving on http://{actual[0]}:{actual[1]} (POST /v1/segment)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        httpd.server_close()
