"""Serve-lane stage profile: where an HTTP segmentation request spends time.

    python -m lungmask_tpu_torch.tools.serve_probe [N_VOLUMES] [THREADS] [--cpu]

The counterpart of the JAX package's ``tools/serve_probe.py`` on the port's
``runtime/serve.py``: uncompressed ``.nii`` uploads of the seeded
192-slice 512² phantom (``synthetic.lung_phantom``), THREADS concurrent
clients (3) posting N_VOLUMES (9) of them to a server in this process, the
full-width band-threshold weights (``synthetic.threshold_params``) and
device postprocessing. Prints one JSON object: volumes/hour and the
per-volume stage breakdown of ``InferenceService.stats`` (spool, decode,
preprocess, lock wait, device, finish, encode). The inferer is warmed by
one ``apply`` first. Run it alone: a concurrent process inflates every host
stage.

``--cpu`` runs a tiny phantom (6 slices of 64², wf 2) on the CPU; its times
are the CPU's and say nothing about the card.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

from lungmask_tpu_torch.inferer import LMInferer
from lungmask_tpu_torch.io.image import MedicalImage
from lungmask_tpu_torch.io.loader import write_image
from lungmask_tpu_torch.logger import logger
from lungmask_tpu_torch.models import convert, synthetic
from lungmask_tpu_torch.runtime.serve import make_server

TINY = {"slices": 6, "size": 64, "wf": 2}  # the --cpu size


def run(n: int = 9, threads: int = 3, *, slices: int = 192, size: int = 512, wf: int = 6,
        device=None) -> dict:
    """POST ``n`` uploads of the phantom from ``threads`` clients; the
    service's stage seconds per volume and the wall."""
    vol = synthetic.lung_phantom(slices, size=size)
    with tempfile.TemporaryDirectory() as td:
        wpath = os.path.join(td, "w.npz")
        convert.save_npz(wpath, synthetic.threshold_params(n_classes=3, wf=wf))
        inferer = LMInferer(modelpath=wpath, tqdm_disable=True, postprocessing_mode="device",
                            device=device)
        t0 = time.perf_counter()
        inferer.apply(vol)  # warm
        warm = time.perf_counter() - t0
        p = os.path.join(td, "vol.nii")
        write_image(MedicalImage(vol), p)
        with open(p, "rb") as f:
            payload = f.read()

    httpd, service = make_server(inferer, port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = (f"http://127.0.0.1:{httpd.server_address[1]}/v1/segment"
           "?name=vol.nii&out=.nii")
    # Transport-level failures only: every reply the server sent, an error
    # status included, is already counted in service.metrics()["errors"].
    transport_errors = [0]
    jobs = list(range(n))
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                if not jobs:
                    return
                jobs.pop()
            try:
                req = urllib.request.Request(url, data=payload, method="POST")
                with urllib.request.urlopen(req, timeout=600) as r:
                    r.read()
            except urllib.error.HTTPError as e:
                print(f"server error reply: {e.code}", file=sys.stderr)
            except OSError as e:
                print(f"client error: {e!r}", file=sys.stderr)
                with lock:
                    transport_errors[0] += 1

    try:
        t0 = time.perf_counter()
        workers = [threading.Thread(target=client) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join()

    m = service.metrics()
    done = max(m["volumes_segmented"], 1)
    return {
        "device": inferer.device.type,
        "volumes": n,
        "threads": threads,
        "slices": slices,
        "size": size,
        "segmented": m["volumes_segmented"],
        "errors": m["errors"],
        "transport_errors": transport_errors[0],
        "warm_apply_s": warm,
        "wall_s": wall,
        "vph": n / wall * 3600.0,
        "sec_per_vol_wall": wall / n,
        "stages_per_vol": {k: v / done for k, v in m.items() if k.endswith("_seconds")},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_volumes", nargs="?", type=int, default=9)
    ap.add_argument("threads", nargs="?", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="a tiny phantom on the CPU (times are the CPU's)")
    args = ap.parse_args(argv)
    if "LUNGMASK_TPU_LOGLEVEL" not in os.environ:  # keep the request log off stdout
        logger.setLevel(logging.WARNING)
    size = TINY if args.cpu else {}
    result = run(args.n_volumes, args.threads, device="cpu" if args.cpu else None, **size)
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
