"""Build and load of the port's hand-written CUDA kernels.

Each kernel source (``lungmask_tpu_torch/csrc/*.cu``) has a plain C
interface. :func:`build` compiles it with ``nvcc -gencode
arch=compute_90a,code=sm_90a -shared`` into ``lungmask_tpu_torch/_build/``
on first use (again when the source is newer than the library), under the
native core's build lock, and loads it with ctypes; ptxas's report of each
kernel's registers, shared memory and spills (``-Xptxas -v``) is kept
beside the library (:func:`ptxas_report`). The caller declares the
launchers' ``argtypes`` and keeps the library. Nothing here runs at import:
a machine without ``nvcc`` imports the kernel modules and runs their plain
versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

from lungmask_tpu_torch.ops.native import BUILD_DIR, build_lock

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "csrc"
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        home and os.path.join(home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def build(source: str, libname: str) -> ctypes.CDLL:
    """Compile ``source`` (when missing or older than it) into
    ``_build/<libname>.so`` and load it."""
    out = os.path.join(BUILD_DIR, f"{libname}.so")
    with build_lock(out):
        if not os.path.exists(out) or os.path.getmtime(source) > os.path.getmtime(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [
                _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, source,
            ]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
            with open(out + ".ptxas", "w") as fh:
                fh.write(res.stderr)
            os.replace(tmp, out)
    return ctypes.CDLL(out)


def ptxas_report(libname: str) -> str:
    """ptxas's lines for each kernel of ``_build/<libname>.so`` (the entry
    function, then its registers, spills and shared memory), as the last
    build wrote them; empty when that build left no report."""
    path = os.path.join(BUILD_DIR, f"{libname}.so.ptxas")
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        keep = [ln.strip() for ln in fh if "entry function" in ln or "Used" in ln
                or "spill" in ln]
    return "\n".join(keep)
