"""The inference runtime (counterpart of ``lungmask_tpu.runtime``): the
U-Net engine and the host-heap policy of the inference working set.

The JAX package's ``enable_compile_cache`` and ``start_cache_telemetry``
have no counterpart: they serve XLA's compile cache.
"""

import os

from lungmask_tpu_torch.runtime.engine import UNetRunner, volume_argmax

_alloc_tuned = False


def tune_host_allocator() -> bool:
    """Keep large host buffers on the heap across calls (idempotent).

    glibc malloc services allocations above ~32 MB with mmap and returns the
    pages to the kernel on free, so every inference call faults its working
    set (mask canvases, unpacked class maps, postprocessing scratch: ~250 MB
    for a fused 192-slice volume) back in. ``mallopt(M_MMAP_MAX, 0)`` and a
    1 GiB trim threshold make the heap retain and reuse those pages; the
    residency cost is a few hundred MB. Process-wide and not undone. Torch's
    CUDA caching allocator and pinned host memory do not go through malloc.
    Opt out with LUNGMASK_TPU_NO_MALLOC_TUNING=1. Returns whether the policy
    is in force.
    """
    global _alloc_tuned
    if _alloc_tuned:
        return True
    if os.environ.get("LUNGMASK_TPU_NO_MALLOC_TUNING") == "1":
        return False
    try:
        import ctypes

        libc = ctypes.CDLL(None)
        M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4
        ok = libc.mallopt(M_MMAP_MAX, 0) == 1
        ok &= libc.mallopt(M_TRIM_THRESHOLD, 1 << 30) == 1
        _alloc_tuned = bool(ok)
    except (OSError, AttributeError):  # no libc, or one without mallopt
        _alloc_tuned = False
    return _alloc_tuned


_prefaulted_mb = 0


def prefault_host_heap(mb: int | None = None) -> int:
    """Grow and pre-touch the process heap once so the inference working set
    never first-faults inside a timed stage (idempotent up to the largest
    request).

    On virtualized hosts with lazily backed guest memory the first touch of
    a physical page can cost far more than a later one. With the heap
    retained (:func:`tune_host_allocator`), touching a pool of this size
    once makes every later large allocation recycle pages already backed.
    Returns the MB actually pre-faulted. Sizing: a 512-slice 512² fused
    volume peaks around 700 MB of transient host buffers; the default covers
    the common 192–320 slice volumes. Override with LUNGMASK_TPU_PREFAULT_MB
    (0 disables).
    """
    global _prefaulted_mb
    if mb is None:
        mb = int(os.environ.get("LUNGMASK_TPU_PREFAULT_MB", "384"))
    if mb <= _prefaulted_mb:
        return _prefaulted_mb
    tune_host_allocator()
    try:
        import ctypes

        libc = ctypes.CDLL(None)
        libc.malloc.restype = ctypes.c_void_p
        libc.malloc.argtypes = [ctypes.c_size_t]
        libc.free.argtypes = [ctypes.c_void_p]
        n = mb << 20
        p = libc.malloc(n)
        if p:
            ctypes.memset(p, 0, n)
            libc.free(p)
            _prefaulted_mb = mb
    except (OSError, AttributeError):  # no libc: nothing pre-faulted
        pass
    return _prefaulted_mb


__all__ = [
    "UNetRunner",
    "volume_argmax",
    "tune_host_allocator",
    "prefault_host_heap",
]
