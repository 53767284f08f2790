"""The port's hand-written CUDA kernels (K1 ``bodymask``, K2/K3 ``stencil``, K4
``conv_stage``).

Each wrapper counts its kernel's launches in its ``.launches`` attribute.
The cohort and serve lanes launch kernels from several threads, so the count
goes up under one lock (:func:`count_launch`).
"""

import threading

_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, atomically across threads."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
