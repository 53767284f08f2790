"""The port's hand-written kernels: in CUDA C++, K1 ``bodymask``, K2/K3
``stencil`` and K4 ``conv_stage``; in Triton, for the 3-D U-Net, (a)
``norm3d`` and (b) ``export3d``.

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
