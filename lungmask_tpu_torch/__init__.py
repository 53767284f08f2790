"""lungmask_tpu_torch: the PyTorch/CUDA port of lungmask_tpu.

The JAX package ``lungmask_tpu`` is the reference; this package mirrors its
module paths and public names, imports ``torch`` and never ``jax`` or
``lungmask_tpu``, and runs its device work on an NVIDIA GPU (Hopper): plain
tensor code in PyTorch, the TPU's Pallas kernels rewritten by hand in CUDA
C++ (``csrc/``). Public surface: ``LMInferer`` (+ the deprecated ``apply``
and ``apply_fused``) and the ``lungmask-torch INPUT OUTPUT`` CLI
(``python -m lungmask_tpu_torch``).
"""

__version__ = "0.1.0"

from lungmask_tpu_torch.inferer import LMInferer, apply, apply_fused
from lungmask_tpu_torch.io.image import MedicalImage

__all__ = ["LMInferer", "MedicalImage", "apply", "apply_fused", "__version__"]
