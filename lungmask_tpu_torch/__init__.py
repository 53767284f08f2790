"""lungmask_tpu_torch: the PyTorch/CUDA port of lungmask_tpu.

The JAX package ``lungmask_tpu`` is the reference; this package mirrors its
module paths and public names, imports ``torch`` and never ``jax`` or
``lungmask_tpu``, and runs its device work on an NVIDIA GPU (Hopper): plain
tensor code in PyTorch, the TPU's Pallas kernels rewritten by hand in CUDA
C++ (``csrc/``). Public surface: ``LMInferer`` (+ the deprecated ``apply``
and ``apply_fused``), the ``lungmask-torch`` CLI (``python -m
lungmask_tpu_torch``; one volume, ``--cohort``, ``--serve``, ``--warmup``,
``--noHU``), ``io.load_input_image`` / ``io.write_image`` (DICOM series and
every file format of the JAX package), ``compat`` (the reference's
module-level names), ``runtime.cohort.run_cohort``,
``runtime.serve.make_server`` and ``metrics.compare_masks``.
"""

__version__ = "0.1.0"

from lungmask_tpu_torch import metrics
from lungmask_tpu_torch.inferer import LMInferer, apply, apply_fused
from lungmask_tpu_torch.io.image import MedicalImage

__all__ = ["LMInferer", "MedicalImage", "apply", "apply_fused", "metrics", "__version__"]
