"""The plain reference that decides ``correct``: float32 PyTorch and
NumPy/SciPy, TF32 off, written from the published semantics of JoHof/lungmask
v0.2.20 (``lungmask/utils.py``, ``lungmask/resunet.py``, ``lungmask/mask.py``).
It imports nothing of ``lungmask_tpu_torch`` or of the JAX package and takes
nothing the program made: it reads the benchmark's own inputs and weights
and works out everything else again.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
