#!/usr/bin/env python
"""Fine-tune a lungmask U-Net on your own (volume, mask) pairs with the
PyTorch/CUDA port.

    python examples/torch/finetune.py DATA_DIR OUT_WEIGHTS.npz [--epochs N]
        [--model R231|/path.npz] [--resolution 256] [--cpu]

The counterpart of ``examples/finetune.py``. The recipe is the port's
``python -m lungmask_tpu_torch.train.finetune``, whose ``main`` this calls:
``caseN.nii.gz`` + ``caseN_mask.nii.gz`` pairs in DATA_DIR, the last pair
held out for macro-Dice evaluation, the best weights written to
OUT_WEIGHTS.npz (both packages' ``LMInferer(modelpath=)`` read it) and the
full train state checkpointed beside it. Batches split over every visible
GPU; ``--cpu`` runs on the CPU, and without CUDA and without ``--cpu`` it
fails. Run it from the repository root with ``PYTHONPATH=.``, or install
the package.
"""

from lungmask_tpu_torch.train.finetune import main

if __name__ == "__main__":
    main()
