"""Fine-tune a lungmask U-Net on your own (volume, mask) pairs, on the GPUs.

    python -m lungmask_tpu_torch.train.finetune DATA_DIR OUT.npz [--epochs N]
        [--model R231|PATH] [--resolution 256] [--cpu]

Pairs of ``.nii.gz`` volumes and label masks in a directory —
``case0.nii.gz`` + ``case0_mask.nii.gz`` etc. The last pair is held out for
macro-Dice evaluation; the best-scoring weights are written to ``OUT.npz``
in the format both packages' ``LMInferer(modelpath=)`` read, and the full
train state is checkpointed beside it each epoch for exact resume. The
counterpart of the JAX package's ``examples/finetune.py``: each batch splits
over a mesh of every visible GPU (``parallel.make_mesh()``), 8 slices per
GPU; ``--cpu`` runs on a one-device CPU mesh instead, and without CUDA and
without ``--cpu`` it fails.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from lungmask_tpu_torch.io import load_input_image
from lungmask_tpu_torch.models import convert, registry
from lungmask_tpu_torch.parallel import make_mesh
from lungmask_tpu_torch.train import Augmenter, fit
from lungmask_tpu_torch.train.data import SliceDataset, slices_from_pair


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("data_dir")
    ap.add_argument("out_path")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--model", default="R231",
                    help="warm-start weights: registry name or .npz/.pth path")
    ap.add_argument("--resolution", type=int, default=256,
                    help="slice resolution (the shipped models use 256)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    mesh = make_mesh(devices=["cpu"] if args.cpu else None)  # all local devices
    ndata, device = mesh.shape["data"], mesh.data_devices[0]

    pairs = []
    for vol_path in sorted(glob.glob(os.path.join(args.data_dir, "*[!k].nii.gz"))):
        mask_path = vol_path.replace(".nii.gz", "_mask.nii.gz")
        if os.path.exists(mask_path):
            pairs.append(
                (load_input_image(vol_path).array, load_input_image(mask_path).array)
            )
    if len(pairs) < 2:
        raise SystemExit(
            f"need at least 2 volume/mask pairs in {args.data_dir} (got {len(pairs)})"
        )

    if os.path.exists(args.model):
        params, n_classes = registry.get_model(modelpath=args.model)
    else:
        params, n_classes = registry.get_model(args.model)

    res = (args.resolution, args.resolution)
    train_pairs, eval_pair = pairs[:-1], pairs[-1]
    dataset = SliceDataset(train_pairs, resolution=res, device=device)
    eval_images, eval_labels = slices_from_pair(
        np.asarray(eval_pair[0]), np.asarray(eval_pair[1]), resolution=res, device=device
    )
    print(f"{len(train_pairs)} train volumes -> {len(dataset)} slices; "
          f"{eval_images.shape[0]} held-out eval slices; on {device} "
          f"({ndata}-way data mesh)")

    # the batch splits evenly over the mesh's data axis
    batch = max(ndata, min(len(dataset), 8 * ndata) // ndata * ndata)
    steps_per_epoch = max(1, len(dataset) // batch)
    result = fit(
        convert.from_jax_params(params, device),
        dataset,
        epochs=args.epochs,
        batch_size=batch,
        # R231 classes are lateralized: swap right (1) / left (2) on LR flips
        augment=Augmenter(lr_swap=(1, 2) if n_classes == 3 else None),
        eval_pairs=(eval_images, eval_labels),
        eval_every=steps_per_epoch,
        checkpoint_path=args.out_path.replace(".npz", "") + "-trainstate.npz",
        checkpoint_every=steps_per_epoch,
        mesh=mesh,
    )

    convert.save_npz(
        args.out_path,
        convert.to_jax_params(result.best_params),
        meta={"finetuned_from": args.model, "eval_macro_dice": result.best_dice},
    )
    print(f"best eval macro Dice {result.best_dice:.4f}; wrote {args.out_path} — "
          f"use it via LMInferer(modelpath={args.out_path!r})")


if __name__ == "__main__":
    main()
