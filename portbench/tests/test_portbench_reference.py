"""The plain reference agrees with lungmask_tpu_torch at float32 on the CPU
at a small size: the whole apply (single model and the fused pair) voxel for
voxel, and the first three fine-tuning steps' losses, first gradients and
changes; and it imports nothing of the port."""

import ast
import os
import sys

import numpy as np
import pytest
import torch

from portbench import phantom, spec, weights
from portbench.reference import pipeline
from portbench.tests.tiny import run_cell

CPU = torch.device("cpu")
CONFIG = spec.cell(spec.load(), "r231.apply")["config"]
EPS = dict(eps=CONFIG["perturbation"], eps_head=CONFIG["head_perturbation"])


@pytest.mark.parametrize("n_models", [1, 2])
def test_reference_apply_equals_port_at_float32(tmp_path, n_models):
    from lungmask_tpu_torch.inferer import LMInferer
    from lungmask_tpu_torch.io.image import MedicalImage

    vol, _ = phantom.volume(2**33 + 5, 0, 6, 128, CPU)
    flats = [weights.make(2**33 + 5, i, depth=5, wf=2, n_classes=c, device=CPU, **EPS)
             for i, c in enumerate([6, 3][:n_models] if n_models == 2 else [3])]
    paths = [weights.save_npz(str(tmp_path / f"m{i}.npz"), f) for i, f in enumerate(flats)]
    inf = LMInferer(modelpath=paths[0], fillmodel_path=paths[1] if n_models == 2 else None,
                    force_cpu=True, precision="float32", tqdm_disable=True)
    got = inf.apply(MedicalImage(vol, direction=phantom.RAS))
    want = pipeline.segment(vol, phantom.RAS, flats, CPU)
    assert np.unique(want).tolist() == [0, 1, 2]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_classes", [3, 6])
def test_reference_class_scores_equal_port_at_float32(n_classes):
    """The runner's U-Net and the reference's give one chunk the same class
    scores at float32 (``logit_gap``'s two sides)."""
    from lungmask_tpu_torch.runtime.engine import UNetRunner

    from portbench.reference import unet

    vol, _ = phantom.volume(2**33 + 6, 0, 4, 128, CPU)
    flat = weights.make(2**33 + 6, 0, depth=5, wf=3, n_classes=n_classes, device=CPU, **EPS)
    x = torch.as_tensor(pipeline.normalized_slices(vol, phantom.RAS, 1, 3), dtype=torch.float32)
    runner = UNetRunner(weights.nested(flat), n_classes, compute_dtype=torch.float32, device=CPU)
    with torch.inference_mode():
        got = runner.model(x.unsqueeze(-1))
    want, scale = unet.scores(unet.tensors(flat, CPU), x)
    assert got.shape == want.shape == (2, 256, 256, n_classes)
    assert unet.class_gap(got, want, scale) < 1e-4


def test_reference_train_steps_equal_port_at_float32():
    def f32(cell):
        cell["config"]["precision"] = "float32"
        cell["limits"] = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-3}

    line = run_cell("r231.finetune", adjust=f32)
    assert line["correct"], line["checks"]


def test_postprocessing_semantics():
    """lungmask's rules on a hand-made map: a small island of class 2 inside
    class 1 merges into it; each class keeps its largest component; holes
    are filled; the spare label is erased."""
    lab = np.zeros((3, 12, 12), np.uint8)
    lab[:, 1:6, 1:6] = 1
    lab[1, 3, 3] = 2          # island inside class 1 (area 1 < 3: dies, then a hole)
    lab[:, 1:6, 7:11] = 2
    lab[1, 8, 8:10] = 1       # a small class-1 patch touching nothing
    lab[0:2, 7:10, 1:4] = 3   # spare marker next to nothing
    out = pipeline.postprocessing(lab, spare=[3])
    assert out[1, 3, 3] == 1                      # hole filled
    assert (out[:, 1:6, 1:6] == 1).all()
    assert (out[:, 1:6, 7:11] == 2).all()
    assert out[1, 8, 8] == 0 and (out == 3).sum() == 0


ALLOWED = {"__future__", "math", "typing", "numpy", "scipy", "torch", "portbench"}


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(spec.ROOT, "portbench", "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
                if tops == ["portbench"]:
                    assert node.module.startswith("portbench.reference"), (name, node.module)
            else:
                continue
            assert set(tops) <= ALLOWED, (name, tops)
