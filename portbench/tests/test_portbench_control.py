"""The control, the reference computed in the nearest precision below the
configuration's (bf16 → float8 e4m3), comes out not correct against each
cell's limits. On the CPU at a small size here; at the cell's own size on
the card (``-m cuda``, run there with ``python3 -m pytest --noconftest -m
cuda portbench/tests``)."""

import numpy as np
import pytest
import torch

from portbench import phantom, spec, weights
from portbench.reference import pipeline, train, unet
from portbench.tests.tiny import bench

CPU = torch.device("cpu")
CONFIG = spec.cell(spec.load(), "r231.apply")["config"]
EPS = dict(eps=CONFIG["perturbation"], eps_head=CONFIG["head_perturbation"])


def _limits(name):
    return spec.cell(bench(), name)["limits"]


@pytest.mark.parametrize("name,classes", [("r231.apply", [3]), ("ltrclobes_r231.apply", [6, 3]),
                                          ("r231.cohort", [3])])
@pytest.mark.parametrize("seed", [2**32 + 1, 2**32 + 2, 2**32 + 3])
def test_inference_control_fails(name, classes, seed):
    vol, _ = phantom.volume(seed, 0, 8, 256, CPU)
    flats = [weights.make(seed, i, depth=5, wf=3, n_classes=c, device=CPU, **EPS)
             for i, c in enumerate(classes)]
    ref = pipeline.class_maps(vol, phantom.RAS, flats, CPU)[0]
    ctl = pipeline.class_maps(vol, phantom.RAS, flats, CPU, quant=unet.fp8_e4m3)[0]
    map_mm = max(float(np.mean(a != b)) for a, b in zip(ctl, ref))
    gap = 0.0
    x = torch.as_tensor(pipeline.normalized_slices(vol, phantom.RAS, 0, 8), dtype=torch.float32)
    for flat in flats:
        p = unet.tensors(flat, CPU)
        want, scale = unet.scores(p, x)
        gap = max(gap, unet.class_gap(unet.scores(p, x, unet.fp8_e4m3)[0], want, scale))
    limits = _limits(name)
    assert map_mm > limits["map_mismatch"] or gap > limits["logit_gap"]


@pytest.mark.parametrize("seed", [2**32 + 1, 2**32 + 2, 2**32 + 3])
def test_train_control_fails(seed):
    pairs = phantom.pool(seed, 2, 16, 128, CPU)
    flat = weights.make(seed, 0, depth=5, wf=2, n_classes=3, device=CPU, **EPS)
    kw = dict(batch=8, seed=seed % 2**31, n_batches=4000, dice_weight=0.5, lr_swap=(1, 2),
              size=128, device=CPU)
    ref = train.first_steps(pairs, flat, **kw)
    gaps = train.gaps(train.first_steps(pairs, flat, quant=unet.fp8_e4m3, **kw), ref)
    limits = _limits("r231.finetune")
    assert any(gaps[k] > limits[k] for k in limits), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["r231.apply", "ltrclobes_r231.apply", "r231.finetune"])
def test_control_fails_at_cell_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's own size")
    from types import SimpleNamespace

    from portbench import calibrate, lanes

    cell = spec.cell(bench(), name)
    r = lanes.Run(SimpleNamespace(seed=2**33 + 7, seconds=1, trace=0), cell,
                  torch.device("cuda", 0), 0.0)
    try:
        if cell["traffic"]["lane"] == "finetune":
            got = calibrate.control_finetune(r)["control"]
            assert any(got[k] > cell["limits"][k] for k in cell["limits"]), got
        else:
            got = calibrate.control_apply(r)  # the numbers the control reads
            assert any(got[k] > cell["limits"][k] for k in got), got
    finally:
        r.cleanup()
