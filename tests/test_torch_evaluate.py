"""The port's ``train.loop.evaluate`` against the JAX package's, on the CPU.

The same float32 parameters (a JAX-layout tree, and the port's
``convert.from_jax_params`` of it) and the same slices (``slices_from_pair``
of a 12-slice 256² ``lung_phantom`` and its mask) go through both
``evaluate``s with ``batch_size=5``, so the tail chunk holds 2 slices: JAX
pads it to 5, the port runs it short. Three trees: the crafted
``laterality_params`` (the net predicts foreground), a fresh ``init_params``
tree (JAX's draw, converted, since the two packages' initialisers use
different generators) and a tree whose head predicts background everywhere
(Dice 0 in both).

Tolerance: 1e-12 on the macro Dice, which both compute from the integer
predictions of float32 forwards.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity  # noqa: F401  (one torch thread per worker)
from lungmask_tpu.models import synthetic as jsynthetic
from lungmask_tpu.models import unet as junet
from lungmask_tpu.train import loop as jloop
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.models import convert, synthetic
from lungmask_tpu_torch.train import loop
from lungmask_tpu_torch.train.data import slices_from_pair

WF = 2
N_SLICES, SIZE = 12, 256
BATCH = 5  # chunks of 5, 5 and 2
DICE_TOL = 1e-12


@pytest.fixture(scope="module")
def slices(tmp_path_factory):
    """(images, labels) of the phantom, the labels from the port's
    ``LMInferer`` with the crafted weights."""
    vol = synthetic.lung_phantom(N_SLICES, size=SIZE)
    path = str(tmp_path_factory.mktemp("evaluate") / "w.npz")
    convert.save_npz(path, jsynthetic.laterality_params(wf=WF))
    mask = LMInferer(modelpath=path, force_cpu=True, tqdm_disable=True).apply(vol)
    assert set(np.unique(mask)) == {0, 1, 2}
    return slices_from_pair(vol, mask, device="cpu")


def _background_params():
    """The crafted tree with a head that gives class 0 the only positive
    logit at every pixel."""
    params = jax.tree.map(np.array, jsynthetic.laterality_params(wf=WF))
    params["last"]["w"][:] = 0.0
    params["last"]["b"][:] = [1.0, 0.0, 0.0]
    return params


TREES = {
    "crafted": lambda: jsynthetic.laterality_params(wf=WF),
    "fresh": lambda: junet.init_params(jax.random.PRNGKey(0), 3, wf=WF),
    "background": _background_params,
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_evaluate_equals_jax(slices, tree):
    images, labels = slices
    assert images.shape[0] == N_SLICES and N_SLICES % BATCH == 2
    params = jax.tree.map(np.asarray, TREES[tree]())
    want = jloop.evaluate(params, images, labels, batch_size=BATCH,
                          compute_dtype=jnp.float32)
    got = loop.evaluate(convert.from_jax_params(params), images, labels,
                        batch_size=BATCH, compute_dtype=torch.float32)
    assert abs(got - want) <= DICE_TOL, (tree, got, want)
    if tree == "crafted":
        assert got > 0.9  # the net predicts both lungs
    elif tree == "background":
        assert got == 0.0
