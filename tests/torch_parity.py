"""Shared helpers for the PyTorch-port parity tests (``test_torch_*.py``).

Not a test module. Importing it pins torch to one thread: the tier-1 run
starts six pytest workers, and each torch process would otherwise start one
thread per core. Inputs are made from a seed with numpy and handed to both
packages as numpy arrays. Nothing here needs JAX (the JAX package is
imported only where it imports), so the CUDA-marked tests can run on a
machine that has none (``pytest --noconftest -m cuda``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _build_jax_native_once() -> None:
    """Make sure this test worker holds the JAX package's native libraries
    (its host core and its DICOM codecs). The JAX package builds each on
    first use with no lock, writing the library in place
    (``lungmask_tpu/ops/native.py::build_or_load_library``), and some of its
    test modules ask for them while pytest collects. Workers that collect
    together then compile over each other, and a worker whose build failed
    remembers that it has no library for the rest of its life: its
    ``skipif``s skip, and the port's comparisons with the JAX codecs fail.
    Here, after those collection-time builds, under a file lock that
    serialises the workers, a worker without a library forgets the failure
    and builds or loads it again. Where the JAX package does not import (the
    GPU machine), nothing is done."""
    try:
        from lungmask_tpu.io import codecs as jcodecs
        from lungmask_tpu.ops import native as jnative
    except ImportError:
        return
    from lungmask_tpu_torch.ops.native import build_lock

    with build_lock(jnative._OUT):
        for mod in (jnative, jcodecs):
            if mod.get_lib() is None:
                mod._TRIED = False
                mod.get_lib()


_build_jax_native_once()


def cuda_device() -> torch.device:
    """The CUDA device for a ``cuda``-marked test; skips the test (at run
    time, never at import) where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


class GradRecorder:
    """An optimizer for ``make_train_step`` that keeps the step's gradients
    (``.grads``) and moves no weight."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        self.grads = {k: g.clone() for k, g in grads.items()}
        return {k: torch.zeros_like(g) for k, g in grads.items()}, state


def bodymask_slices(seed: int, b: int = 8) -> np.ndarray:
    """(b, 128, 128) float32 HU slices for the bodymask chain: bodies with
    cavities and blobs touching the border, rings with holes, thresholded
    noise, and plain noise around the −500 HU threshold."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:128, 0:128]
    out = np.full((b, 128, 128), -1000, dtype=np.float32)
    for i in range(b):
        kind = i % 4
        if kind == 0:
            body = ((yy - 64) / 45.0) ** 2 + ((xx - 64) / (30.0 + 3 * i)) ** 2 < 1
            out[i][body] = 40
            out[i, 59:69, 59:69] = -900  # cavity inside the body
            out[i, 0:10, 50:70] = 100  # blob touching the border
            out[i, 20:26, 20:26] = 100
        elif kind == 1:
            r = np.hypot(yy - 64, xx - 64)
            out[i][(r > 20) & (r < 40)] = 0  # ring around a hole
            out[i][(r > 50) & (r < 54)] = 0
            out[i][rng.random((128, 128)) < 0.05] = 0
        elif kind == 2:
            out[i] = np.where(rng.random((128, 128)) < 0.45, 0, -1000)
        else:
            out[i] = rng.normal(-500, 300, (128, 128))
    out += rng.normal(0, 20, out.shape).astype(np.float32)
    return out


def random_params(n_classes: int, wf: int, seed: int = 0):
    """numpy-seeded weights in the JAX tree of ``unet.init_params`` (its
    shapes via ``eval_shape``): conv weights and biases
    U(−1/√fan_in, 1/√fan_in) as torch's default init, folded-BN affines
    random around identity, the head widened (below)."""
    import jax

    from lungmask_tpu.models import unet as junet

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda k: junet.init_params(k, n_classes=n_classes, wf=wf), jax.random.PRNGKey(0)
    )

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "bias":
            return rng.uniform(-0.2, 0.2, leaf.shape).astype(np.float32)
        fan_in = np.prod(shapes_of[path[:-1]]["w"][:3])
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    shapes_of = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        shapes_of.setdefault(path[:-1], {})[path[-1].key] = leaf.shape
    params = jax.tree_util.tree_map_with_path(fill, shapes)
    # At init scale the head's bias picks one class everywhere; a wider head
    # without bias lets the features decide, so argmax comparisons bite.
    params["last"]["w"] *= 64.0
    params["last"]["b"][:] = 0.0
    return params


def blocky_slices(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """(n, h, w, 1) float32 inputs in [0, 1.05): 8×8 blocks of random level
    plus fine noise. Large uniform regions give a random U-Net spatially
    varying features (iid pixel noise averages out to one class)."""
    rng = np.random.default_rng(seed)
    blocks = rng.random((n, h // 8 + 1, w // 8 + 1), dtype=np.float32)
    x = np.repeat(np.repeat(blocks, 8, 1), 8, 2)[:, :h, :w]
    return (x + 0.05 * rng.random((n, h, w), dtype=np.float32))[..., None]


def assert_same_image(got, want, mask_tags=()) -> None:
    """Two ``MedicalImage``s (one per package) hold the same voxels, dtype,
    spacing, origin, direction and metadata; tags in ``mask_tags`` (fresh
    UIDs) are compared for presence only."""
    assert got.array.dtype == want.array.dtype
    np.testing.assert_array_equal(got.array, want.array)
    assert tuple(got.spacing) == tuple(want.spacing)
    assert tuple(got.origin) == tuple(want.origin)
    np.testing.assert_array_equal(got.direction, want.direction)
    assert sorted(got.metadata) == sorted(want.metadata)
    for key, value in want.metadata.items():
        if key not in mask_tags:
            assert got.metadata[key] == value, key


def assert_apply_is_the_three_phases(inferer, image, stages) -> np.ndarray:
    """``inferer.apply(image)`` calls each of ``preprocess_image``,
    ``forward_preprocessed`` and ``finish_forward`` once, times exactly the
    stage names ``stages``, and returns what
    ``apply_preprocessed(preprocess_image(image))`` returns."""
    from unittest import mock

    phases = ("preprocess_image", "forward_preprocessed", "finish_forward")
    inferer.timings.reset()
    spies = {p: mock.Mock(wraps=getattr(inferer, p)) for p in phases}
    with mock.patch.multiple(inferer, **spies):
        got = inferer.apply(image)
    assert {p: spies[p].call_count for p in phases} == dict.fromkeys(phases, 1)
    assert set(inferer.timings.summary()) == set(stages)
    np.testing.assert_array_equal(got, inferer.apply_preprocessed(inferer.preprocess_image(image)))
    return got
