"""K1 (the bodymask kernel) and the ported morphology/cc it is built from,
against the JAX package and scipy.

Tolerance: none — labels, masks and boxes are integers and bools and must be
equal bit for bit. JAX is imported inside the parity tests only, so the
``cuda``-marked test runs on a GPU machine without JAX
(``pytest --noconftest -m cuda tests/test_torch_bodymask.py``).
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import torch_parity as tp
from lungmask_tpu_torch.ops import cc, morphology
from lungmask_tpu_torch.ops.kernels import bodymask as k1


def _jax_chain(slices: np.ndarray):
    """The XLA chain the Pallas kernel is proven equal to (tests/test_pallas.py)."""
    import jax
    import jax.numpy as jnp

    from lungmask_tpu.ops import cc as jcc
    from lungmask_tpu.ops import morphology as jmorph
    from lungmask_tpu.transforms import preprocess as jpre

    def chain(small):
        mask = small > jpre.BODY_THRESHOLD
        mask = jmorph.binary_closing(mask)
        mask = jmorph.binary_fill_holes(mask, structure="full")
        mask = jmorph.binary_erosion(mask, iterations=2)
        return jcc.label(mask, connectivity=1), mask

    labels, mask = jax.jit(jax.vmap(chain))(jnp.asarray(slices))
    return np.asarray(labels), np.asarray(mask)


def test_reference_matches_jax_xla_chain():
    slices = tp.bodymask_slices(0, b=8)
    want_labels, want_mask = _jax_chain(slices)
    labels, mask = k1.bodymask_labels_reference(torch.from_numpy(slices))
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    assert len(np.unique(want_labels)) > 2  # several components exercised


def test_wrapper_takes_plain_version_on_cpu():
    slices = torch.from_numpy(tp.bodymask_slices(1, b=4))
    before = k1.bodymask_labels.launches
    labels, mask = k1.bodymask_labels(slices.to(torch.int16))  # caller casts
    ref_labels, ref_mask = k1.bodymask_labels_reference(slices.to(torch.int16).float())
    assert labels.dtype == torch.int32 and mask.dtype == torch.bool
    assert torch.equal(labels, ref_labels) and torch.equal(mask, ref_mask)
    assert k1.bodymask_labels.launches == before  # no kernel ran


def test_launch_counts_survive_threads():
    """The cohort and serve lanes launch from several threads; the counter's
    read-modify-write must lose no update (fast thread switches, more
    threads than cores)."""
    import sys
    import threading

    from lungmask_tpu_torch.ops.kernels import count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, per_thread = 32, 2000

    def hammer():
        for _ in range(per_thread):
            count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * per_thread


def test_wrapper_rejects_bad_shape():
    with pytest.raises(ValueError):
        k1.bodymask_labels(torch.zeros((2, 64, 64)))


@pytest.mark.parametrize("structure", ["cross", "full"])
@pytest.mark.parametrize("op", ["dilation", "erosion", "closing", "fill_holes"])
def test_morphology_matches_scipy(op, structure):
    rng = np.random.default_rng(7)
    masks = rng.random((3, 40, 37)) < 0.55
    st = ndimage.generate_binary_structure(2, 1 if structure == "cross" else 2)
    scipy_fn = {
        "dilation": lambda m: ndimage.binary_dilation(m, st),
        "erosion": lambda m: ndimage.binary_erosion(m, st),
        "closing": lambda m: ndimage.binary_erosion(ndimage.binary_dilation(m, st), st),
        "fill_holes": lambda m: ndimage.binary_fill_holes(m, st),
    }[op]
    port_fn = {
        "dilation": morphology.binary_dilation,
        "erosion": morphology.binary_erosion,
        "closing": morphology.binary_closing,
        "fill_holes": morphology.binary_fill_holes,
    }[op]
    got = port_fn(torch.from_numpy(masks), structure).numpy()
    for i in range(masks.shape[0]):
        np.testing.assert_array_equal(got[i], scipy_fn(masks[i]))


@pytest.mark.parametrize("connectivity", [1, 2])
def test_label_roots_match_scipy(connectivity):
    """Each component's label is its raster-first linear index + 1."""
    rng = np.random.default_rng(11)
    masks = rng.random((4, 33, 50)) < 0.5
    got = cc.label(torch.from_numpy(masks), connectivity).numpy()
    st = ndimage.generate_binary_structure(2, connectivity)
    for i in range(masks.shape[0]):
        lab, n = ndimage.label(masks[i], st)
        want = np.zeros(lab.shape, np.int32)
        for j in range(1, n + 1):
            comp = lab == j
            want[comp] = np.flatnonzero(comp)[0] + 1
        np.testing.assert_array_equal(got[i], want)


def test_largest_component_tie_goes_to_first_root():
    """Two equal-area components: the scan-order-first one wins, as in the
    JAX package's ``cc.largest_component_mask``; an empty plane stays empty."""
    import jax.numpy as jnp

    from lungmask_tpu.ops import cc as jcc

    mask = np.zeros((2, 16, 16), bool)
    mask[0, 2:5, 9:12] = True  # 9 pixels, first in raster order
    mask[0, 10:13, 1:4] = True  # 9 pixels
    mask[0, 14, 14] = True
    labels = cc.label(torch.from_numpy(mask), connectivity=1)
    got = cc.largest_component_mask(labels).numpy()
    assert got[0].sum() == 9 and got[0, 2, 9] and not got[0, 10, 1]
    assert not got[1].any()
    for i in range(2):
        want = jcc.largest_component_mask(jnp.asarray(labels[i].numpy()))
        np.testing.assert_array_equal(got[i], np.asarray(want))
        want_box = jcc.first_component_bbox(jnp.asarray(labels[i].numpy()))
        np.testing.assert_array_equal(
            cc.first_component_bbox(labels[i : i + 1]).numpy()[0], np.asarray(want_box)
        )


@pytest.mark.slow
def test_reference_matches_pallas_interpret():
    import jax.numpy as jnp

    from lungmask_tpu.ops.pallas.bodymask import bodymask_labels_pallas

    slices = tp.bodymask_slices(2, b=4)
    want_labels, want_mask = bodymask_labels_pallas(jnp.asarray(slices), interpret=True)
    labels, mask = k1.bodymask_labels_reference(torch.from_numpy(slices))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_gpu():
    dev = tp.cuda_device()
    slices = torch.from_numpy(tp.bodymask_slices(3, b=64)).to(dev)
    before = k1.bodymask_labels.launches
    labels, mask = k1.bodymask_labels(slices)
    torch.cuda.synchronize()
    assert k1.bodymask_labels.launches == before + 1
    ref_labels, ref_mask = k1.bodymask_labels_reference(slices)
    assert torch.equal(mask, ref_mask)
    assert torch.equal(labels, ref_labels)
    cpu_labels, _ = k1.bodymask_labels_reference(slices.cpu())
    assert torch.equal(labels.cpu(), cpu_labels)
