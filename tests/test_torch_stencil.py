"""K2 and K3 (the U-Net's pooling and upsampling kernels) and their plain
versions, against the JAX package and torch's library ops.

Tolerances:
* float32, plain version vs the JAX U-Net's ``_avg_pool2``: atol 1e-6 (a
  sum of four values in another order); vs ``_bilinear_up2``
  (``jax.image.resize``): atol 1e-5, the bound ``test_pallas_stencil.py``
  holds the Pallas kernel to; vs the Pallas kernels in interpret mode: atol
  1e-6; vs ``F.avg_pool2d`` / ``F.interpolate``: atol 1e-6.
* bfloat16: within 0.05 of the JAX functions, the bound of
  ``test_pallas_stencil.py`` (the plain version rounds once, JAX per step).
* On the card (``cuda``-marked): none — the kernels are bit-equal to their
  plain versions in bfloat16 and float32. Run there with
  ``python -m pytest --noconftest -m cuda tests/test_torch_stencil.py``;
  JAX is imported inside the parity tests only.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parity as tp
from lungmask_tpu_torch.ops.kernels import stencil

POOL_SHAPES = [(2, 32, 16, 8), (1, 8, 8, 4), (3, 16, 64, 2)]  # test_pallas_stencil.py
UP_SHAPES = [(2, 32, 16, 8), (1, 8, 8, 4), (2, 16, 4, 2)]
ODD_SHAPES = [(3, 33, 35, 4), (2, 17, 9, 12), (1, 3, 3, 5)]
ONE_ROW = (1, 1, 3, 5)  # K3's clamps meet: prev = cur = next
# The U-Net's stencil inputs at wf=6: the four pools, then the four upsamples.
UNET_POOL = [(256, 256, 64), (128, 128, 128), (64, 64, 256), (32, 32, 512)]
UNET_UP = [(16, 16, 1024), (32, 32, 512), (64, 64, 256), (128, 128, 128)]
# K3's tiles straddled: ragged rows, columns and channel slabs, one pixel.
TILE_SHAPES = [(2, 37, 70, 24), (1, 5, 129, 136), (1, 1, 1, 8)]
# The U-Net's upsamples of a 96² volume's host-preprocessed stack.
VOLUME96_UP = [(2, 6, 6, 1024), (2, 12, 12, 512), (2, 24, 24, 256), (2, 48, 48, 128)]


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _jax_fns():
    from lungmask_tpu.models import unet as junet
    from lungmask_tpu.ops.pallas import stencil as jst

    return junet, jst


@pytest.mark.parametrize("shape", POOL_SHAPES + ODD_SHAPES)
def test_pool_plain_matches_jax(shape):
    import jax.numpy as jnp

    junet, jst = _jax_fns()
    x = _normal(shape, 0)
    got = stencil.avg_pool2_reference(torch.from_numpy(x)).numpy()
    want = np.asarray(junet._avg_pool2(jnp.asarray(x)))
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if shape[1] % 2 == 0 and shape[2] % 2 == 0:  # the Pallas kernel takes even H, W
        pallas = np.asarray(jst.avg_pool2_pallas(jnp.asarray(x), interpret=True))
        np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    got16 = stencil.avg_pool2_reference(bf).float().numpy()
    want16 = np.asarray(
        junet._avg_pool2(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32)
    )
    assert np.abs(got16 - want16).max() <= 0.05


@pytest.mark.parametrize("shape", UP_SHAPES + ODD_SHAPES + [ONE_ROW] + TILE_SHAPES + VOLUME96_UP)
def test_up2_plain_matches_jax(shape):
    import jax.numpy as jnp

    junet, jst = _jax_fns()
    x = _normal(shape, 1)
    got = stencil.bilinear_up2_reference(torch.from_numpy(x)).numpy()
    want = np.asarray(junet._bilinear_up2(jnp.asarray(x)))
    assert got.shape == want.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    pallas = np.asarray(jst.bilinear_up2_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    got16 = stencil.bilinear_up2_reference(bf).float().numpy()
    want16 = np.asarray(
        junet._bilinear_up2(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32)
    )
    assert np.abs(got16 - want16).max() <= 0.05


@pytest.mark.parametrize("shape", POOL_SHAPES + ODD_SHAPES)
def test_plain_versions_match_torch_library_ops(shape):
    x = torch.from_numpy(_normal(shape, 2))
    nchw = x.permute(0, 3, 1, 2)
    pool = F.avg_pool2d(nchw, 2).permute(0, 2, 3, 1)
    up = F.interpolate(nchw, scale_factor=2, mode="bilinear", align_corners=False)
    torch.testing.assert_close(stencil.avg_pool2_reference(x), pool, rtol=0, atol=1e-6)
    torch.testing.assert_close(
        stencil.bilinear_up2_reference(x), up.permute(0, 2, 3, 1), rtol=0, atol=1e-6
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_take_plain_versions_on_cpu(dtype):
    x = torch.from_numpy(_normal((2, 6, 10, 8), 3)).to(dtype)
    before = (stencil.avg_pool2.launches, stencil.bilinear_up2.launches)
    pool, up = stencil.avg_pool2(x), stencil.bilinear_up2(x)
    assert pool.dtype == up.dtype == dtype
    assert torch.equal(pool, stencil.avg_pool2_reference(x))
    assert torch.equal(up, stencil.bilinear_up2_reference(x))
    # An NHWC view of a channels_last tensor goes in without a copy.
    nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    assert torch.equal(stencil.avg_pool2(nchw.permute(0, 2, 3, 1)), pool)
    assert (stencil.avg_pool2.launches, stencil.bilinear_up2.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    for fn in (stencil.avg_pool2, stencil.bilinear_up2):
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            fn(torch.zeros((1, 4, 4, 2), dtype=torch.float16))
        with pytest.raises(ValueError, match="NHWC"):
            fn(torch.zeros((4, 4, 2)))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize(
    "shape",
    [(32,) + s for s in UNET_UP] + UP_SHAPES + ODD_SHAPES + [ONE_ROW] + TILE_SHAPES + VOLUME96_UP,
)
def test_up2_plan_covers_input_once(shape, itemsize):
    """K3's tile plan, walked as the kernel walks it, takes every input row,
    column and channel exactly once, and its block fits the card."""
    n, h, w, c = shape
    for aligned in (True, False):
        p = stencil.up2_plan(shape, itemsize, aligned)
        assert p.vec in (1, 16 // itemsize) and c % p.vec == 0
        assert p.threads % p.cvt == 0 and p.cvt <= p.threads <= stencil.UP2_MAX_THREADS
        assert p.smem_bytes <= stencil.SMEM_LIMIT
        images, tiles_h, tiles_w, slabs = p.grid(shape)
        rows, cols, chans = np.zeros(h, int), np.zeros(w, int), np.zeros(c, int)
        for ti in range(tiles_h):  # output rows 2i, 2i+1 for i = i0 + r < h
            rows[[ti * p.rows + r for r in range(p.rows) if ti * p.rows + r < h]] += 1
        for tj in range(tiles_w):  # columns j0 + jj, jj < min(tile_w, w - j0)
            j0 = tj * p.tile_w
            cols[j0 : j0 + min(p.tile_w, w - j0)] += 1
        for slab in range(slabs):  # vectors whose first channel is below c
            for v in range(p.cvt):
                ch = (slab * p.cvt + v) * p.vec
                if ch < c:
                    chans[ch : ch + p.vec] += 1
        assert images == n
        assert (rows == 1).all() and (cols == 1).all() and (chans == 1).all()


def test_up2_plan_fills_the_card_at_the_smallest_unet_shape():
    """32 × 16² × 1024 bf16 still gives at least two blocks per SM (132)."""
    shape = (32, 16, 16, 1024)
    assert np.prod(stencil.up2_plan(shape, 2).grid(shape)) >= 2 * 132


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_bit_equal_plain_versions_on_gpu(dtype):
    dev = tp.cuda_device()
    cases = [("pool", (2,) + s) for s in UNET_POOL] + [("up", (2,) + s) for s in UNET_UP]
    cases += [(op, s) for s in ODD_SHAPES + [(2, 8, 8, 3)] for op in ("pool", "up")]
    cases += [("up", s) for s in [ONE_ROW] + TILE_SHAPES + VOLUME96_UP]
    for i, (op, shape) in enumerate(cases):
        x = torch.from_numpy(_normal(shape, 10 + i)).to(dev, dtype)
        fn = stencil.avg_pool2 if op == "pool" else stencil.bilinear_up2
        ref = stencil.avg_pool2_reference if op == "pool" else stencil.bilinear_up2_reference
        before = fn.launches
        got = fn(x)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(_bits(got), _bits(ref(x))), (op, shape)
        assert torch.equal(_bits(got.cpu()), _bits(ref(x.cpu()))), (op, shape)


@pytest.mark.cuda
def test_kernels_scalar_path_on_unaligned_input():
    """A base that is not 16-byte aligned takes the scalar path."""
    dev = tp.cuda_device()
    flat = torch.from_numpy(_normal((1 + 2 * 6 * 10 * 8,), 4)).to(dev)
    x = flat[1:].view(2, 6, 10, 8)
    assert x.data_ptr() % 16 != 0
    assert torch.equal(stencil.avg_pool2(x), stencil.avg_pool2_reference(x))
    assert torch.equal(stencil.bilinear_up2(x), stencil.bilinear_up2_reference(x))
