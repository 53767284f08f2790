"""The backward of K2 and K3: the plain adjoints (``avg_pool2_bwd_reference``,
``bilinear_up2_bwd_reference``) against JAX's gradients of the U-Net's
``_avg_pool2`` and ``_bilinear_up2`` (``jax.vjp``), against torch's own
numerical gradients, and the autograd Functions that route them.

Tolerances:
* K2ᵀ, float32: none (``0.25·g`` is exact; both place it on the window).
* K3ᵀ, float32: 1e-6 of the largest gradient (four products summed in
  another order than XLA's transpose).
* ``gradcheck``: torch's defaults, in float64 on the test's copies of the
  plain versions' formulas (the port's compute in float32), each copy first
  held bit-equal to the port's in float32.
* On the card (``cuda``-marked): none — the adjoint kernels are bit-equal to
  their plain versions in bfloat16 and float32, on the vector and the
  scalar path. Run there with
  ``python -m pytest --noconftest -m cuda tests/test_torch_stencil_grad.py``;
  JAX is imported inside the parity tests only.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from lungmask_tpu_torch.ops.kernels import stencil

# The narrow U-Net's (depth 3, wf 2, 64² slices, batch 2) stencil inputs.
UNET_POOL = [(2, 64, 64, 4), (2, 32, 32, 8)]
UNET_UP = [(2, 16, 16, 16), (2, 32, 32, 8)]
# Odd sizes (a dropped row or column), one row, tile-straddling shapes of
# K3 and K3ᵀ (ragged row and column tiles, a short last channel slab).
ODD = [(3, 33, 35, 4), (2, 17, 9, 12), (1, 3, 3, 5), (1, 1, 3, 5)]
TILES = [(2, 37, 70, 24), (1, 5, 129, 136), (1, 1, 1, 8), (2, 19, 13, 264), (1, 10, 9, 520)]
# The production U-Net's shapes at batch 2 (wf=6, 256²).
WF6_POOL = [(2, 256, 256, 64), (2, 128, 128, 128), (2, 64, 64, 256), (2, 32, 32, 512)]
WF6_UP = [(2, 16, 16, 1024), (2, 32, 32, 512), (2, 64, 64, 256), (2, 128, 128, 128)]
# K3ᵀ's outputs in a train step (batch 8) and an inference chunk (32), and
# on the mesh's padded bands (h/2 + 1 rows at 2 bands, h/2 + 2 inside).
UNET_UP_B = [(b,) + s[1:] for b in (8, 32) for s in WF6_UP]
BANDS_UP = [(8, s[1] // 2 + pad) + s[2:] for s in WF6_UP for pad in (1, 2)]


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _pool_out(shape):
    n, h, w, c = shape
    return (n, h // 2, w // 2, c)


def _up_out(shape):
    n, h, w, c = shape
    return (n, 2 * h, 2 * w, c)


@pytest.mark.parametrize("shape", UNET_POOL + ODD)
def test_pool_adjoint_equals_jax_vjp(shape):
    import jax
    import jax.numpy as jnp

    from lungmask_tpu.models import unet as junet

    x, g = _normal(shape, 0), _normal(_pool_out(shape), 1)
    _, vjp = jax.vjp(junet._avg_pool2, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = stencil.avg_pool2_bwd_reference(torch.from_numpy(g), shape).numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", UNET_UP + ODD + TILES)
def test_up2_adjoint_equals_jax_vjp(shape):
    import jax
    import jax.numpy as jnp

    from lungmask_tpu.models import unet as junet

    x, g = _normal(shape, 2), _normal(_up_out(shape), 3)
    _, vjp = jax.vjp(junet._bilinear_up2, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = stencil.bilinear_up2_bwd_reference(torch.from_numpy(g)).numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


# The plain versions' formulas in the input's own dtype, for gradcheck.
def _pool(x):
    return ((x[:, 0:-1:2, 0:-1:2] + x[:, 1::2, 0:-1:2])
            + (x[:, 0:-1:2, 1::2] + x[:, 1::2, 1::2])) * 0.25


def _pool_adjoint(g, in_shape):
    n, h, w, c = in_shape
    dx = g.new_zeros(in_shape)
    for a in (0, 1):
        for b in (0, 1):
            dx[:, a : 2 * (h // 2) : 2, b : 2 * (w // 2) : 2] = g * 0.25
    return dx


def _up(x):
    return stencil._quarter_lerps(stencil._quarter_lerps(x, 1), 2)


def _up_adjoint(g):
    return stencil._quarter_lerps_adjoint(stencil._quarter_lerps_adjoint(g, 1), 2)


class _PlainPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.in_shape = tuple(x.shape)
        return _pool(x)

    @staticmethod
    def backward(ctx, g):
        return _pool_adjoint(g, ctx.in_shape)


class _PlainUp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _up(x)

    @staticmethod
    def backward(ctx, g):
        return _up_adjoint(g)


@pytest.mark.parametrize("shape", [(2, 6, 8, 3), (1, 5, 7, 2), (1, 1, 3, 2), (2, 1, 1, 1)])
def test_plain_adjoints_pass_gradcheck(shape):
    x32 = torch.from_numpy(_normal(shape, 4))
    g32 = torch.from_numpy(_normal(_up_out(shape), 10))
    assert torch.equal(_up(x32), stencil.bilinear_up2_reference(x32))
    assert torch.equal(_up_adjoint(g32), stencil.bilinear_up2_bwd_reference(g32))
    x = x32.double().requires_grad_()
    assert torch.autograd.gradcheck(_PlainUp.apply, (x,))
    if shape[1] > 1 and shape[2] > 1:
        gp32 = torch.from_numpy(_normal(_pool_out(shape), 11))
        assert torch.equal(_pool(x32), stencil.avg_pool2_reference(x32))
        assert torch.equal(_pool_adjoint(gp32, shape), stencil.avg_pool2_bwd_reference(gp32, shape))
        assert torch.autograd.gradcheck(_PlainPool.apply, (x,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_backward_through_plain_adjoints_on_cpu(dtype):
    """On a CPU tensor the wrappers' autograd takes the plain adjoints and
    launches nothing; a channels_last NCHW view goes in and its gradient
    comes back channels_last."""
    shape = (2, 9, 12, 8)
    before = {f: f.launches for f in (stencil.avg_pool2, stencil.bilinear_up2,
                                      stencil.avg_pool2_bwd, stencil.bilinear_up2_bwd)}
    nchw = torch.from_numpy(_normal(shape, 5)).to(dtype).permute(0, 3, 1, 2)
    nchw = nchw.contiguous(memory_format=torch.channels_last).requires_grad_()
    x = nchw.permute(0, 2, 3, 1)
    gp = torch.from_numpy(_normal(_pool_out(shape), 6)).to(dtype)
    gu = torch.from_numpy(_normal(_up_out(shape), 7)).to(dtype)
    (stencil.avg_pool2(x) * gp).sum().backward()
    assert torch.equal(nchw.grad.permute(0, 2, 3, 1),
                       stencil.avg_pool2_bwd_reference(gp, shape))
    assert nchw.grad.is_contiguous(memory_format=torch.channels_last)
    nchw.grad = None
    (stencil.bilinear_up2(x) * gu).sum().backward()
    assert torch.equal(nchw.grad.permute(0, 2, 3, 1), stencil.bilinear_up2_bwd_reference(gu))
    assert all(f.launches == n for f, n in before.items())


def test_inference_mode_computes_the_same_bits():
    x = torch.from_numpy(_normal((2, 8, 6, 4), 8))
    with torch.inference_mode():
        pool, up = stencil.avg_pool2(x), stencil.bilinear_up2(x)
    assert not pool.requires_grad and not up.requires_grad
    assert torch.equal(pool, stencil.avg_pool2_reference(x))
    assert torch.equal(up, stencil.bilinear_up2_reference(x))


def test_adjoint_wrappers_check_their_input():
    with pytest.raises(ValueError, match="does not fit"):
        stencil.avg_pool2_bwd(torch.zeros((1, 3, 3, 2)), (1, 8, 8, 2))
    with pytest.raises(ValueError, match="×2 upsample"):
        stencil.bilinear_up2_bwd(torch.zeros((1, 3, 4, 2)))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        stencil.bilinear_up2_bwd(torch.zeros((1, 4, 4, 2), dtype=torch.float16))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", UNET_UP_B + BANDS_UP + ODD + TILES)
def test_up2_bwd_plan_covers_output_once(shape, itemsize):
    """K3ᵀ's tile plan, walked as the kernel walks it, takes every dx row,
    column and channel exactly once; the staged gradient window holds every
    clamped tap of every dx in its tile; the block fits the card."""
    n, h, w, c = shape
    for aligned in (True, False):
        p = stencil.up2_bwd_plan(shape, itemsize, aligned)
        assert p.backward and p.vec in (1, 16 // itemsize) and c % p.vec == 0
        assert p.threads % p.cvt == 0 and p.cvt <= p.threads <= stencil.UP2_MAX_THREADS
        assert p.smem_bytes <= stencil.SMEM_LIMIT
        images, tiles_h, tiles_w, slabs = p.grid(shape)
        staged_rows, staged_cols = p.staged
        slots = p.threads // p.cvt
        rows, cols, chans = np.zeros(h, int), np.zeros(w, int), np.zeros(c, int)
        for ti in range(tiles_h):
            i0 = ti * p.rows
            # Staged row s holds gradient row clamp(2*i0 - 1 + s).
            window = np.clip(2 * i0 - 1 + np.arange(staged_rows), 0, 2 * h - 1)
            for slot in range(slots):  # slot takes dx rows r = slot, slot + slots, ... < rows
                for r in range(slot, p.rows, slots):
                    i = i0 + r
                    if i >= h:
                        break
                    rows[i] += 1
                    taps = 2 * r + np.arange(4)  # staged rows 2r .. 2r + 3
                    assert taps[-1] < staged_rows
                    assert (window[taps] == np.clip(2 * i - 1 + np.arange(4), 0, 2 * h - 1)).all()
        for tj in range(tiles_w):
            j0 = tj * p.tile_w
            window = np.clip(2 * j0 - 1 + np.arange(staged_cols), 0, 2 * w - 1)
            for jj in range(min(p.tile_w, w - j0)):
                cols[j0 + jj] += 1
                taps = 2 * jj + np.arange(4)  # staged columns 2jj .. 2jj + 3
                assert taps[-1] < staged_cols
                j = j0 + jj
                assert (window[taps] == np.clip(2 * j - 1 + np.arange(4), 0, 2 * w - 1)).all()
        for slab in range(slabs):  # vectors whose first channel is below c
            for v in range(p.cvt):
                ch = (slab * p.cvt + v) * p.vec
                if ch < c:
                    chans[ch : ch + p.vec] += 1
        assert images == n
        assert (rows == 1).all() and (cols == 1).all() and (chans == 1).all()


@pytest.mark.parametrize("shape, blocks", [((32, 16, 16, 1024), 2 * 132), ((8, 16, 16, 1024), 132)])
def test_up2_bwd_plan_fills_the_card_at_the_smallest_unet_shape(shape, blocks):
    """K3ᵀ's smallest U-Net output in bf16 still gives at least two blocks
    per SM (132 SMs) in an inference chunk and one per SM in a train
    step."""
    p = stencil.up2_bwd_plan(shape, 2)
    assert np.prod(p.grid(shape)) >= blocks
    assert 2 * p.smem_bytes <= stencil.SMEM_LIMIT  # two blocks fit one SM


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adjoint_kernels_bit_equal_plain_adjoints_on_gpu(dtype):
    dev = tp.cuda_device()
    cases = [("pool", s) for s in WF6_POOL + UNET_POOL + ODD + [(2, 1, 5, 8)]]
    cases += [("pool", (8, s[1] // 2) + s[2:]) for s in WF6_POOL]  # the bands' shapes
    cases += [("up", s) for s in WF6_UP + UNET_UP + ODD + TILES + BANDS_UP]
    for i, (op, shape) in enumerate(cases):
        out = _pool_out(shape) if op == "pool" else _up_out(shape)
        g = torch.from_numpy(_normal(out, 20 + i)).to(dev, dtype)
        fn = stencil.avg_pool2_bwd if op == "pool" else stencil.bilinear_up2_bwd
        before = fn.launches
        if op == "pool":
            got, want = fn(g, shape), stencil.avg_pool2_bwd_reference(g, shape)
        else:
            got, want = fn(g), stencil.bilinear_up2_bwd_reference(g)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, (op, shape)
        assert got.shape == shape and got.is_contiguous()
        assert torch.equal(_bits(got), _bits(want)), (op, shape)


@pytest.mark.cuda
def test_adjoint_kernels_scalar_path_on_unaligned_input():
    """A base that is not 16-byte aligned takes the adjoints' scalar path."""
    dev = tp.cuda_device()
    shape = (2, 6, 10, 8)
    for out, seed in ((_pool_out(shape), 12), (_up_out(shape), 13)):
        flat = torch.from_numpy(_normal((1 + int(np.prod(out)),), seed)).to(dev)
        g = flat[1:].view(out)
        assert g.data_ptr() % 16 != 0
        if out == _pool_out(shape):
            got, want = stencil.avg_pool2_bwd(g, shape), stencil.avg_pool2_bwd_reference(g, shape)
        else:
            got, want = stencil.bilinear_up2_bwd(g), stencil.bilinear_up2_bwd_reference(g)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), out


@pytest.mark.cuda
def test_autograd_launches_forward_and_adjoint_kernels_on_gpu():
    dev = tp.cuda_device()
    counters = (stencil.avg_pool2, stencil.bilinear_up2, stencil.avg_pool2_bwd,
                stencil.bilinear_up2_bwd)
    x = torch.from_numpy(_normal((2, 16, 16, 8), 9)).to(dev).requires_grad_()
    before = [f.launches for f in counters]
    y = stencil.bilinear_up2(stencil.avg_pool2(x))
    (y * y).sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1]
    xc = x.detach().cpu().requires_grad_()
    yc = stencil.bilinear_up2(stencil.avg_pool2(xc))
    (yc * yc).sum().backward()
    assert torch.equal(x.grad.cpu(), xc.grad)
