"""nnU-Net's 3-D U-Net in the port (``models/unet3d.py``), its resampling
(``ops/resample3d.py``), its preprocessing (``transforms/nnunet3d.py``) and
its kernel (a) (``ops/kernels/norm3d``), against the plain reference of the
benchmark (``portbench/reference/nnunet3d.py``: float32 torch, SciPy's
``zoom``, ``gaussian_filter`` and ``binary_fill_holes``) at a small size.

Tolerances, each with its reason:

* float32 network: 1e-5 of the logits' largest magnitude; the port drops
  the conv biases that the InstanceNorm cancels and sums in another order,
  so the two differ by float32 rounding only;
* bf16 network: 3% of the logits' norm; 14 convs round their inputs and
  outputs to bf16 (2^-9 relative each) and the InstanceNorm rescales what
  is left, so the error grows with depth to about 1%;
* resampling: 2e-6 absolute on unit-variance data; the port applies
  float64 matrices in float32 (one rounding of the matrix, float32 sums),
  SciPy works in float64;
* kernel (a): on the card, ≤ 0.01% of outputs more than one bf16 step
  (2^-7 relative) from the plain version, whose statistics are summed in
  another order.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import ndimage

import torch_parity as tp
from lungmask_tpu_torch.models import convert, registry, unet3d
from lungmask_tpu_torch.ops import resample3d
from lungmask_tpu_torch.ops.kernels import norm3d
from lungmask_tpu_torch.runtime import sliding_window as sw
from lungmask_tpu_torch.transforms import nnunet3d as prep
from portbench import spec
from portbench.reference import nnunet3d as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLAN = {
    "architecture": "nnunet3d", "in_channels": 1, "features": [4, 8, 16, 16],
    "convs_per_stage": 2, "decoder_convs_per_stage": 2, "kernel": 3, "strides": [1, 2, 2, 2],
    "norm_eps": 1e-5, "leaky_slope": 0.01, "patch": [32, 32, 32], "spacing": 1.5, "step": 0.5,
    "sigma_scale": 0.125, "data_order": 3, "logit_order": 1, "n_classes": 6,
    "patches_per_forward": 2, "ct": {"mean": -700.0, "std": 200.0, "lower": -1024.0, "upper": 300.0},
}
FULL = dict(PLAN, features=[32, 64, 128, 256, 320, 320], strides=[1, 2, 2, 2, 2, 2],
            patch=[128, 128, 128])


def seeded_params(seed: int = 0, plan=PLAN):
    """The port's seeded weights with seeded biases and norm affines, so
    that every parameter matters."""
    p = unet3d.init_params(plan, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    for k, v in p.items():
        if v.ndim == 1:
            p[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 0.03)])
def test_network_matches_reference(dtype, tol):
    p = seeded_params()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 1, 32, 32, 32))
                         .astype(np.float32))
    got = unet3d.UNet3D(p, PLAN, "cpu", dtype)(x).float()
    want = ref.logits(ref.tensors(p, "cpu"), x, PLAN)
    assert got.shape == want.shape == (2, 6, 32, 32, 32)
    if dtype == torch.float32:
        assert (got - want).abs().max() <= tol * want.abs().max()
    else:
        assert (got - want).norm() <= tol * want.norm()


def test_published_widths_and_the_benchmarks_count():
    """31.2 M parameters (the inference head's); the benchmark's count of
    a 192×512² volume at 0.7×0.7×1.5 mm: 18 patches of 0.955 TFLOP."""
    n = sum(int(np.prod(s)) for k, s in unet3d.leaf_shapes(FULL)
            if "seg_layers" not in k or k.startswith(unet3d.head_key(FULL)))
    assert n == pytest.approx(31.2e6, rel=2e-3)
    fam = spec.family({"family": "nnunet3d"})
    assert [k for k, _ in fam.leaf_shapes(FULL)] == [k for k, _ in unet3d.leaf_shapes(FULL)]
    cost = fam.forward_cost(FULL, (192, 512, 512), (0.7, 0.7, 1.5))
    assert cost["patches"] == 18
    assert cost["flops"] == pytest.approx(18 * 0.955e12, rel=1e-3)


@pytest.mark.parametrize("patch", [(32, 32, 32), (128, 128, 128), (20, 33, 17)])
def test_gaussian_map_matches_reference(patch):
    got = sw.gaussian_map(patch, 0.125)
    want = ref.gaussian(patch, 0.125)
    assert got.dtype == np.float32 and got.shape == patch
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got.max() == pytest.approx(10.0) and got.min() > 0


@pytest.mark.parametrize("size,patch,want", [
    ((192, 239, 239), (128, 128, 128), [[0, 64], [0, 56, 111], [0, 56, 111]]),
    ((128, 129, 300), (128, 128, 128), [[0], [0, 1], [0, 57, 115, 172]]),
    ((32, 45, 33), (32, 32, 32), [[0], [0, 13], [0, 1]]),
    ((64, 80, 96), (32, 32, 32), [[0, 16, 32], [0, 16, 32, 48], [0, 16, 32, 48, 64]]),
])
def test_window_steps_table(size, patch, want):
    assert sw.compute_steps(size, patch, 0.5) == want == ref.steps(size, patch, 0.5)


@pytest.mark.parametrize("shape,patch,pads,count", [
    ((24, 30, 45), (32, 32, 32), [(4, 4), (1, 1), (0, 0)], 2),
    ((31, 32, 5), (32, 32, 32), [(0, 1), (0, 0), (13, 14)], 1),
])
def test_volume_under_the_patch_is_padded(shape, patch, pads, count):
    assert sw.padding(shape, patch) == pads
    padded = [n + a + b for n, (a, b) in zip(shape, pads)]
    assert int(np.prod([len(s) for s in sw.compute_steps(padded, patch, 0.5)])) == count


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("shape,out", [((7, 20, 33), (9, 11, 40)), ((5, 64, 64), (5, 30, 30)),
                                       ((3, 1, 8), (6, 2, 3)), ((6, 6, 6), (6, 6, 6))])
def test_zoom_matches_scipy(order, shape, out):
    x = np.random.default_rng(7).standard_normal(shape)
    want = ndimage.zoom(x, [o / i for o, i in zip(out, shape)], order=order, mode="nearest",
                        grid_mode=True)
    got = resample3d.zoom(torch.from_numpy(x).float(), out, order).double().numpy()
    assert got.shape == want.shape == out
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_resampled_shape_rounds_as_nnunet():
    assert resample3d.resampled_shape((192, 512, 512), (1.5, 0.7, 0.7), 1.5) == (192, 239, 239)
    assert resample3d.resampled_shape((10, 15, 45), (1.5, 0.5, 0.5), 1.5) == (10, 5, 15)


@pytest.mark.parametrize("case", ["all", "frame", "none", "hole"])
def test_nonzero_box_matches_reference(case):
    vol = np.random.default_rng(3).integers(1, 100, (12, 14, 16)).astype(np.int16)
    if case == "frame":
        vol[:2], vol[:, -3:], vol[:, :, :1] = 0, 0, 0
    elif case == "none":
        vol[:] = 0
    elif case == "hole":
        vol[:] = 0
        vol[3:9, 2:12, 4:10] = 5
        vol[5:7, 5:8, 6:8] = 0  # enclosed: filled by the reference, inside its box anyway
    got = prep.nonzero_box(torch.from_numpy(vol))
    assert got == ref.nonzero_box(vol)


def test_preprocess_matches_reference():
    """Crop, CT normalisation and the cubic resample (as the zoom's
    tolerance, plus 2e-6 relative: values up to 5 after the z-score, three
    float32 passes)."""
    rng = np.random.default_rng(5)
    vol = rng.integers(-1100, 400, (20, 40, 44)).astype(np.int16)
    vol[:, :3] = 0
    got = prep.preprocess(vol, (2.0, 0.7, 0.8), PLAN, "cpu")
    want, box, crop = ref.preprocess(vol, (2.0, 0.7, 0.8), PLAN)
    assert got["box"] == box and got["crop_shape"] == crop and got["full_shape"] == vol.shape
    assert tuple(got["normalized"].shape) == want.shape == (27, 17, 23)
    np.testing.assert_allclose(got["normalized"].numpy(), want, rtol=2e-6, atol=2e-6)


def test_model_plan_travels_with_the_weights(tmp_path):
    path = str(tmp_path / "m3d.npz")
    p = seeded_params()
    convert.save_npz(path, p, meta={"architecture": "nnunet3d", "plan": PLAN})
    assert registry.model_plan(path) == PLAN
    flat, k = registry.get_model("R231", path)
    assert k == 6 and set(flat) == set(p)
    assert all(np.array_equal(flat[key], p[key]) for key in p)
    two_d = str(tmp_path / "m2d.npz")
    convert.save_npz(two_d, {"last": {"b": np.zeros(3, np.float32)}}, meta={"model": "R231"})
    assert registry.model_plan(two_d) == {} and registry.model_plan("x.pth") == {}


def test_missing_weights_are_named():
    p = seeded_params()
    del p["decoder.transpconvs.1.weight"]
    with pytest.raises(KeyError, match="transpconvs.1.weight"):
        unet3d.UNet3D(p, PLAN, "cpu", torch.float32)


@pytest.mark.parametrize("shape", [(2, 4, 8, 8, 8), (1, 20, 3, 5, 7), (3, 64, 2, 2, 2)])
def test_norm_plain_version_matches_torch(shape):
    """The plain version is torch's instance_norm + leaky_relu (float32)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=g) * 3 + 2
    w, b = torch.rand(shape[1], generator=g) + 0.5, torch.randn(shape[1], generator=g)
    got = norm3d.instance_norm_leaky(x, w, b, 1e-5, 0.01)
    want = torch.nn.functional.leaky_relu(
        torch.nn.functional.instance_norm(x, weight=w, bias=b, eps=1e-5), 0.01)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    out = x.clone()
    assert norm3d.instance_norm_leaky(out, w, b, 1e-5, 0.01, out=out) is out
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,v,c", [(2, 128 ** 3, 32), (2, 4 ** 3, 320), (1, 7, 3), (2, 16 ** 3, 256)])
def test_norm_launch_plan_covers_every_row(n, v, c):
    p = norm3d.launch_plan(n, v, c)
    assert p["BC"] * p["n_cb"] >= c and p["rows"] % p["BV"] == 0
    assert p["rows"] * p["nblk"] >= v > p["rows"] * (p["nblk"] - 1)
    assert p["BC"] & (p["BC"] - 1) == 0 and p["BV"] & (p["BV"] - 1) == 0


def test_two_d_path_imports_no_3d_module(tmp_path):
    """With a lungmask 2-D model only, none of the 3-D modules, their
    kernels or Triton is imported."""
    code = (
        "import sys, numpy as np\n"
        "from lungmask_tpu_torch import LMInferer\n"
        "from lungmask_tpu_torch.models import convert, synthetic\n"
        f"convert.save_npz({str(tmp_path / 'w.npz')!r}, synthetic.laterality_params(wf=2))\n"
        f"inf = LMInferer(modelpath={str(tmp_path / 'w.npz')!r}, device='cpu', precision='float32',"
        " tqdm_disable=True)\n"
        "inf.apply(synthetic.lung_phantom(2, size=64))\n"
        "bad = sorted(m for m in sys.modules if m == 'triton' or m.startswith('triton.') or\n"
        "             m.split('.')[-1] in ('unet3d', 'sliding_window', 'norm3d', 'export3d',\n"
        "                                  'resample3d', 'nnunet3d'))\n"
        "print(bad)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


# -- on the card ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,s,dtype", [(2, 32, 64, torch.bfloat16), (2, 320, 4, torch.bfloat16),
                                         (1, 48, 9, torch.bfloat16), (2, 64, 16, torch.float32)])
def test_norm_kernel_matches_plain_version_on_gpu(n, c, s, dtype):
    dev = tp.cuda_device()
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn((n, c, s, s, s), generator=g, device=dev) * 3 + 1.5).to(dtype).contiguous(
        memory_format=torch.channels_last_3d)
    w = torch.rand(c, generator=g, device=dev) + 0.5
    b = torch.randn(c, generator=g, device=dev) * 0.1
    before = norm3d.instance_norm_leaky.launches
    got = norm3d.instance_norm_leaky(x, w, b, 1e-5, 0.01)
    torch.cuda.synchronize()
    assert norm3d.instance_norm_leaky.launches == before + 1
    want = norm3d.instance_norm_leaky_reference(x, w, b, 1e-5, 0.01).float()
    far = (got.float() - want).abs() > want.abs() * 2 ** -7 + 1e-6
    assert far.float().mean().item() <= 1e-4
    inplace = x.clone(memory_format=torch.channels_last_3d)
    norm3d.instance_norm_leaky(inplace, w, b, 1e-5, 0.01, out=inplace)
    assert torch.equal(inplace, got)


@pytest.mark.cuda
def test_norm_kernel_refuses_other_layouts_on_gpu():
    dev = tp.cuda_device()
    x = torch.randn((1, 8, 4, 4, 4), device=dev)  # contiguous, not channels_last_3d
    with pytest.raises(ValueError, match="channels_last_3d"):
        norm3d.instance_norm_leaky(x, torch.ones(8, device=dev), torch.zeros(8, device=dev),
                                   1e-5, 0.01)


@pytest.mark.cuda
def test_network_on_gpu_matches_reference():
    dev = tp.cuda_device()
    p = seeded_params()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 1, 32, 32, 32))
                         .astype(np.float32)).to(dev)
    got = unet3d.UNet3D(p, PLAN, dev, torch.bfloat16)(x).float()
    torch.cuda.synchronize()
    with torch.no_grad():
        want = ref.logits(ref.tensors(p, dev), x, PLAN)
    assert (got - want).norm() <= 0.03 * want.norm()

