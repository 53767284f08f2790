"""The port runs where neither JAX nor the JAX package nor tqdm nor Pillow
exists.

Each check runs in a fresh interpreter in which ``import jax``,
``import lungmask_tpu``, ``import tqdm`` and ``import PIL`` raise ImportError
(``sys.modules[name] = None``), as on the GPU machine.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BLOCK = (
    "import sys\n"
    "for name in ('jax', 'jaxlib', 'lungmask_tpu', 'tqdm', 'PIL'):\n"
    "    sys.modules[name] = None\n"
)


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", _BLOCK + code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )


def test_port_imports_without_jax_or_tqdm():
    res = _run(
        "import lungmask_tpu_torch, lungmask_tpu_torch.cli, lungmask_tpu_torch.inferer\n"
        "import lungmask_tpu_torch.compat, lungmask_tpu_torch.io\n"
        "from lungmask_tpu_torch.io import analyze, codecs, dicom, gipl, htj2k, htj2k_stream\n"
        "from lungmask_tpu_torch.io import loader, mha, nifti, nohu, nrrd, vtk\n"
        "import lungmask_tpu_torch.transforms.postprocess\n"
        "import lungmask_tpu_torch.transforms.postprocess_device\n"
        "import lungmask_tpu_torch.transforms.host_pipeline\n"
        "import lungmask_tpu_torch.runtime.cohort, lungmask_tpu_torch.runtime.serve\n"
        "import lungmask_tpu_torch.metrics\n"
        "import lungmask_tpu_torch.ops.kernels.bodymask, lungmask_tpu_torch.ops.kernels.stencil\n"
        "import lungmask_tpu_torch.ops.kernels.conv_stage\n"
        "import lungmask_tpu_torch.train\n"
        "from lungmask_tpu_torch.train import (augment, checkpoint, data, finetune, loop, optim,\n"
        "                                      store, trainer)\n"
        "import lungmask_tpu_torch.parallel\n"
        "from lungmask_tpu_torch.parallel import halo, mesh, multihost, sharded\n"
        "import lungmask_tpu_torch.models, lungmask_tpu_torch.runtime\n"
        "import lungmask_tpu_torch.tools.convert_weights, lungmask_tpu_torch.utils.profiling\n"
        "from lungmask_tpu_torch.tools import layer_bench, roofline, serve_probe\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'lungmask_tpu', 'tqdm', 'PIL'))\n"
        "assert not bad, bad\n"
        "print('ok', lungmask_tpu_torch.__version__)\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok 0.1.0")


def test_finetune_entry_point_without_jax():
    res = _run(
        "import runpy\n"
        "sys.argv = ['finetune', '--help']\n"
        "runpy.run_module('lungmask_tpu_torch.train.finetune', run_name='__main__')\n"
    )
    assert res.returncode == 0, res.stderr
    assert "--cpu" in res.stdout and "--resolution" in res.stdout


@pytest.mark.parametrize("flag", ["--help", "--version"])
def test_cli_entry_point_without_jax(flag):
    res = _run(
        "import runpy\n"
        f"sys.argv = ['lungmask-torch', '{flag}']\n"
        "runpy.run_module('lungmask_tpu_torch', run_name='__main__')\n"
    )
    assert res.returncode == 0, res.stderr
    assert ("--modelpath" in res.stdout) if flag == "--help" else ("0.1.0" in res.stdout)


@pytest.mark.parametrize("example", ["segment_volume", "cohort_streaming", "finetune"])
def test_examples_without_jax(example):
    """Each of ``examples/torch/`` imports with the machine's missing
    packages blocked, and run with no arguments prints its usage."""
    res = _run(
        "import importlib.util, os, runpy\n"
        f"path = os.path.join('examples', 'torch', '{example}.py')\n"
        "spec = importlib.util.spec_from_file_location('example', path)\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'lungmask_tpu', 'tqdm', 'PIL'))\n"
        "assert not bad, bad\n"
        "sys.argv = [path]\n"
        "runpy.run_path(path, run_name='__main__')\n"
    )
    assert res.returncode != 0 and "Traceback" not in res.stderr, res.stderr
    # the usage line of its docstring, or the recipe's argparse usage
    assert "examples/torch/" in res.stderr or "usage: finetune.py" in res.stderr, res.stderr


def test_weight_store_and_converter_without_jax(tmp_path):
    """A release checkpoint fetched from a ``file://`` URL, verified,
    converted and cached by the registry, and the offline converter, with
    the machine's missing packages blocked."""
    res = _run(
        "import hashlib, os, runpy, torch\n"
        "from lungmask_tpu_torch.models import convert, registry, synthetic\n"
        "sd = synthetic.reference_state_dict(3, depth=2, wf=2)\n"
        f"tmp = {str(tmp_path)!r}\n"
        "src = os.path.join(tmp, 'unet_r231.pth')\n"
        "torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)\n"
        "sha = hashlib.sha256(open(src, 'rb').read()).hexdigest()\n"
        "pth = os.path.join(tmp, f'unet_r231-{sha[:8]}.pth')\n"
        "os.replace(src, pth)\n"
        "registry.MODEL_URLS['R231'] = ('file://' + pth, 3)\n"
        "os.environ['LUNGMASK_TPU_CACHE'] = os.path.join(tmp, 'cache')\n"
        "params, n = registry.get_model('R231')\n"
        "meta = convert.load_npz(registry._npz_cache_path('R231'))[1]\n"
        "assert n == 3 and meta['source_sha256'] == sha, meta\n"
        "sys.argv = ['convert_weights', pth, os.path.join(tmp, 'out.npz')]\n"
        "runpy.run_module('lungmask_tpu_torch.tools.convert_weights', run_name='__main__')\n"
        "out = convert.load_npz(os.path.join(tmp, 'out.npz'))\n"
        "assert out[1] == {'source': os.path.basename(pth)}, out[1]\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'lungmask_tpu', 'tqdm', 'PIL'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_dicom_series_without_jax_tqdm_or_pillow(tmp_path):
    """A DICOM series written, scanned and read back (the scan's progress
    bar without tqdm), and an HTJ2K frame encoded and decoded, with the
    machine's missing packages blocked."""
    res = _run(
        "import numpy as np\n"
        "from lungmask_tpu_torch.io import codecs, image, loader\n"
        "vol = np.arange(3 * 16 * 16, dtype=np.int16).reshape(3, 16, 16) - 400\n"
        f"out = {str(tmp_path / 'mask.dcm')!r}\n"
        "loader.write_image(image.MedicalImage(vol, spacing=(0.7, 0.7, 2.5)), out)\n"
        "back = loader.load_input_image(out.rsplit('/', 1)[0])\n"
        "assert np.array_equal(back.array, vol) and back.spacing == (0.7, 0.7, 2.5)\n"
        "assert np.array_equal(codecs.j2k_decode(codecs.htj2k_encode(vol[0])), vol[0])\n"
        "print('ok')\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_halo_bands_without_jax():
    """``parallel/halo.py`` imported first in a fresh interpreter (so every
    module it reaches is imported by it), then a banded forward and a
    banded cleanup over a space mesh, with the machine's missing packages
    blocked."""
    res = _run(
        "from lungmask_tpu_torch.parallel import halo\n"
        "import numpy as np, torch\n"
        "from lungmask_tpu_torch.models import unet\n"
        "from lungmask_tpu_torch.parallel import make_mesh, make_sharded_postprocess\n"
        "from lungmask_tpu_torch.parallel.mesh import split_bands\n"
        "model = unet.UNet(unet.init_params(3, wf=2, generator=torch.Generator().manual_seed(0)))\n"
        "x = torch.rand(1, 64, 32, 1)\n"
        "out = model.logits(halo.Bands([x[:, a:b] for a, b in split_bands(64, 2)]))\n"
        "assert torch.allclose(torch.cat(out.parts, 1), model.logits(x), atol=1e-5)\n"
        "mesh = make_mesh(devices=['cpu'] * 2, space=2)\n"
        "blocks = make_sharded_postprocess(mesh, 3)(torch.zeros((2, 32, 8), dtype=torch.uint8))\n"
        "assert [tuple(b.shape) for b in blocks[0]] == [(2, 16, 8), (2, 16, 8)]\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'lungmask_tpu', 'tqdm', 'PIL'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_mesh_and_variant_unets_without_jax():
    """The mesh, the sharded runner and cleanup, the multi-process helpers
    and the residual and upconv U-Nets import and construct, with the
    machine's missing packages blocked."""
    res = _run(
        "import numpy as np, torch\n"
        "from lungmask_tpu_torch.models import convert, synthetic, unet\n"
        "from lungmask_tpu_torch.parallel import ShardedUNetRunner, make_mesh\n"
        "from lungmask_tpu_torch.parallel import make_sharded_postprocess, multihost\n"
        "mesh = make_mesh(devices=['cpu'] * 2)\n"
        "for residual, up in ((True, 'upsample'), (False, 'upconv'), (True, 'upconv')):\n"
        "    sd = synthetic.reference_state_dict(3, depth=3, wf=2, residual=residual, up_mode=up)\n"
        "    params = convert.convert_state_dict(sd)\n"
        "    model = unet.UNet(convert.from_jax_params(params), trainable=True)\n"
        "    runner = ShardedUNetRunner(params, 3, mesh=mesh, batch_size=2)\n"
        "    out = runner.run(np.zeros((3, 32, 32), np.float32))\n"
        "    assert [tuple(o.shape) for o in out] == [(2, 32, 32), (1, 32, 32)]\n"
        "make_sharded_postprocess(mesh, 3)\n"
        "assert multihost.shard_cohort([1, 2, 3]) == [1, 2, 3]\n"
        "assert multihost.initialize_multihost() is False\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'lungmask_tpu', 'tqdm', 'PIL'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
