"""The port runs where neither JAX nor the JAX package nor tqdm exists.

Each check runs in a fresh interpreter in which ``import jax``,
``import lungmask_tpu`` and ``import tqdm`` raise ImportError
(``sys.modules[name] = None``), as on the GPU machine.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BLOCK = (
    "import sys\n"
    "for name in ('jax', 'jaxlib', 'lungmask_tpu', 'tqdm'):\n"
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
        "import lungmask_tpu_torch.transforms.postprocess\n"
        "import lungmask_tpu_torch.transforms.postprocess_device\n"
        "import lungmask_tpu_torch.transforms.host_pipeline\n"
        "import lungmask_tpu_torch.runtime.cohort, lungmask_tpu_torch.runtime.serve\n"
        "import lungmask_tpu_torch.metrics\n"
        "import lungmask_tpu_torch.ops.kernels.bodymask\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'lungmask_tpu', 'tqdm'))\n"
        "assert not bad, bad\n"
        "print('ok', lungmask_tpu_torch.__version__)\n"
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok 0.1.0")


@pytest.mark.parametrize("flag", ["--help", "--version"])
def test_cli_entry_point_without_jax(flag):
    res = _run(
        "import runpy\n"
        f"sys.argv = ['lungmask-torch', '{flag}']\n"
        "runpy.run_module('lungmask_tpu_torch', run_name='__main__')\n"
    )
    assert res.returncode == 0, res.stderr
    assert ("--modelpath" in res.stdout) if flag == "--help" else ("0.1.0" in res.stdout)
