"""Several processes in the port (``lungmask_tpu_torch.parallel.multihost``):
the cohort partition, the single-host no-op, and two processes joined by a
gloo group on the CPU (``init_method=file://``, loopback), each holding a
one-device CPU mesh.

Tolerances: the train step after the all-reduce against the one-process
step over the whole batch — the loss within 1e-5 relative, every gradient
leaf within 1e-5 of its largest gradient; the cohort's masks bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.io import image, loader
from lungmask_tpu_torch.models import convert, synthetic
from lungmask_tpu_torch.parallel import multihost
from lungmask_tpu_torch.runtime.cohort import run_cohort
from lungmask_tpu_torch.train import init_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT = 120  # seconds, each process

_WORKER = r"""
import glob, json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
from lungmask_tpu_torch import LMInferer
from lungmask_tpu_torch.models import convert
from lungmask_tpu_torch.parallel import make_mesh, multihost
from lungmask_tpu_torch.runtime.cohort import run_cohort
from lungmask_tpu_torch.train import init_train_state, make_train_step

rank, init, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert multihost.initialize_multihost("file://" + init, num_processes=2, process_id=rank)


class Recorder:
    def init(self, params):
        return None

    def update(self, grads, state, params):
        self.grads = {k: g.clone() for k, g in grads.items()}
        return {k: torch.zeros_like(g) for k, g in grads.items()}, state


data = np.load(os.path.join(work, "batch.npz"))
half = data["images"].shape[0] // 2
mine = slice(rank * half, (rank + 1) * half)
params, _ = convert.load_npz(os.path.join(work, "train.npz"))
rec = Recorder()
state = init_train_state(convert.from_jax_params(params), rec)
step = make_train_step(rec, mesh=make_mesh(devices=["cpu"]), compute_dtype=torch.float32)
_, loss = step(state, data["images"][mine], data["labels"][mine])
np.savez(os.path.join(work, f"grads{rank}.npz"), loss=float(loss),
         **{k: g.numpy() for k, g in rec.grads.items()})

sources = multihost.shard_cohort(sorted(glob.glob(os.path.join(work, "cohort", "*.nii"))))
inferer = LMInferer(modelpath=os.path.join(work, "infer.npz"), force_cpu=True,
                    tqdm_disable=True, precision="float32")
os.makedirs(os.path.join(work, f"out{rank}"))
stats = run_cohort(sources, inferer, output_dir=os.path.join(work, f"out{rank}"))
errors = [r.error for r in stats.results if r.error]
assert not errors, errors
torch.distributed.destroy_process_group()
print("RESULT " + json.dumps({"rank": rank, "sources": [os.path.basename(s) for s in sources]}))
"""


def _batch():
    images = tp.blocky_slices(4, 48, 48, seed=8)
    labels = np.zeros((4, 48, 48), np.int32)
    labels[:2, 8:30, 10:38] = 1
    labels[2:, 20:44, 6:24] = 2
    return images, labels


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Run the worker in two processes joined by gloo; their stdout."""
    work = tmp_path_factory.mktemp("multihost")
    images, labels = _batch()
    np.savez(work / "batch.npz", images=images, labels=labels)
    convert.save_npz(str(work / "train.npz"), tp.random_params(n_classes=3, wf=2, seed=3))
    convert.save_npz(str(work / "infer.npz"), synthetic.laterality_params(wf=2))
    (work / "cohort").mkdir()
    for i, n in enumerate((3, 2, 4)):
        loader.write_image(image.MedicalImage(synthetic.lung_phantom(n, size=64)),
                           str(work / "cohort" / f"vol{i}.nii"))
    env = dict(os.environ, PYTHONPATH=REPO, GLOO_SOCKET_IFNAME="lo")
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "JAX_COORDINATOR_ADDRESS"):
        env.pop(name, None)
    init = str(work / "rendezvous")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), init, str(work)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            r = json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT ")][0][7:])
            results[r["rank"]] = r
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return work, results


def test_shard_cohort_explicit_ids():
    vols = list(range(10))
    shards = [multihost.shard_cohort(vols, process_id=i, process_count=3) for i in range(3)]
    assert shards[0] == [0, 3, 6, 9] and shards[2] == [2, 5, 8]
    assert sorted(sum(shards, [])) == vols
    assert multihost.shard_cohort(vols) == vols  # no group: the whole cohort


def test_initialize_noop_single_host(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MASTER_ADDR",
                 "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize_multihost() is False
    assert multihost.initialize_multihost(num_processes=1) is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.initialize_multihost(num_processes=2)


def test_two_process_train_step_equals_one_process(two_processes):
    """Each rank steps on its half of the batch; after the all-reduce both
    hold the one-process step's loss and gradients over the whole batch."""
    work, _ = two_processes
    images, labels = _batch()
    params, _ = convert.load_npz(str(work / "train.npz"))
    rec = tp.GradRecorder()
    state = init_train_state(convert.from_jax_params(params), rec)
    _, loss = make_train_step(rec, compute_dtype=torch.float32)(state, images, labels)
    for rank in range(WORLD):
        got = np.load(work / f"grads{rank}.npz")
        assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-5)
        assert sorted(k for k in got.files if k != "loss") == sorted(rec.grads)
        for k, want in rec.grads.items():
            scale = float(want.abs().max())
            np.testing.assert_allclose(got[k], want.numpy(), rtol=0, atol=1e-5 * scale,
                                       err_msg=f"rank {rank} {k}")


def test_two_process_cohort_equals_one_process(two_processes, tmp_path):
    """``shard_cohort`` + ``run_cohort`` on each rank write, together, the
    masks one process writes for the whole cohort."""
    work, results = two_processes
    assert results[0]["sources"] == ["vol0.nii", "vol2.nii"]
    assert results[1]["sources"] == ["vol1.nii"]
    sources = sorted(str(p) for p in (work / "cohort").iterdir())
    inferer = LMInferer(modelpath=str(work / "infer.npz"), force_cpu=True, tqdm_disable=True,
                        precision="float32")
    run_cohort(sources, inferer, output_dir=str(tmp_path))
    for rank, r in results.items():
        for src in r["sources"]:
            name = src.replace(".nii", "_mask.nii.gz")
            got = loader.load_input_image(str(work / f"out{rank}" / name)).array
            want = loader.load_input_image(str(tmp_path / name)).array
            np.testing.assert_array_equal(got, want)
            assert got.any()
