"""The device mesh (counterpart of ``lungmask_tpu.parallel.mesh``).

A :class:`Mesh` is a (data, space) grid of ``torch.device``\\ s, driven by
one process, as JAX's single controller drives its local devices:

* ``data`` — the slices of a volume (or of a training batch) split over
  the devices, each part held and computed on its own device;
* ``space`` — the slice height split into bands with halo rows. Not ported
  yet: ``space > 1`` raises (ROADMAP.md queue 1, item 10b).

A device may appear more than once: ``make_mesh(devices=["cpu"] * 2)`` is a
two-way data mesh on the CPU (the tests' stand-in for JAX's virtual CPU
devices), ``[cuda:0, cuda:0]`` two shards on one card. A tensor split over
the data axis is a list of its parts, one per data device, in mesh order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lungmask_tpu_torch.utils.device import resolve_device


class Mesh:
    """A (data, space) grid of devices; ``devices`` is the object array of
    ``torch.device``\\ s, ``shape`` maps each axis name to its size."""

    axis_names = ("data", "space")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> List[torch.device]:
        """The devices along the data axis, in order."""
        return list(self.devices[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def make_mesh(
    n_devices: Optional[int] = None,
    data: Optional[int] = None,
    space: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (data, space) mesh over ``devices`` (every visible CUDA device by
    default; each entry anything ``torch.device`` takes), the first
    ``n_devices`` of them when given. ``data`` defaults to all the devices.
    Without a CUDA device the default raises, unless ``devices`` names the
    CPU."""
    if space != 1:
        raise NotImplementedError(
            "the mesh's space axis (height bands with halo rows) is not ported to "
            "lungmask_tpu_torch yet (ROADMAP.md queue 1, item 10b); use space=1"
        )
    if devices is None:
        devices = [resolve_device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
        if not devices:
            resolve_device("cuda")  # raises: no CUDA device
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if data is None:
        data = n // space
    if n == 0 or data * space != n:
        raise ValueError(f"{data}x{space} mesh does not match {n} devices")
    grid = np.empty((data, space), dtype=object)
    for i, dev in enumerate(devices):
        grid[i // space, i % space] = dev
    return Mesh(grid)


def split_rows(n: int, parts: int) -> List[Tuple[int, int]]:
    """``parts`` contiguous [start, stop) ranges covering ``range(n)``, the
    first ``n % parts`` one row longer than the rest."""
    base, extra = divmod(n, parts)
    bounds = np.cumsum([0] + [base + (i < extra) for i in range(parts)])
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def _to(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def shard_rows(mesh: Mesh, x) -> List[torch.Tensor]:
    """``x`` (N, ...) (a tensor or numpy array) split along axis 0 over the
    data axis by :func:`split_rows` (any N), each part on its device."""
    devs = mesh.data_devices
    return [_to(x[a:b], dev) for (a, b), dev in zip(split_rows(x.shape[0], len(devs)), devs)]


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: split along axis 0 over the data axis
    (``split``; the axis must divide evenly, as a JAX ``NamedSharding``
    requires) or a whole copy on each data device."""

    mesh: Mesh
    split: bool

    def place(self, x) -> list:
        """``x`` laid out so: a list with one entry per data device. A
        replicated ``x`` may be a tree of dicts and lists of tensors."""
        devs = self.mesh.data_devices
        if not self.split:
            return [_tree_to(x, dev) for dev in devs]
        if x.shape[0] % len(devs):
            raise ValueError(
                f"a batch of {x.shape[0]} does not split evenly over the mesh's "
                f"{len(devs)}-way data axis"
            )
        return shard_rows(self.mesh, x)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return _to(tree, device)


def batch_sharding(mesh: Mesh) -> Sharding:
    """(N, H, W[, C]) batches: N over 'data'."""
    return Sharding(mesh, split=True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, split=False)


def shard_batch(mesh: Mesh, batch) -> List[torch.Tensor]:
    return batch_sharding(mesh).place(batch)


def replicate(mesh: Mesh, tree) -> list:
    return replicated(mesh).place(tree)
