"""The device mesh (counterpart of ``lungmask_tpu.parallel.mesh``).

A :class:`Mesh` is a (data, space) grid of ``torch.device``\\ s, driven by
one process, as JAX's single controller drives its local devices:

* ``data`` — the slices of a volume (or of a training batch) split over
  the devices, each part held and computed on its own device;
* ``space`` — the slice height of each data device's part split into
  bands (:func:`split_bands`), band s of data row d held and computed on
  ``devices[d, s]``; the U-Net's 3×3 convolutions and upsampling read one
  halo row from each neighbouring band (``parallel/halo.py``), where JAX's
  partitioner inserts the same exchanges.

A device may appear more than once: ``make_mesh(devices=["cpu"] * 2)`` is a
two-way data mesh on the CPU (the tests' stand-in for JAX's virtual CPU
devices), ``[cuda:0, cuda:0]`` two shards on one card. A tensor split over
the data axis is a list of its parts, one per data device, in mesh order;
split over both axes, a list (over data) of lists (over space) of blocks.
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
        """The devices along the data axis, in order (the first of each data
        row)."""
        return list(self.devices[:, 0])

    def space_devices(self, d: int) -> List[torch.device]:
        """The devices of data row ``d`` along the space axis, in order."""
        return list(self.devices[d])

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
    CPU. Device i sits at ``[i // space, i % space]``, JAX's order."""
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
    if n == 0 or space < 1 or data * space != n:
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


def split_bands(h: int, space: int, depth: int = 5) -> List[Tuple[int, int]]:
    """``space`` contiguous [start, stop) row ranges covering ``range(h)``
    whose starts are multiples of ``2 ** (depth - 1)`` (16 for the
    production U-Net), so that every pooling level of a ``depth``-level
    U-Net stays inside each band: the whole blocks of that many rows split
    by :func:`split_rows`, the last band taking the rows left over. A band
    is empty when ``h`` has fewer blocks than ``space``."""
    block = 2 ** (depth - 1)
    bands = [(a * block, b * block) for a, b in split_rows(h // block, space)]
    bands[-1] = (bands[-1][0], h)
    return bands


def _to(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def shard_rows(mesh: Mesh, x) -> List[torch.Tensor]:
    """``x`` (N, ...) (a tensor or numpy array) split along axis 0 over the
    data axis by :func:`split_rows` (any N), each part on its device."""
    devs = mesh.data_devices
    return [_to(x[a:b], dev) for (a, b), dev in zip(split_rows(x.shape[0], len(devs)), devs)]


def shard_bands(mesh: Mesh, d: int, x, depth: int = 5) -> List[torch.Tensor]:
    """``x`` (n, H, ...) split along axis 1 by :func:`split_bands` over the
    space devices of data row ``d``, each band on its device."""
    devs = mesh.space_devices(d)
    bands = split_bands(x.shape[1], len(devs), depth)
    return [_to(x[:, a:b], dev) for (a, b), dev in zip(bands, devs)]


def shard_blocks(mesh: Mesh, x, depth: int = 5) -> List[List[torch.Tensor]]:
    """``x`` (N, H, ...) split along axis 0 over the data axis
    (:func:`split_rows`) and each part along axis 1 over its row's space
    devices (:func:`shard_bands`): block [d][s] on ``devices[d, s]``."""
    return [shard_bands(mesh, d, x[a:b], depth)
            for d, (a, b) in enumerate(split_rows(x.shape[0], mesh.shape["data"]))]


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
    """(N, H, W[, C]) batches: N over 'data' (each part's H over 'space' is
    :func:`shard_bands`'s)."""
    return Sharding(mesh, split=True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, split=False)


def shard_batch(mesh: Mesh, batch) -> List[torch.Tensor]:
    return batch_sharding(mesh).place(batch)


def replicate(mesh: Mesh, tree) -> list:
    return replicated(mesh).place(tree)
