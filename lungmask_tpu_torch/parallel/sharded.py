"""Sharded inference and cleanup over a device mesh (counterpart of
``lungmask_tpu.parallel.sharded``).

One process drives every device of the mesh. The slice stack is split over
the data axis into contiguous slabs (``mesh.split_rows``), one per device,
and stays so: the U-Net's class maps come out as slabs, and the device
cleanup runs on them in place.

* The U-Net (:class:`ShardedUNetRunner`): each device holds the weights
  and runs its slab in sub-batches of ``batch_size / data`` slices; chunk k
  is the k-th sub-batch of every slab, and all of a chunk's sub-batches are
  issued before the next chunk's, with nothing waiting on a device. The JAX
  runner splits each chunk of ``batch_size`` consecutive slices over the
  data axis instead and lets XLA reshard the output into slabs; slices are
  independent, so the maps are the same. Unlike JAX, no slice padding: it
  only bounded the number of compiled programs.
* The cleanup (:func:`make_sharded_postprocess`): per-class largest 3-D
  component and hole fill, bit-equal to ``postprocess_device`` on the
  whole volume. Each slab is labelled on its own device; the boundary
  planes are exchanged between neighbouring slabs; the labels that touch
  across a boundary are united on the host; a merged component's area is
  the sum of its pieces', its id the smallest of its pieces' ids (ids are
  the raster-first linear index + 1 in the whole volume, so the tie-break
  is the whole volume's); a background component is a hole only if none of
  its merged pieces touches the volume's border.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lungmask_tpu_torch.logger import logger
from lungmask_tpu_torch.models import convert
from lungmask_tpu_torch.models.unet import UNet
from lungmask_tpu_torch.ops import cc
from lungmask_tpu_torch.ops.morphology import shift_slices
from lungmask_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch, shard_rows
from lungmask_tpu_torch.runtime.engine import (
    DEFAULT_CHUNK,
    pack_bits,
    pack_bits_for,
    unpack_bits_np,
)


def replicate_unet(mesh: Mesh, params, compute_dtype: torch.dtype = torch.float32) -> List[UNet]:
    """One inference U-Net per data device from a JAX-layout tree (the
    weights replicated); a device named twice holds one."""
    held: Dict[torch.device, UNet] = {}
    for dev in mesh.data_devices:
        if dev not in held:
            held[dev] = UNet(convert.from_jax_params(params, dev), compute_dtype).eval()
    return [held[dev] for dev in mesh.data_devices]


def _argmax(model: UNet, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return torch.argmax(model.logits(x.unsqueeze(-1), compute_dtype), dim=-1).to(torch.uint8)


def _forward_slabs(models, devices, slabs, per: int, compute_dtype, bits: int,
                   chunks: Optional[range] = None) -> List[List[torch.Tensor]]:
    """The packed class maps of each slab's sub-batches number ``chunks``
    (all by default) of ``per`` slices: one list per device. Chunk k is
    issued on every device before chunk k + 1."""
    n_chunks = max(-(-s.shape[0] // per) for s in slabs)
    outs: List[List[torch.Tensor]] = [[] for _ in slabs]
    with torch.inference_mode():
        for k in range(n_chunks) if chunks is None else chunks:
            for out, model, dev, slab in zip(outs, models, devices, slabs):
                x = slab[k * per : (k + 1) * per]
                if x.shape[0]:
                    out.append(pack_bits(_argmax(model, x.to(dev), compute_dtype), bits))
    return outs


def _cat(parts: List[torch.Tensor], like: torch.Tensor, width: int, device) -> torch.Tensor:
    if parts:
        return torch.cat(parts)
    return torch.empty((0, like.shape[1], width), dtype=torch.uint8, device=device)


def make_sharded_argmax(mesh: Mesh, compute_dtype: torch.dtype = torch.float32):
    """``step(models, batch (N, H, W, 1)) → [uint8 (N/d, H, W), ...]``: the
    batch split evenly over the data axis, part d through ``models[d]``
    (:func:`replicate_unet`) on its device."""

    def step(models, batch):
        parts = shard_batch(mesh, batch)
        with torch.inference_mode():
            return [_argmax(m, x[..., 0], compute_dtype) for m, x in zip(models, parts)]

    return step


def make_sharded_volume_argmax(mesh: Mesh, compute_dtype: torch.dtype = torch.float32,
                               bits: int = 8):
    """``step(models, chunks (C, B, H, W)) → [uint8 slab, ...]``: the C·B
    slices split over the data axis into slabs, each device running its
    slab in sub-batches of B / data through ``models[d]``; each slab's class
    map packed on its device (``bits`` 2 or 4 per pixel, 8 dense)."""
    devices = mesh.data_devices

    def step(models, chunks):
        c, b, h, w = chunks.shape
        if b % len(devices):
            raise ValueError(f"a chunk of {b} does not split over {len(devices)} devices")
        slabs = shard_rows(mesh, chunks.reshape(c * b, h, w))
        outs = _forward_slabs(models, devices, slabs, b // len(devices), compute_dtype, bits)
        return [_cat(o, s, w * bits // 8, d) for o, s, d in zip(outs, slabs, devices)]

    return step


def _fetch(t: torch.Tensor, streams: dict):
    """Start the copy of ``t`` to host memory: (host tensor, event to wait
    on, or None for a CPU tensor). On a GPU the copy runs on a side stream
    of ``t``'s device, after the work queued so far on its current stream,
    so later work on that stream overlaps it."""
    if t.device.type != "cuda":
        return t.cpu(), None
    stream = streams.setdefault(t.device, torch.cuda.Stream(t.device))
    stream.wait_stream(torch.cuda.current_stream(t.device))
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        host.copy_(t, non_blocking=True)
        t.record_stream(stream)
        done = torch.cuda.Event()
        done.record(stream)
    return host, done


class ShardedUNetRunner:
    """Mesh-parallel drop-in for ``runtime.engine.UNetRunner`` (module
    docstring)."""

    def __init__(
        self,
        params,
        n_classes: int,
        mesh: Optional[Mesh] = None,
        batch_size: Optional[int] = None,
        compute_dtype: torch.dtype = torch.float32,
    ):
        """``params``: a JAX-layout tree. ``batch_size`` slices per chunk
        over the whole mesh, rounded up to a multiple of the data axis;
        ``None`` gives each device the engine's chunk (``DEFAULT_CHUNK``)."""
        self.mesh = mesh if mesh is not None else make_mesh()
        self.devices = self.mesh.data_devices
        ndata = len(self.devices)
        want = DEFAULT_CHUNK * ndata if batch_size is None else int(batch_size)
        self.batch_size = -(-want // ndata) * ndata
        if self.batch_size != want:
            logger.warning(
                f"batch_size={want} rounded up to {self.batch_size} to divide evenly over "
                f"the mesh's {ndata}-way data axis (per-device activation memory is "
                "batch_size/ndata slices)"
            )
        self.per_device = self.batch_size // ndata
        self.n_classes = n_classes
        self.compute_dtype = compute_dtype
        self.device = self.devices[0]
        self.models = replicate_unet(self.mesh, params, compute_dtype)
        self._streams: dict = {}

    def _slabs(self, slices) -> List[torch.Tensor]:
        """The stack as one slab per data device: a list of slabs as given
        (``preprocess_sharded``'s), else split by ``mesh.shard_rows``."""
        if isinstance(slices, (list, tuple)):
            if len(slices) != len(self.devices):
                raise ValueError(f"{len(slices)} slabs for {len(self.devices)} data devices")
            return list(slices)
        return shard_rows(self.mesh, slices)

    def run(self, slices) -> List[torch.Tensor]:
        """(N, H, W) normalized slices (or their slabs) → the (N, H, W)
        uint8 class map as one slab per data device, each on its device."""
        slabs = self._slabs(slices)
        w = slabs[0].shape[2]
        outs = _forward_slabs(self.models, self.devices, slabs, self.per_device,
                              self.compute_dtype, 8)
        return [_cat(o, s, w, d) for o, s, d in zip(outs, slabs, self.devices)]

    def run_numpy(self, slices) -> np.ndarray:
        """:meth:`run` fetched to the host: each map bit-packed on its device
        (``engine.pack_bits_for``), the first half of the chunks downloading
        while the second half computes, unpacked on the host."""
        slabs = self._slabs(slices)
        n, w = sum(s.shape[0] for s in slabs), slabs[0].shape[2]
        bits = pack_bits_for(self.n_classes, w)
        n_chunks = max(-(-s.shape[0] // self.per_device) for s in slabs)
        half = -(-n_chunks // 2)
        starts = np.cumsum([0] + [s.shape[0] for s in slabs])
        pending = []  # (first row, host tensor, event)
        for chunks in (range(half), range(half, n_chunks)):
            outs = _forward_slabs(self.models, self.devices, slabs, self.per_device,
                                  self.compute_dtype, bits, chunks)
            for d, parts in enumerate(outs):
                row = starts[d] + chunks.start * self.per_device
                for part in parts:
                    pending.append((row, *_fetch(part, self._streams)))
                    row += part.shape[0]
        packed = np.empty((n, slabs[0].shape[1], w * bits // 8), dtype=np.uint8)
        for row, host, done in pending:
            if done is not None:
                done.synchronize()
            packed[row : row + host.shape[0]] = host.numpy()
        return unpack_bits_np(packed, bits)


# -- the sharded cleanup ------------------------------------------------------


def _union_roots(pairs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The ids of an (E, 2) int64 list of connected id pairs, sorted, and
    each one's smallest connected id (min-label propagation over the pairs
    with pointer jumping, to the fixpoint)."""
    if len(pairs) == 0:
        empty = np.zeros(0, np.int64)
        return empty, empty
    ids, inv = np.unique(pairs, return_inverse=True)
    inv = inv.reshape(pairs.shape)
    root = np.arange(len(ids))
    while True:
        low = np.minimum(root[inv[:, 0]], root[inv[:, 1]])
        new = root.copy()
        np.minimum.at(new, inv[:, 0], low)
        np.minimum.at(new, inv[:, 1], low)
        new = new[new]
        if np.array_equal(new, root):
            return ids, ids[root]
        root = new


def _lookup(ids: np.ndarray, roots: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Each of ``x`` mapped through ``ids → roots``; itself where not an id."""
    if len(ids) == 0:
        return x
    pos = np.searchsorted(ids, x).clip(max=len(ids) - 1)
    return np.where(ids[pos] == x, roots[pos], x)


def _host(tensors: Sequence[torch.Tensor], cols: int) -> np.ndarray:
    if not tensors:
        return np.zeros((0, cols), np.int64)
    return np.concatenate([t.cpu().numpy().reshape(-1, cols) for t in tensors])


def _boundary_pairs(a: torch.Tensor, b: torch.Tensor, same: Optional[Tuple] = None,
                    offsets=((0, 0),)) -> torch.Tensor:
    """Unique (id in ``a``, id in ``b``) pairs of two facing boundary planes
    (leading axes alike) that touch: for each ``offset`` (dy, dx), ``b`` at
    position i against ``a`` at i − offset, both non-zero and, given
    ``same`` = (values of ``a``'s plane, of ``b``'s), of one value."""
    pairs = []
    for off in offsets:
        dst, src = shift_slices(a.shape, off)
        ia, ib = a[src], b[dst]
        hit = (ia > 0) & (ib > 0)
        if same is not None:
            hit &= same[0][src] == same[1][dst]
        pairs.append(torch.stack([ia[hit], ib[hit]], dim=1))
    return torch.unique(torch.cat(pairs), dim=0)


def _postprocess_slabs(slabs: List[torch.Tensor], n_classes: int) -> List[torch.Tensor]:
    """``postprocess_device`` of the volume the slabs stack to (module
    docstring), each output slab on its input's device."""
    live = [i for i, s in enumerate(slabs) if s.shape[0]]
    if not live:
        return [s.clone() for s in slabs]
    h, w = slabs[live[0]].shape[1:]
    plane = h * w
    z0 = np.cumsum([0] + [s.shape[0] for s in slabs])
    depth = int(z0[-1])
    full = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

    # Largest 26-connected component of each class.
    gid, comps, pairs = {}, [], []
    for i in live:
        labels = cc.label(slabs[i], rank=3)
        gid[i] = torch.where(labels > 0, labels.long() + int(z0[i]) * plane, 0)
        areas = cc.areas_by_root(labels, rank=3)
        areas[0] = 0
        roots = torch.nonzero(areas).squeeze(1)
        comps.append(torch.stack([roots + int(z0[i]) * plane,
                                  slabs[i].reshape(-1)[roots - 1].long(),
                                  areas[roots].long(),
                                  torch.full_like(roots, i)], dim=1))
    for a, b in zip(live[:-1], live[1:]):
        dev = slabs[b].device
        pairs.append(_boundary_pairs(
            gid[a][-1].to(dev), gid[b][0],
            (slabs[a][-1].to(dev), slabs[b][0]), full))
    table = _host(comps, 4)  # (global id, class, area, slab) of every piece
    merged = _lookup(*_union_roots(_host(pairs, 2)), table[:, 0])
    uniq, inv = np.unique(merged, return_inverse=True)
    area = np.bincount(inv, weights=table[:, 2], minlength=len(uniq))
    cls = np.zeros(len(uniq), np.int64)
    cls[inv] = table[:, 1]
    keep_ids = {i: [] for i in live}  # per slab and class, the ids to keep
    for v in range(1, n_classes):
        of_v = cls == v
        best = None
        if of_v.any() and area[of_v].max() > 0:
            # The scan-order-LAST component wins an area tie (the largest id).
            best = uniq[of_v][area[of_v] == area[of_v].max()].max()
        for i in live:
            rows = (table[:, 3] == i) & (merged == (-1 if best is None else best))
            keep_ids[i].append(torch.from_numpy(table[rows, 0]).to(slabs[i].device))

    # Holes of each kept component: 6-connected background components that
    # reach the volume's border through no merged piece.
    keeps, keys, direct, pairs = {}, {}, [], []
    stride = depth * plane + 1  # one id range per class
    for i in live:
        keeps[i] = torch.stack([torch.isin(gid[i], ids) for ids in keep_ids[i]])
        labels = cc.label(~keeps[i], connectivity=1, rank=3)
        offset = torch.arange(n_classes - 1, device=labels.device).view(-1, 1, 1, 1) * stride
        keys[i] = torch.where(labels > 0, labels.long() + int(z0[i]) * plane + offset, 0)
        k = keys[i]
        border = [k[:, :, 0], k[:, :, -1], k[:, :, :, 0], k[:, :, :, -1]]
        if i == live[0]:
            border.append(k[:, 0])
        if i == live[-1]:
            border.append(k[:, -1])
        direct.append(torch.unique(torch.cat([t.reshape(-1) for t in border])))
    for a, b in zip(live[:-1], live[1:]):
        pairs.append(_boundary_pairs(keys[a][:, -1].to(slabs[b].device), keys[b][:, 0]))
    direct = _host(direct, 1)[:, 0]
    direct = direct[direct > 0]
    ids, roots = _union_roots(_host(pairs, 2))
    reached_roots = np.unique(_lookup(ids, roots, direct))
    reached = np.union1d(direct, ids[np.isin(roots, reached_roots)])
    out = [s.clone() for s in slabs]
    for i in live:
        holes = (keys[i] > 0) & ~torch.isin(keys[i], torch.from_numpy(reached).to(keys[i].device))
        filled = keeps[i] | holes
        res = torch.zeros_like(slabs[i])
        for c, v in enumerate(range(1, n_classes)):
            res = torch.where(filled[c], torch.tensor(v, dtype=res.dtype, device=res.device), res)
        out[i] = res
    return out


def make_sharded_postprocess(mesh: Mesh, n_classes: int):
    """``step(pred) → [cleaned uint8 slab, ...]``: the device cleanup of
    ``transforms/postprocess_device.postprocess_device`` (per-class largest
    3-D component + hole fill) on a class map that stays split over the
    data axis. ``pred`` is a list of slabs, one per data device in mesh
    order (:meth:`ShardedUNetRunner.run`'s), or an (N, H, W) map, split
    by ``mesh.shard_rows`` (any N: slabs may differ in depth, so JAX's pad
    to a multiple of the data axis is not needed). Bit-equal to the
    single-device function, ties included (module docstring)."""
    ndata = mesh.shape["data"]

    def step(pred):
        if not isinstance(pred, (list, tuple)):
            pred = shard_rows(mesh, pred)
        if len(pred) != ndata:
            raise ValueError(f"{len(pred)} slabs for {ndata} data devices")
        return _postprocess_slabs(list(pred), n_classes)

    return step
