"""Sharded inference and cleanup over a device mesh (counterpart of
``lungmask_tpu.parallel.sharded``).

One process drives every device of the mesh. The slice stack is split over
the data axis into contiguous slabs (``mesh.split_rows``), one per data
row, and, with ``space > 1``, each slab's slice height into bands
(``mesh.split_bands``), block [d][s] on ``devices[d, s]``; it stays so:
the U-Net's class maps come out as blocks, and the device cleanup runs on
them in place.

* The U-Net (:class:`ShardedUNetRunner`): each data row holds the weights
  and runs its slab in sub-batches of ``batch_size / data`` slices, its
  bands in lockstep with halo rows (``parallel/halo.py``; one band is the
  unbanded forward); chunk k is the k-th sub-batch of every slab, and all
  of a chunk's sub-batches are issued before the next chunk's, with
  nothing waiting on a device. The JAX runner splits each chunk of
  ``batch_size`` consecutive slices over the data axis instead and lets XLA
  reshard the output into slabs; slices are independent, so the maps are
  the same. Unlike JAX, no slice padding: it only bounded the number of
  compiled programs.
* The cleanup (:func:`make_sharded_postprocess`): per-class largest 3-D
  component and hole fill, bit-equal to ``postprocess_device`` on the
  whole volume. Each block is labelled on its own device; a label, its
  block's local raster index + 1, becomes the volume's (the block's slice
  and row offsets added), which keeps the order: the smallest label of a
  piece is the smallest in the volume. The boundary planes (between slabs,
  between bands) and the edges that diagonal blocks share are exchanged
  between neighbouring blocks; the labels that touch across them are
  united on the host; a merged component's area is the sum of its
  pieces', its id the smallest of its pieces' ids (ids are the raster-first
  linear index + 1 in the whole volume, so the tie-break is the whole
  volume's); a background component is a hole only if none of its merged
  pieces touches the volume's border.
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
from lungmask_tpu_torch.ops.packing import pack_bits, pack_bits_for, unpack_bits_np
from lungmask_tpu_torch.parallel.halo import Bands
from lungmask_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    shard_bands,
    shard_batch,
    shard_blocks,
)
from lungmask_tpu_torch.runtime.engine import DEFAULT_CHUNK


def replicate_unet(mesh: Mesh, params, compute_dtype: torch.dtype = torch.float32) -> List[UNet]:
    """One inference U-Net per data device from a JAX-layout tree (the
    weights replicated); a device named twice holds one. The bands of a
    data row take that row's model, its weights copied to each band's
    device once (``Bands.on``, the runner's cache)."""
    held: Dict[torch.device, UNet] = {}
    for dev in mesh.data_devices:
        if dev not in held:
            held[dev] = UNet(convert.from_jax_params(params, dev), compute_dtype).eval()
    return [held[dev] for dev in mesh.data_devices]


def _argmax(model: UNet, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return torch.argmax(model.logits(x.unsqueeze(-1), compute_dtype), dim=-1).to(torch.uint8)


def _row_maps(model: UNet, bands: List[torch.Tensor], compute_dtype: torch.dtype, bits: int,
              cache: dict) -> List[torch.Tensor]:
    """The packed class maps of one data row's sub-batch, given as its
    bands (n, H_s, W): one map per band, each on its band's device. One
    band (``space == 1``) is the unbanded forward; several run in lockstep
    with halo rows (``parallel/halo.py``). A band left without rows by the
    U-Net's pooling (``split_bands``' empty or short last band) gets an
    empty map."""
    if len(bands) == 1:
        return [pack_bits(_argmax(model, bands[0], compute_dtype), bits)]
    out = model.logits(Bands([b.unsqueeze(-1) for b in bands], cache=cache), compute_dtype)
    width = out.parts[0].shape[2] * bits // 8
    maps = [torch.empty((b.shape[0], 0, width), dtype=torch.uint8, device=b.device) for b in bands]
    for i, logits in zip(out.index, out.parts):
        maps[i] = pack_bits(torch.argmax(logits, dim=-1).to(torch.uint8), bits)
    return maps


def _forward_blocks(models, grid, per: int, compute_dtype, bits: int, cache: dict,
                    chunks: Optional[range] = None) -> List[List[List[torch.Tensor]]]:
    """The packed class maps of each data row's sub-batches number
    ``chunks`` (all by default) of ``per`` slices: [row][band] → the list
    of its chunks' maps. Chunk k is issued on every data row before chunk
    k + 1."""
    n_chunks = max(-(-row[0].shape[0] // per) for row in grid)
    outs = [[[] for _ in row] for row in grid]
    with torch.inference_mode():
        for k in range(n_chunks) if chunks is None else chunks:
            for out, model, row in zip(outs, models, grid):
                bands = [b[k * per : (k + 1) * per] for b in row]
                if bands[0].shape[0]:
                    for parts, m in zip(out, _row_maps(model, bands, compute_dtype, bits, cache)):
                        parts.append(m)
    return outs


def _cat(parts: List[torch.Tensor], like: torch.Tensor, width: int) -> torch.Tensor:
    if parts:
        return torch.cat(parts)
    return torch.empty((0, like.shape[1], width), dtype=torch.uint8, device=like.device)


def _blocks(mesh: Mesh, x, depth: int) -> List[List[torch.Tensor]]:
    """A stack on the mesh as a grid of blocks: (N, H, W) split by
    ``mesh.shard_blocks``; a list with one entry per data device, each a
    slab (split into its row's bands) or the list of its bands."""
    if not isinstance(x, (list, tuple)):
        return shard_blocks(mesh, x, depth)
    ndata, space = mesh.shape["data"], mesh.shape["space"]
    if len(x) != ndata:
        raise ValueError(f"{len(x)} slabs for {ndata} data devices")
    grid = []
    for d, slab in enumerate(x):
        if isinstance(slab, (list, tuple)):
            if len(slab) != space:
                raise ValueError(f"{len(slab)} bands for {space} space devices")
            grid.append(list(slab))
        else:
            grid.append(shard_bands(mesh, d, slab, depth) if space > 1 else [slab])
    return grid


def _unwrap(mesh: Mesh, grid):
    """A grid as the mesh's callers see it: at ``space == 1`` the list of
    slabs, else the list of each data row's bands."""
    return [row[0] for row in grid] if mesh.shape["space"] == 1 else grid


def make_sharded_argmax(mesh: Mesh, compute_dtype: torch.dtype = torch.float32):
    """``step(models, batch (N, H, W, 1)) → [uint8 (N/d, H, W), ...]``: the
    batch split evenly over the data axis, part d through ``models[d]``
    (:func:`replicate_unet`) on its device; with ``space > 1``, each part
    split into bands over its row's space devices, and each data device's
    entry the list of its bands' maps."""
    cache: dict = {}

    def step(models, batch):
        grid = _blocks(mesh, [p[..., 0] for p in shard_batch(mesh, batch)], len(models[0].down))
        with torch.inference_mode():
            return _unwrap(mesh, [_row_maps(m, row, compute_dtype, 8, cache)
                                  for m, row in zip(models, grid)])

    return step


def make_sharded_volume_argmax(mesh: Mesh, compute_dtype: torch.dtype = torch.float32,
                               packed: bool = False, bits: int = 8):
    """``step(models, chunks (C, B, H, W)) → [uint8 slab, ...]``: the C·B
    slices split over the data axis into slabs (and, with ``space > 1``,
    each slab into its row's bands), each data row running its slab in
    sub-batches of B / data through ``models[d]``; each block's class map
    packed on its device (``bits`` 2 or 4 per pixel, 8 dense;
    ``packed=True`` is the JAX package's legacy spelling of ``bits=4``)."""
    if packed and bits == 8:
        bits = 4
    ndata = mesh.shape["data"]
    cache: dict = {}

    def step(models, chunks):
        c, b, h, w = chunks.shape
        if b % ndata:
            raise ValueError(f"a chunk of {b} does not split over {ndata} devices")
        grid = shard_blocks(mesh, chunks.reshape(c * b, h, w), len(models[0].down))
        outs = _forward_blocks(models, grid, b // ndata, compute_dtype, bits, cache)
        return _unwrap(mesh, [[_cat(o, x, w * bits // 8) for o, x in zip(out, row)]
                              for out, row in zip(outs, grid)])

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
        ``None`` gives each data row the engine's chunk
        (``DEFAULT_CHUNK``)."""
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
        self.depth = len(params["down"])
        self.models = replicate_unet(self.mesh, params, compute_dtype)
        self._streams: dict = {}
        self._copies: dict = {}  # the models' weights on the other space devices

    def _forward(self, grid, bits: int, chunks: Optional[range] = None):
        return _forward_blocks(self.models, grid, self.per_device, self.compute_dtype, bits,
                               self._copies, chunks)

    def run(self, slices):
        """(N, H, W) normalized slices (or their slabs, or the slabs'
        bands) → the (N, H, W) uint8 class map as one slab per data device
        at ``space == 1``, else as the list of each data device's bands,
        each block on its device."""
        grid = _blocks(self.mesh, slices, self.depth)
        outs = self._forward(grid, 8)
        return _unwrap(self.mesh, [[_cat(o, x, x.shape[2]) for o, x in zip(out, row)]
                                   for out, row in zip(outs, grid)])

    def run_numpy(self, slices) -> np.ndarray:
        """:meth:`run` fetched to the host: each block's map bit-packed on
        its device (``packing.pack_bits_for``), the first half of the chunks
        downloading while the second half computes, unpacked on the host."""
        grid = _blocks(self.mesh, slices, self.depth)
        w = grid[0][0].shape[2]
        w -= w % 2 ** (self.depth - 1)  # the U-Net's output width
        bits = pack_bits_for(self.n_classes, w)
        n_chunks = max(-(-row[0].shape[0] // self.per_device) for row in grid)
        half = -(-n_chunks // 2)
        starts = np.cumsum([0] + [row[0].shape[0] for row in grid])
        heights = [b.shape[1] for b in grid[0]]  # the map's bands; the U-Net may crop
        pending = []  # (first slice, band, host tensor, event)
        for chunks in (range(half), range(half, n_chunks)):
            for d, out in enumerate(self._forward(grid, bits, chunks)):
                for s, parts in enumerate(out):
                    row = starts[d] + chunks.start * self.per_device
                    for part in parts:
                        heights[s] = part.shape[1]
                        pending.append((row, s, *_fetch(part, self._streams)))
                        row += part.shape[0]
        y0 = np.cumsum([0] + heights)
        packed = np.empty((int(starts[-1]), int(y0[-1]), w * bits // 8), dtype=np.uint8)
        for row, s, host, done in pending:
            if done is not None:
                done.synchronize()
            packed[row : row + host.shape[0], y0[s] : y0[s + 1]] = host.numpy()
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


def _boundary_pairs(a: torch.Tensor, b: torch.Tensor, bound: int, same: Optional[Tuple] = None,
                    offsets=((0, 0),)) -> torch.Tensor:
    """Unique (id in ``a``, id in ``b``) pairs of two facing boundary planes
    (or edges; leading axes alike) that touch: for each ``offset`` over the
    last axes, ``b`` at position i against ``a`` at i − offset, both
    non-zero and, given ``same`` = (values of ``a``'s plane, of ``b``'s),
    of one value. Ids are below ``bound``; each pair is one int64 key while
    duplicates are removed (``unique`` of rows is far slower)."""
    if bound * bound >= 2**63:
        raise ValueError(f"ids up to {bound} do not pair in one int64 key")
    keys = []
    for off in offsets:
        dst, src = shift_slices(a.shape, off)
        ia, ib = a[src], b[dst]
        hit = (ia > 0) & (ib > 0)
        if same is not None:
            hit &= same[0][src] == same[1][dst]
        keys.append(ia[hit] * bound + ib[hit])
    keys = torch.unique(torch.cat(keys))
    return torch.stack([keys // bound, keys % bound], dim=1)


def _volume_ids(labels: torch.Tensor, z0: int, y0: int, h: int) -> torch.Tensor:
    """A block's labels (its local raster index + 1, 0 for none; the block
    is the last three axes, at slice ``z0`` and row ``y0`` of a volume of
    ``h`` rows) as the volume's raster index + 1, int64."""
    nz, ny, w = labels.shape[-3:]
    i = labels.long() - 1
    ids = ((z0 + i // (ny * w)) * h + y0 + (i // w) % ny) * w + i % w + 1
    return torch.where(labels > 0, ids, 0)


def _postprocess_blocks(grid: List[List[torch.Tensor]], n_classes: int) -> List[List[torch.Tensor]]:
    """``postprocess_device`` of the volume the blocks tile ([data row]
    [band]; module docstring), each output block on its input's device."""
    zs = [i for i, row in enumerate(grid) if row[0].shape[0]]
    ys = [j for j, b in enumerate(grid[0]) if b.shape[1]]
    out = [[b.clone() for b in row] for row in grid]
    if not zs or not ys:
        return out
    heights = [b.shape[1] for b in grid[0]]
    if any([b.shape[1] for b in row] != heights for row in grid):
        raise ValueError("the blocks' bands differ in height from one data row to the next")
    z0 = np.cumsum([0] + [row[0].shape[0] for row in grid])
    y0 = np.cumsum([0] + heights)
    depth, h, w = int(z0[-1]), int(y0[-1]), grid[zs[0]][ys[0]].shape[2]
    live = [(i, j) for i in zs for j in ys]
    number = {ij: k for k, ij in enumerate(live)}
    full = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))
    line = ((-1,), (0,), (1,))

    def neighbours():
        """(a, b, which faces): every pair of live blocks that touch."""
        for i, j in live:
            k = zs.index(i), ys.index(j)
            below = zs[k[0] + 1] if k[0] + 1 < len(zs) else None
            right = ys[k[1] + 1] if k[1] + 1 < len(ys) else None
            if below is not None:
                yield (i, j), (below, j), "z"
            if right is not None:
                yield (i, j), (i, right), "y"
            if below is not None and right is not None:
                yield (i, j), (below, right), "zy"
                yield (i, right), (below, j), "z-y"

    def faces(t, which):
        """The facing planes (or edges) of the blocks ``a`` and ``b`` of a
        pair, ``t`` their (C−1 leading axes allowed) tensors."""
        a, b = t
        return {"z": (a[..., -1, :, :], b[..., 0, :, :]),
                "y": (a[..., :, -1, :], b[..., :, 0, :]),
                "zy": (a[..., -1, -1, :], b[..., 0, 0, :]),
                "z-y": (a[..., -1, 0, :], b[..., 0, -1, :])}[which]

    # Largest 26-connected component of each class.
    gid, comps, pairs = {}, [], []
    for i, j in live:
        block = grid[i][j]
        labels = cc.label(block, rank=3)
        gid[i, j] = _volume_ids(labels, int(z0[i]), int(y0[j]), h)
        areas = cc.areas_by_root(labels, rank=3)
        areas[0] = 0
        roots = torch.nonzero(areas).squeeze(1)
        comps.append(torch.stack([gid[i, j].reshape(-1)[roots - 1],
                                  block.reshape(-1)[roots - 1].long(),
                                  areas[roots].long(),
                                  torch.full_like(roots, number[i, j])], dim=1))
    for a, b, which in neighbours():
        dev = grid[b[0]][b[1]].device
        ga, gb = faces((gid[a].to(dev), gid[b]), which)
        va, vb = faces((grid[a[0]][a[1]].to(dev), grid[b[0]][b[1]]), which)
        pairs.append(_boundary_pairs(ga, gb, depth * h * w + 1, (va, vb),
                                     line if which in ("zy", "z-y") else full))
    table = _host(comps, 4)  # (global id, class, area, block) of every piece
    merged = _lookup(*_union_roots(_host(pairs, 2)), table[:, 0])
    uniq, inv = np.unique(merged, return_inverse=True)
    area = np.bincount(inv, weights=table[:, 2], minlength=len(uniq))
    cls = np.zeros(len(uniq), np.int64)
    cls[inv] = table[:, 1]
    keep_ids = {ij: [] for ij in live}  # per block and class, the ids to keep
    for v in range(1, n_classes):
        of_v = cls == v
        best = None
        if of_v.any() and area[of_v].max() > 0:
            # The scan-order-LAST component wins an area tie (the largest id).
            best = uniq[of_v][area[of_v] == area[of_v].max()].max()
        for ij in live:
            rows = (table[:, 3] == number[ij]) & (merged == (-1 if best is None else best))
            keep_ids[ij].append(torch.from_numpy(table[rows, 0]).to(grid[ij[0]][ij[1]].device))

    # Holes of each kept component: 6-connected background components that
    # reach the volume's border through no merged piece.
    keeps, keys, direct, pairs = {}, {}, [], []
    stride = depth * h * w + 1  # one id range per class
    for i, j in live:
        keeps[i, j] = torch.stack([torch.isin(gid[i, j], ids) for ids in keep_ids[i, j]])
        labels = cc.label(~keeps[i, j], connectivity=1, rank=3)
        offset = torch.arange(n_classes - 1, device=labels.device).view(-1, 1, 1, 1) * stride
        k = _volume_ids(labels, int(z0[i]), int(y0[j]), h)
        keys[i, j] = k = torch.where(k > 0, k + offset, 0)
        border = [k[..., 0], k[..., -1]]
        if i == zs[0]:
            border.append(k[:, 0])
        if i == zs[-1]:
            border.append(k[:, -1])
        if j == ys[0]:
            border.append(k[:, :, 0])
        if j == ys[-1]:
            border.append(k[:, :, -1])
        direct.append(torch.unique(torch.cat([t.reshape(-1) for t in border])))
    for a, b, which in neighbours():
        if which in ("z", "y"):
            pairs.append(_boundary_pairs(*faces((keys[a].to(keys[b].device), keys[b]), which),
                                         (n_classes - 1) * stride))
    direct = _host(direct, 1)[:, 0]
    direct = direct[direct > 0]
    ids, roots = _union_roots(_host(pairs, 2))
    reached_roots = np.unique(_lookup(ids, roots, direct))
    reached = np.union1d(direct, ids[np.isin(roots, reached_roots)])
    for i, j in live:
        k = keys[i, j]
        holes = (k > 0) & ~torch.isin(k, torch.from_numpy(reached).to(k.device))
        filled = keeps[i, j] | holes
        res = torch.zeros_like(grid[i][j])
        for c, v in enumerate(range(1, n_classes)):
            res = torch.where(filled[c], torch.tensor(v, dtype=res.dtype, device=res.device), res)
        out[i][j] = res
    return out


def make_sharded_postprocess(mesh: Mesh, n_classes: int):
    """``step(pred) → cleaned blocks``: the device cleanup of
    ``transforms/postprocess_device.postprocess_device`` (per-class largest
    3-D component + hole fill) on a class map that stays split over the
    mesh. ``pred`` is :meth:`ShardedUNetRunner.run`'s blocks (at ``space
    == 1`` a list of slabs, one per data device in mesh order; else a list
    of each data device's bands) or an (N, H, W) map, split by
    ``mesh.shard_blocks`` (any N: slabs may differ in depth, so JAX's pad to
    a multiple of the data axis is not needed). The result comes back as
    ``pred``'s blocks came, a whole map as the runner's blocks. Bit-equal to
    the single-device function, ties included (module docstring)."""

    def step(pred):
        return _unwrap(mesh, _postprocess_blocks(_blocks(mesh, pred, 5), n_classes))

    return step
