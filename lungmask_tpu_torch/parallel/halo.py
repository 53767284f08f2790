"""Height bands with halo rows: the mesh's ``space`` axis inside the U-Net.

The JAX package has no counterpart module: it marks the slice height as
split over ``space`` (``P("data", "space")``) and XLA's partitioner
inserts the exchanges a convolution needs. Here they are written out.

A :class:`Bands` is one data row's activation split by height: one tensor
per band, each on its band's device, that stacked along the row axis give
the whole tensor. ``models/unet.py`` runs its one forward definition on a
tensor or on a ``Bands``, layer by layer, all bands in lockstep. Every
operation is local to a band (:meth:`Bands.map`) except three:

* a 3×3 convolution — each band takes the last row of the band above and
  the first row of the band below in place of its zero padding (zero rows
  at the image's top and bottom) and is convolved without vertical padding
  (:meth:`Bands.halo` with ``zeros=True``);
* the bilinear ×2 upsampling (K3) — each band takes one row of each
  neighbour (none at the image's top and bottom, where the kernel clamps
  as on the whole image); the 2 output rows of each padded side, the only
  rows the clamp of the padded band touches, are cropped
  (:meth:`Bands.halo` with ``crop=2``);
* the skip's centre crop to the upsampled size — the skip's rows split
  again as the upsampled bands' rows (:meth:`Bands.regrid`), which is each
  band's own slice when the input height is a multiple of
  ``2 ** (depth - 1)``.

A halo row is a slice copied to the neighbour's device with ``.to``: on
one card a device-to-device copy, on one device none. Autograd carries its
gradient back to the band that owns it. A band's weights are the model's,
copied to the band's device (:meth:`Bands.on`). Bands without rows take no
part: they are dropped, and :attr:`Bands.index` keeps each remaining band's
place on the mesh's space axis.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


class Bands:
    """One data row's tensor split by height (module docstring).

    ``parts`` are the bands in order, ``dim`` their row axis (1 for NHWC, 2
    for NCHW), ``index`` each band's place on the space axis. ``cache``,
    when given, keeps the copies :meth:`on` makes of tensors that need no
    gradient (an inference model's weights), keyed by the original's
    ``id`` and the device: its owner keeps those originals alive."""

    def __init__(self, parts: Sequence[torch.Tensor], dim: int = 1,
                 index: Optional[Sequence[int]] = None,
                 cache: Optional[Dict[Tuple[int, torch.device], torch.Tensor]] = None):
        index = range(len(parts)) if index is None else index
        live = [(i, p) for i, p in zip(index, parts) if p.shape[dim]]
        if not live:
            raise ValueError("no band holds a row")
        self.index: List[int] = [i for i, _ in live]
        self.parts: List[torch.Tensor] = [p for _, p in live]
        self.dim = dim
        self.cache = cache

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def rows(self) -> List[int]:
        return [p.shape[self.dim] for p in self.parts]

    def _like(self, parts, dim=None, index=None) -> "Bands":
        return Bands(parts, self.dim if dim is None else dim,
                     self.index if index is None else index, self.cache)

    def on(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        """``t`` on ``device``: itself where it lies there; else a copy,
        kept in the cache unless ``t`` needs a gradient (a trainable
        weight's copy is made at each call, so that its gradient flows
        back to ``t``)."""
        if t.device == device:
            return t
        if self.cache is None or t.requires_grad:
            return t.to(device)
        key = (id(t), device)
        if key not in self.cache:
            self.cache[key] = t.to(device)
        return self.cache[key]

    def _args(self, i: int, args) -> list:
        """The arguments for band ``i``: a ``Bands`` gives its own band i
        (its rows must match), a tensor its copy on the band's device,
        anything else itself."""
        dev = self.parts[i].device
        out = []
        for a in args:
            if isinstance(a, Bands):
                if a.rows != self.rows or a.index != self.index:
                    raise ValueError(f"bands of {a.rows} rows against bands of {self.rows}")
                a = a.parts[i]
            elif isinstance(a, torch.Tensor):
                a = self.on(a, dev)
            out.append(a)
        return out

    def map(self, fn: Callable, *args, dim: Optional[int] = None) -> "Bands":
        """``fn(band, *args)`` on each band (arguments as :meth:`_args`
        gives them); ``dim`` is the result's row axis when it moved."""
        return self._like([fn(p, *self._args(i, args)) for i, p in enumerate(self.parts)], dim)

    def halo(self, fn: Callable, *args, rows: int = 1, zeros: bool, crop: int = 0) -> "Bands":
        """``fn(padded band, *args)`` on each band padded with ``rows`` rows
        of each neighbour (the facing edge rows, copied to the band's
        device); at the image's top and bottom, with as many zero rows when
        ``zeros``, else nothing. ``crop`` rows of ``fn``'s output are cut
        off at each side padded with a neighbour's rows."""
        d, n = self.dim, len(self.parts)
        out = []
        for i, p in enumerate(self.parts):
            top = self.parts[i - 1].narrow(d, -rows, rows) if i else None
            bottom = self.parts[i + 1].narrow(d, 0, rows) if i + 1 < n else None
            if zeros:
                top = torch.zeros_like(p.narrow(d, 0, rows)) if top is None else top
                bottom = torch.zeros_like(p.narrow(d, 0, rows)) if bottom is None else bottom
            pieces = [t.to(p.device) for t in (top, p, bottom) if t is not None]
            y = fn(torch.cat(pieces, d), *self._args(i, args))
            if crop:
                lo = crop if i else 0
                hi = y.shape[d] - (crop if i + 1 < n else 0)
                y = y.narrow(d, lo, hi - lo)
            out.append(y)
        return self._like(out)

    def regrid(self, start: int, like: "Bands") -> "Bands":
        """Rows ``[start, start + sum(like.rows))`` of the stacked tensor,
        split as ``like``'s bands and each band on ``like``'s band's
        device: a band's own slice where it holds those rows, else the
        pieces of its neighbours, copied over and joined."""
        d = self.dim
        bounds = [0]
        for r in self.rows:
            bounds.append(bounds[-1] + r)
        out, lo = [], start
        for target in like.parts:
            hi = lo + target.shape[like.dim]
            pieces = []
            for p, a, b in zip(self.parts, bounds[:-1], bounds[1:]):
                if a < hi and lo < b:
                    first = max(lo, a)
                    pieces.append(p.narrow(d, first - a, min(hi, b) - first).to(target.device))
            if sum(t.shape[d] for t in pieces) != hi - lo:
                raise ValueError(f"rows {lo}:{hi} lie outside bands of {self.rows} rows")
            out.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces, d))
            lo = hi
        return self._like(out, index=like.index)
