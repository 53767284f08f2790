"""Batched U-Net execution (counterpart of ``lungmask_tpu.runtime.engine``).

The slice stack runs through the U-Net in chunks of ``batch_size`` slices
(the activation-memory bound, like the reference's batch size,
lungmask/mask.py:79,173); the last chunk is simply shorter. The JAX engine's
padding to bucketed chunk counts and its split dispatches exist only to bound
the number of compiled XLA programs, and PyTorch runs eagerly, so neither is
ported. Class maps are bit-packed on the device before the download and
unpacked on the host (``ops/packing.py``, the JAX engine's bit order). The
fused two-model mode runs both U-Nets chunk by chunk over one stack
(:func:`volume_argmax_pair_packed`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lungmask_tpu_torch.models import convert
from lungmask_tpu_torch.models.unet import UNet, unet_argmax
from lungmask_tpu_torch.ops.packing import (  # noqa: F401  (the JAX engine's names)
    pack_bits,
    pack_bits_for,
    unpack_bits_np,
    unpack_crumbs,
    unpack_nibbles,
)

DEFAULT_CHUNK = 32


def volume_argmax(model: UNet, vol: torch.Tensor, chunk: int) -> torch.Tensor:
    """(M, H, W) normalized slices → (M, H, W) uint8 class map, ``chunk``
    slices per forward."""
    m = vol.shape[0]
    with torch.inference_mode():
        out = torch.empty(vol.shape, dtype=torch.uint8, device=vol.device)
        for s in range(0, m, chunk):
            out[s : s + chunk] = unet_argmax(model, vol[s : s + chunk].unsqueeze(-1))
    return out


def volume_argmax_packed2(model: UNet, vol: torch.Tensor, chunk: int) -> torch.Tensor:
    """:func:`volume_argmax` crumb-packed: four 2-bit pixels per byte →
    (M, H, W/4) uint8. Unpack with :func:`unpack_crumbs`."""
    return pack_bits(volume_argmax(model, vol, chunk), 2)


def volume_argmax_pair_packed(
    model_a: UNet, model_b: UNet, vol: torch.Tensor, chunk: int, bits_a: int, bits_b: int
):
    """Both U-Nets over the same (M, H, W) stack (``engine.volume_argmax_pair_packed``
    of the JAX package): model A's chunk, then model B's, so peak activation
    memory stays that of one model. Each class map is packed by its own
    width (:func:`pack_bits_for`) → (M, H, W·bits_a/8), (M, H, W·bits_b/8)
    uint8 on the stack's device."""
    m, h, w = vol.shape
    with torch.inference_mode():
        out_a = torch.empty((m, h, w * bits_a // 8), dtype=torch.uint8, device=vol.device)
        out_b = torch.empty((m, h, w * bits_b // 8), dtype=torch.uint8, device=vol.device)
        for s in range(0, m, chunk):
            x = vol[s : s + chunk].unsqueeze(-1)
            out_a[s : s + chunk] = pack_bits(unet_argmax(model_a, x), bits_a)
            out_b[s : s + chunk] = pack_bits(unet_argmax(model_b, x), bits_b)
    return out_a, out_b


class UNetRunner:
    """Holds the U-Net on its device and runs slice stacks through it."""

    def __init__(
        self,
        params,
        n_classes: int,
        batch_size: Optional[int] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        device="cpu",
    ):
        """``params`` is a JAX-layout numpy tree (``registry.get_model``).
        Conv kernels are stored pre-cast to ``compute_dtype`` (the JAX
        engine's ``_cast_kernels``); biases and affines stay float32.
        ``batch_size=None`` picks :data:`DEFAULT_CHUNK`."""
        # The class-map copies and unpacks allocate tens of MB of host
        # memory per call; keep those pages on the heap across calls.
        from lungmask_tpu_torch.runtime import tune_host_allocator

        tune_host_allocator()
        self.device = torch.device(device)
        self.model = UNet(convert.from_jax_params(params, self.device), compute_dtype)
        self.model.eval()
        self.n_classes = n_classes
        self.batch_size = DEFAULT_CHUNK if batch_size is None else int(batch_size)
        self.compute_dtype = compute_dtype

    def run(self, slices: torch.Tensor) -> torch.Tensor:
        """(N, H, W) normalized slices → (N, H, W) uint8 class map on the
        runner's device."""
        return volume_argmax(self.model, slices.to(self.device), self.batch_size)

    def run_numpy(self, slices: torch.Tensor) -> np.ndarray:
        """Like :func:`run`, fetched to the host: the map is bit-packed on
        the device by :func:`pack_bits_for`, downloaded, and unpacked."""
        bits = pack_bits_for(self.n_classes, slices.shape[2])
        packed = pack_bits(self.run(slices), bits).cpu().numpy()
        return unpack_bits_np(packed, bits)


def run_pair(a: UNetRunner, b: UNetRunner, slices: torch.Tensor):
    """Both runners over one stack (:func:`volume_argmax_pair_packed`, at
    ``a``'s batch size) → two dense (N, H, W) uint8 class maps left on
    ``a``'s device, for device-mode postprocessing."""
    return volume_argmax_pair_packed(
        a.model, b.model, slices.to(a.device), a.batch_size, 8, 8
    )


def run_pair_numpy(a: UNetRunner, b: UNetRunner, slices: torch.Tensor):
    """Both runners over one stack (:func:`volume_argmax_pair_packed`, at
    ``a``'s batch size on ``a``'s device) → two (N, H, W) uint8 host class
    maps, each downloaded bit-packed and unpacked on the host."""
    width = slices.shape[2]
    bits_a, bits_b = pack_bits_for(a.n_classes, width), pack_bits_for(b.n_classes, width)
    pa, pb = volume_argmax_pair_packed(
        a.model, b.model, slices.to(a.device), a.batch_size, bits_a, bits_b
    )
    return unpack_bits_np(pa.cpu().numpy(), bits_a), unpack_bits_np(pb.cpu().numpy(), bits_b)
