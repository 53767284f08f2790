"""Batched U-Net execution (counterpart of ``lungmask_tpu.runtime.engine``).

The slice stack runs through the U-Net in chunks of ``batch_size`` slices
(the activation-memory bound, like the reference's batch size,
lungmask/mask.py:79,173); the last chunk is simply shorter. The JAX engine's
padding to bucketed chunk counts and its split dispatches exist only to bound
the number of compiled XLA programs, and PyTorch runs eagerly, so neither is
ported. Class maps are bit-packed on the device before the download (2 bits
per pixel for ≤4 classes, 4 for ≤16) with the JAX engine's bit order, and
unpacked on the host by the native core. The fused two-model mode runs both
U-Nets chunk by chunk over one stack (:func:`volume_argmax_pair_packed`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lungmask_tpu_torch.models import convert
from lungmask_tpu_torch.models.unet import UNet, unet_argmax

DEFAULT_CHUNK = 32

# Byte → unpacked-pixels lookup tables (the fallback when the native core is
# unavailable): pixel k of a byte sits at bit offset bits·k.
_NIBBLE_LUT = np.stack(
    [np.arange(256, dtype=np.uint8) & 0x0F, np.arange(256, dtype=np.uint8) >> 4],
    axis=-1,
)
_CRUMB_LUT = np.stack(
    [(np.arange(256, dtype=np.uint8) >> s) & 0x03 for s in (0, 2, 4, 6)], axis=-1
)


def volume_argmax(model: UNet, vol: torch.Tensor, chunk: int) -> torch.Tensor:
    """(M, H, W) normalized slices → (M, H, W) uint8 class map, ``chunk``
    slices per forward."""
    m = vol.shape[0]
    with torch.inference_mode():
        out = torch.empty(vol.shape, dtype=torch.uint8, device=vol.device)
        for s in range(0, m, chunk):
            out[s : s + chunk] = unet_argmax(model, vol[s : s + chunk].unsqueeze(-1))
    return out


def pack_bits(dense: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack a uint8 class map along the last axis: 2 bits (4 px/byte) or 4
    bits (2 px/byte), pixel k at bit offset bits·k; 8 = passthrough."""
    if bits == 8:
        return dense
    m, h, w = dense.shape
    per = 8 // bits
    groups = dense.reshape(m, h, w // per, per)
    out = groups[..., 0].clone()
    for i in range(1, per):
        out |= groups[..., i] << (bits * i)
    return out


def volume_argmax_packed2(model: UNet, vol: torch.Tensor, chunk: int) -> torch.Tensor:
    """:func:`volume_argmax` crumb-packed: four 2-bit pixels per byte →
    (M, H, W/4) uint8. Unpack with :func:`unpack_crumbs`."""
    return pack_bits(volume_argmax(model, vol, chunk), 2)


def pack_bits_for(n_classes: int, width: int) -> int:
    """Packing width for a class count: 2 bits/pixel (≤4 classes), 4 (≤16),
    or dense."""
    if width % 4 == 0 and n_classes <= 4:
        return 2
    if width % 2 == 0 and n_classes <= 16:
        return 4
    return 8


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


def unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    """(M, H, W/2) uint8 nibble pairs → (M, H, W) uint8 class map (host)."""
    from lungmask_tpu_torch.ops import native

    out = native.unpack_bits(packed, 4)
    if out is not None:
        return out
    return _NIBBLE_LUT[packed].reshape(packed.shape[:-1] + (packed.shape[-1] * 2,))


def unpack_crumbs(packed: np.ndarray) -> np.ndarray:
    """(M, H, W/4) uint8 2-bit quads → (M, H, W) uint8 class map (host)."""
    from lungmask_tpu_torch.ops import native

    out = native.unpack_bits(packed, 2)
    if out is not None:
        return out
    return _CRUMB_LUT[packed].reshape(packed.shape[:-1] + (packed.shape[-1] * 4,))


def unpack_bits_np(packed: np.ndarray, bits: int) -> np.ndarray:
    if bits == 8:
        return np.asarray(packed)
    return unpack_crumbs(packed) if bits == 2 else unpack_nibbles(packed)


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
