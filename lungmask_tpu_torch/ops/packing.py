"""The class-map download format: a uint8 class map is packed along its last
axis on the device (2 bits a pixel for ≤ 4 classes, 4 for ≤ 16, else one
byte), pixel k of a byte at bit offset bits·k (the JAX engine's order), and
unpacked on the host by the native core. The U-Net engine, the mesh's
runners, device postprocessing and the 3-D export all download in it.
"""

from __future__ import annotations

import numpy as np
import torch

# Byte → unpacked-pixels lookup tables (the fallback when the native core is
# unavailable): pixel k of a byte sits at bit offset bits·k.
_NIBBLE_LUT = np.stack(
    [np.arange(256, dtype=np.uint8) & 0x0F, np.arange(256, dtype=np.uint8) >> 4],
    axis=-1,
)
_CRUMB_LUT = np.stack(
    [(np.arange(256, dtype=np.uint8) >> s) & 0x03 for s in (0, 2, 4, 6)], axis=-1
)


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


def pack_bits_for(n_classes: int, width: int) -> int:
    """Packing width for a class count: 2 bits/pixel (≤4 classes), 4 (≤16),
    or dense."""
    if width % 4 == 0 and n_classes <= 4:
        return 2
    if width % 2 == 0 and n_classes <= 16:
        return 4
    return 8


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
