"""The R231 U-Net forward in PyTorch (counterpart of ``lungmask_tpu.models.unet``).

Production configuration of the reference (lungmask/mask.py:58-65):
``in_channels=1, depth=5, wf=6, padding=True, batch_norm=True,
up_mode='upsample', residual=False``. BatchNorm is folded at conversion time
into a per-channel affine (``models/convert.py``).

* Interface: NHWC input ``(N, H, W, 1)`` and NHWC logits ``(N, H, W, K)``,
  the JAX package's layout; inside, NCHW tensors in ``channels_last`` memory.
* Conv block: conv3x3 → ReLU → affine, twice (the reference's BN sits after
  the ReLU). The conv runs in the compute dtype; bias, ReLU and affine run in
  float32 on its output, which is then cast once to the compute dtype. A
  bf16 torch conv rounds its output to bf16 before the bias, where JAX keeps
  the float32 accumulator — bf16 parity is by tolerance, never bit for bit.
* Down path: 2×2 average pooling (``F.avg_pool2d``) between levels.
* Up path: bilinear ×2 with half-pixel centres (``F.interpolate``,
  ``align_corners=False``), the 1×1 projection, the skip centre-cropped to
  the upsampled size, concat ``[up, skip]``, conv block.
* Head: the 1×1 classifier as a float32 matmul over channels (``_head``).

``float32`` runs with cuDNN's TF32 turned off for the call
(``torch.backends.cudnn.flags``), so f32 logits are full float32 on a GPU.
The ``residual`` and ``upconv`` variants are ROADMAP.md queue 1, item 8.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, Any]

IN_CHANNELS = 1
DEPTH = 5
WF = 6
BN_EPS = 1e-5  # torch.nn.BatchNorm2d default, folded at conversion time.


def encoder_channels(depth: int = DEPTH, wf: int = WF) -> List[int]:
    """Channel counts of the encoder levels: [64, 128, 256, 512, 1024]."""
    return [2 ** (wf + i) for i in range(depth)]


def _center_crop(skip: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The reference's UNetUpBlock.center_crop (resunet.py:136-142) on NCHW:
    a no-op at power-of-two sizes, load-bearing for odd input sizes."""
    sh, sw = skip.shape[2], skip.shape[3]
    if (sh, sw) == (h, w):
        return skip
    dy, dx = (sh - h) // 2, (sw - w) // 2
    return skip[:, :, dy : dy + h, dx : dx + w]


class ConvBlock(nn.Module):
    """conv3x3 → ReLU → affine, twice. Weights OIHW in the compute dtype;
    biases and affines float32."""

    def __init__(self, p: Params, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        for i in (1, 2):
            conv, bn = p[f"conv{i}"], p[f"bn{i}"]
            self.register_buffer(f"w{i}", conv["w"].to(compute_dtype))
            self.register_buffer(f"b{i}", conv["b"].float().view(1, -1, 1, 1))
            self.register_buffer(f"s{i}", bn["scale"].float().view(1, -1, 1, 1))
            self.register_buffer(f"t{i}", bn["bias"].float().view(1, -1, 1, 1))

    def _stage(self, x, w, b, s, t):
        y = F.conv2d(x, w, padding=1).float() + b
        return (torch.relu(y) * s + t).to(self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._stage(x, self.w1, self.b1, self.s1, self.t1)
        return self._stage(x, self.w2, self.b2, self.s2, self.t2)


class UpBlock(nn.Module):
    """Bilinear ×2 → 1×1 projection → centre-cropped skip concat → conv block."""

    def __init__(self, p: Params, compute_dtype: torch.dtype):
        super().__init__()
        if "upconv" in p or "res" in p:
            raise NotImplementedError(
                "the upconv and residual U-Net variants are not ported yet "
                "(ROADMAP.md queue 1, item 8)"
            )
        self.compute_dtype = compute_dtype
        self.register_buffer("wp", p["proj"]["w"].to(compute_dtype))
        self.register_buffer("bp", p["proj"]["b"].float().view(1, -1, 1, 1))
        self.conv_block = ConvBlock(p["conv_block"], compute_dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        up = (F.conv2d(up, self.wp).float() + self.bp).to(self.compute_dtype)
        skip = _center_crop(skip, up.shape[2], up.shape[3])
        x = torch.cat([up, skip], dim=1)
        return self.conv_block(x)


class UNet(nn.Module):
    """The production U-Net over a port parameter tree (see
    ``models/convert.from_jax_params``)."""

    def __init__(self, params: Params, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if any("res" in blk for blk in params["down"]):
            raise NotImplementedError(
                "the residual U-Net variant is not ported yet "
                "(ROADMAP.md queue 1, item 8)"
            )
        self.compute_dtype = compute_dtype
        self.down = nn.ModuleList(ConvBlock(p, compute_dtype) for p in params["down"])
        self.up = nn.ModuleList(UpBlock(p, compute_dtype) for p in params["up"])
        # Head (O, I, 1, 1) → (I, O) for the channel matmul; the weight is
        # stored in the compute dtype like every kernel, and multiplied in
        # float32 (exact for bf16 values), as the JAX head accumulates.
        w = params["last"]["w"]
        self.register_buffer("wl", w[:, :, 0, 0].t().to(compute_dtype).contiguous())
        self.register_buffer("bl", params["last"]["b"].float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 1) NHWC → (N, H, W, K) float32 logits."""
        flags = (
            torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
            if self.compute_dtype == torch.float32
            else torch.backends.cudnn.flags(enabled=True)
        )
        with flags:
            x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
            x = x.contiguous(memory_format=torch.channels_last)
            skips = []
            for i, block in enumerate(self.down):
                x = block(x)
                if i != len(self.down) - 1:
                    skips.append(x)
                    x = F.avg_pool2d(x, 2)
            for i, block in enumerate(self.up):
                x = block(x, skips[-i - 1])
            nhwc = x.permute(0, 2, 3, 1).float()
            return torch.matmul(nhwc, self.wl.float()) + self.bl


def unet_logits(model: UNet, x: torch.Tensor) -> torch.Tensor:
    """Raw classifier logits (pre log-softmax), NHWC float32."""
    return model(x)


def unet_argmax(model: UNet, x: torch.Tensor) -> torch.Tensor:
    """Per-pixel class (uint8); argmax ∘ log_softmax == argmax, so the
    reference head's normalization is skipped. Ties go to the first class."""
    return torch.argmax(model(x), dim=-1).to(torch.uint8)


def n_classes_of(params: Params) -> int:
    """Number of output classes: the length of the final conv bias, as in
    the reference (lungmask/mask.py:56)."""
    return int(params["last"]["b"].shape[0])
