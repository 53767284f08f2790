"""The R231 U-Net (lungmask ``resunet.UNet``: in_channels 1, depth 5, wf 6,
padding, batch norm after each ReLU, bilinear upsampling + 1×1 conv) in
plain float32 PyTorch, BatchNorm folded into a per-channel affine.

ReLU is ``max(y, 0)``, whose gradient splits at a tie (half to each
side), as the port's and the JAX package's training define it.

``quant`` (optional) rounds every conv's input and weight before the
float32 convolution: the lower-precision control
(:func:`fp8_e4m3`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled round trip through float8 e4m3 (the scale maps
    the largest magnitude to 448, the format's largest normal). The
    gradient passes the rounding unchanged, in float32."""
    with torch.no_grad():
        amax = t.abs().amax().clamp_min(1e-30)
        scale = 448.0 / amax
        rounded = (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (rounded - t).detach()


def tensors(flat: Dict[str, np.ndarray], device, requires_grad: bool = False
            ) -> Dict[str, torch.Tensor]:
    """Flat JAX-layout tree → float32 tensors, 4-D kernels HWIO → OIHW."""
    out = {}
    for k, v in flat.items():
        a = np.asarray(v, np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.tensor(np.ascontiguousarray(a), device=device,
                              requires_grad=requires_grad)
    return out


def _depth(p: Dict[str, torch.Tensor]) -> int:
    return sum(1 for k in p if k.startswith("down.") and k.endswith(".conv1.w"))


def logits(p: Dict[str, torch.Tensor], x: torch.Tensor, quant: Quant = None,
           head_input: bool = False):
    """(N, H, W) normalized slices → (N, K, H, W) float32 logits; with
    ``head_input`` also the head's input (N, C, H, W)."""
    q = quant or (lambda t: t)

    def conv(y, key):
        w = p[key + ".w"]
        return F.conv2d(q(y), q(w), p[key + ".b"], padding=w.shape[-1] // 2)

    def block(y, prefix):
        for i in (1, 2):
            y = torch.maximum(conv(y, f"{prefix}.conv{i}"), zero)
            y = y * p[f"{prefix}.bn{i}.scale"].view(1, -1, 1, 1) + p[f"{prefix}.bn{i}.bias"].view(
                1, -1, 1, 1)
        return y

    zero = x.new_zeros(())
    depth = _depth(p)
    y = x.unsqueeze(1)
    skips = []
    for i in range(depth):
        y = block(y, f"down.{i}")
        if i < depth - 1:
            skips.append(y)
            y = F.avg_pool2d(y, 2)
    for j in range(depth - 1):
        up = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=False)
        up = conv(up, f"up.{j}.proj")
        skip = skips[-j - 1]
        dy, dx = (skip.shape[2] - up.shape[2]) // 2, (skip.shape[3] - up.shape[3]) // 2
        skip = skip[:, :, dy:dy + up.shape[2], dx:dx + up.shape[3]]
        y = block(torch.cat([up, skip], 1), f"up.{j}.conv_block")
    out = conv(y, "last")
    return (out, y) if head_input else out


def scores(p: Dict[str, torch.Tensor], x: torch.Tensor, quant: Quant = None):
    """(N, H, W) normalized slices → the class scores (N, H, W, K) and, per
    class, the scale of the head's terms, √(Σ over pixels of Σ_c (w_kc·y_c)²
    + b_k²) over the head's input y: what a rounding error in a class's
    scores is measured against, since a sum rounds relative to its terms,
    not to itself, which may cancel."""
    out, y = logits(p, x, quant, head_input=True)
    w = p["last.w"][:, :, 0, 0]
    pixels = y.numel() // y.shape[1]
    sq = torch.einsum("kc,nchw->k", w * w, y * y) + p["last.b"] ** 2 * pixels
    return out.permute(0, 2, 3, 1), sq.sqrt()


def class_gap(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    """The largest over classes of ‖got − want‖ over the class's ``scale``
    (:func:`scores`) of two (…, K) score tensors. Class 0's scores come only
    from the U-Net's free channels, so a fault in any level shows there on
    its own scale."""
    d = (got.float() - want.float().to(got.device)).reshape(-1, want.shape[-1]).norm(dim=0)
    return float((d.cpu() / scale.float().cpu().clamp_min(1e-30)).max())


def argmax(p: Dict[str, torch.Tensor], slices: np.ndarray, device, block: int = 16,
           quant: Quant = None) -> np.ndarray:
    """(N, H, W) float64 normalized slices → (N, H, W) uint8 classes, in
    blocks of ``block`` slices; ties go to the first class."""
    out = np.empty(slices.shape, np.uint8)
    with torch.no_grad():
        for s in range(0, slices.shape[0], block):
            x = torch.as_tensor(slices[s:s + block], dtype=torch.float32, device=device)
            out[s:s + block] = logits(p, x, quant).argmax(1).to(torch.uint8).cpu().numpy()
    return out
