"""nnU-Net's 3-D full-resolution U-Net (``3d_fullres``), inference only.

The network of MIC-DKFZ/nnUNet v2 as its default planner lays it out for
CT (``dynamic_network_architectures`` ``PlainConvUNet``; Isensee et al.,
Nature Methods 18, 2021), with the parameter names of that class's
``state_dict`` and torch's layouts (conv kernels ``(cout, cin, k, k, k)``,
transposed convs ``(cin, cout, 2, 2, 2)``), so that a converted checkpoint
of the published code would load as it is:

* encoder stage ``s``: ``convs_per_stage`` × (3×3×3 conv with bias,
  padding 1 → InstanceNorm (affine, statistics per sample and channel) →
  LeakyReLU); the stage's first conv has the stage's stride (1 in stage 0,
  2 after), which does the downsampling;
* decoder level ``j`` (deepest first): a kernel-2 stride-2 transposed conv
  with bias to the level's features, the skip concatenated after it
  (``[up, skip]``), then the stage's conv blocks; a 1×1×1 head with bias on
  the last level (the tree holds every level's head, as nnU-Net trains
  with deep supervision; inference uses the last).

A model's plan travels with its weights: an ``.npz`` tree
(``convert.save_npz``) whose ``meta`` is ``{"architecture": "nnunet3d",
"plan": {...}}`` (``models/registry.model_plan`` reads it). The plan names the widths, the patch,
the target spacing, the CT normalisation, the window's step and Gaussian,
the resampling orders and the patches per forward.

The port's forward (:class:`UNet3D`) runs the convolutions through torch
(cuDNN, in ``compute_dtype``, ``channels_last_3d``; TF32 off in float32)
and each InstanceNorm + LeakyReLU as one hand-written kernel
(``ops/kernels/norm3d``, float32 statistics). The conv's bias is not added:
the InstanceNorm after every 3×3×3 conv subtracts each channel's mean,
which removes a per-channel constant exactly.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, np.ndarray]


def _enc(s: int, i: int) -> str:
    return f"encoder.stages.{s}.0.convs.{i}"


def _dec(j: int, i: int) -> str:
    return f"decoder.stages.{j}.convs.{i}"


def head_key(plan: dict) -> str:
    return f"decoder.seg_layers.{len(plan['features']) - 2}"


def leaf_shapes(plan: dict) -> List[Tuple[str, tuple]]:
    """(key, shape) of every parameter, in a fixed order."""
    feats, k = list(plan["features"]), int(plan["kernel"])
    n_enc, n_dec = int(plan["convs_per_stage"]), int(plan["decoder_convs_per_stage"])
    out: List[Tuple[str, tuple]] = []

    def block(prefix, cin, cout):
        out.extend([(f"{prefix}.conv.weight", (cout, cin, k, k, k)), (f"{prefix}.conv.bias", (cout,)),
                    (f"{prefix}.norm.weight", (cout,)), (f"{prefix}.norm.bias", (cout,))])

    cin = int(plan["in_channels"])
    for s, c in enumerate(feats):
        for i in range(n_enc):
            block(_enc(s, i), cin if i == 0 else c, c)
        cin = c
    for j in range(len(feats) - 1):
        deep, c = feats[-1 - j], feats[-2 - j]
        out.extend([(f"decoder.transpconvs.{j}.weight", (deep, c, 2, 2, 2)),
                    (f"decoder.transpconvs.{j}.bias", (c,))])
        for i in range(n_dec):
            block(_dec(j, i), 2 * c if i == 0 else c, c)
    for j in range(len(feats) - 1):  # a head on every level, as trained; the last one infers
        k_out = int(plan["n_classes"])
        out.extend([(f"decoder.seg_layers.{j}.weight", (k_out, feats[-2 - j], 1, 1, 1)),
                    (f"decoder.seg_layers.{j}.bias", (k_out,))])
    return out


def init_params(plan: dict, generator: torch.Generator) -> Params:
    """Seeded float32 weights: He-normal convs for LeakyReLU, zero conv
    biases, InstanceNorm scale 1 and shift 0, the transposed convs and the
    head at ``1/sqrt(fan_in)`` with zero biases (torch's layouts)."""
    out: Params = {}
    for key, shape in leaf_shapes(plan):
        if key.endswith("norm.weight"):
            out[key] = np.ones(shape, np.float32)
        elif len(shape) == 1:
            out[key] = np.zeros(shape, np.float32)
        else:
            fan_in = shape[0 if "transpconvs" in key else 1] * int(np.prod(shape[2:]))
            gain = 2.0 if ".conv." in key else 1.0
            t = torch.randn(shape, generator=generator, dtype=torch.float32)
            out[key] = (t * np.sqrt(gain / fan_in)).numpy()
    return out


class UNet3D:
    """The port's forward: ``(N, 1, D, H, W)`` normalised patches →
    ``(N, K, D, H, W)`` logits in ``compute_dtype`` (``channels_last_3d``
    memory). Weights are held on ``device``: conv kernels in
    ``compute_dtype`` and ``channels_last_3d``, norm affines and biases in
    float32 (the transposed convs' and the head's biases in
    ``compute_dtype``, as cuDNN adds them)."""

    def __init__(self, params: Params, plan: dict, device, compute_dtype=torch.bfloat16):
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.features = [int(c) for c in plan["features"]]
        self.strides = [int(s) for s in plan["strides"]]
        self.n_enc = int(plan["convs_per_stage"])
        self.n_dec = int(plan["decoder_convs_per_stage"])
        self.eps = float(plan["norm_eps"])
        self.slope = float(plan["leaky_slope"])
        self.n_classes = int(plan["n_classes"])
        self.head = head_key(plan)
        missing = [k for k, _ in leaf_shapes(plan) if k not in params]
        if missing:
            raise KeyError(f"the 3-D U-Net's weights lack {missing[:3]} ({len(missing)} in all)")
        self.p: Dict[str, torch.Tensor] = {}
        for key, shape in leaf_shapes(plan):
            a = torch.as_tensor(np.asarray(params[key], np.float32)).reshape(shape)
            if len(shape) == 5:
                a = a.to(self.device, compute_dtype).contiguous(
                    memory_format=torch.channels_last_3d)
            elif key.endswith("norm.weight") or key.endswith("norm.bias"):
                a = a.to(self.device, torch.float32)
            else:
                a = a.to(self.device, compute_dtype)
            self.p[key] = a

    def _flags(self):
        """cuDNN with TF32 off: a float32 forward stays float32."""
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)

    def conv_norm(self, x: torch.Tensor, prefix: str, stride: int) -> torch.Tensor:
        """3×3×3 conv (its bias dropped, see the module's note) → the fused
        InstanceNorm + LeakyReLU kernel, in place on the conv's output."""
        from lungmask_tpu_torch.ops.kernels import norm3d

        w = self.p[prefix + ".conv.weight"]
        y = F.conv3d(x, w, None, stride=stride, padding=w.shape[-1] // 2)
        # a one-channel input is laid out both ways, and cuDNN may then
        # answer in NCDHW; the kernel and the next conv take NDHWC
        y = y.contiguous(memory_format=torch.channels_last_3d)
        return norm3d.instance_norm_leaky(y, self.p[prefix + ".norm.weight"],
                                          self.p[prefix + ".norm.bias"], self.eps, self.slope,
                                          out=y)

    def encoder_stage(self, s: int, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_enc):
            x = self.conv_norm(x, _enc(s, i), self.strides[s] if i == 0 else 1)
        return x

    def decoder_stage(self, j: int, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = F.conv_transpose3d(x, self.p[f"decoder.transpconvs.{j}.weight"],
                                self.p[f"decoder.transpconvs.{j}.bias"], stride=2)
        x = torch.cat([up, skip], 1)
        for i in range(self.n_dec):
            x = self.conv_norm(x, _dec(j, i), 1)
        return x

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), self._flags():
            x = x.to(self.device, self.compute_dtype).contiguous(
                memory_format=torch.channels_last_3d)
            skips = []
            for s in range(len(self.features)):
                x = self.encoder_stage(s, x)
                skips.append(x)
            x = skips.pop()
            for j in range(len(self.features) - 1):
                x = self.decoder_stage(j, x, skips.pop())
            return F.conv3d(x, self.p[self.head + ".weight"], self.p[self.head + ".bias"])

