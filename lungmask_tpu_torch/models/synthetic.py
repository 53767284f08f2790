"""Hand-crafted U-Net parameters that segment by HU intensity bands, and the
lung phantom they are made for (counterpart of
``lungmask_tpu.models.synthetic``, built in numpy alone).

The parameters are a real JAX-layout tree with the production architecture
and FLOP count whose forward pass is a piecewise-linear function of the
normalized input v: every conv carries v through channel 0 (centre-tap
identity kernels), the level-0 block adds hinge channels ReLU(v − θ), the
decoder's 1×1 projections are zero so only the full-resolution skip
survives, and the classifier head combines {v, hinges} into band logits.
See the JAX module for the construction; the arrays here are equal to its
arrays (tests/test_torch_synthetic.py).
"""

from __future__ import annotations

import numpy as np

from lungmask_tpu_torch.models.unet import DEPTH, IN_CHANNELS, WF, encoder_channels


def _norm(hu: float) -> float:
    """Normalized intensity of an HU value after the window/scale."""
    return (min(hu, 600.0) + 1024.0) / 1624.0


def zero_params(
    n_classes: int, in_channels: int = IN_CHANNELS, depth: int = DEPTH, wf: int = WF
):
    """All-zero float32 tree with the shapes of ``unet.init_params``."""
    chans = encoder_channels(depth, wf)

    def conv(kh, kw, cin, cout):
        return {
            "w": np.zeros((kh, kw, cin, cout), np.float32),
            "b": np.zeros((cout,), np.float32),
        }

    def affine(cout):
        return {"scale": np.zeros((cout,), np.float32), "bias": np.zeros((cout,), np.float32)}

    def block(cin, cout):
        return {
            "conv1": conv(3, 3, cin, cout),
            "bn1": affine(cout),
            "conv2": conv(3, 3, cout, cout),
            "bn2": affine(cout),
        }

    down, prev = [], in_channels
    for c in chans:
        down.append(block(prev, c))
        prev = c
    up = []
    for i in reversed(range(depth - 1)):
        up.append({"proj": conv(1, 1, prev, chans[i]), "conv_block": block(2 * chans[i], chans[i])})
        prev = chans[i]
    return {"down": down, "up": up, "last": conv(1, 1, prev, n_classes)}


def _scaffold(n_classes: int, wf: int, hinges: dict):
    """Zero tree that carries v in channel 0 through every level and adds
    hinge channels h_θ := ReLU(v − θ) on the level-0 skip (``hinges`` maps a
    skip channel ≥ 1 to θ). Classes ≥ 3 are suppressed; the head is left for
    the caller."""
    params = zero_params(n_classes, wf=wf)

    def ident(w, cin=0, cout=0):
        w[w.shape[0] // 2, w.shape[1] // 2, cin, cout] = 1.0

    carried = 1 + len(hinges)
    for i, block in enumerate(params["down"]):
        ident(block["conv1"]["w"])
        ident(block["conv2"]["w"])
        for bn in ("bn1", "bn2"):
            block[bn]["scale"][:] = 1.0
        if i == 0:
            for c, theta in hinges.items():
                ident(block["conv2"]["w"], cin=0, cout=c)
                block["conv2"]["b"][c] = -theta

    for up in params["up"]:
        cout = up["conv_block"]["conv2"]["w"].shape[2]
        for c in range(carried):
            ident(up["conv_block"]["conv1"]["w"], cin=cout + c, cout=c)
            ident(up["conv_block"]["conv2"]["w"], cin=c, cout=c)
        for bn in ("bn1", "bn2"):
            up["conv_block"][bn]["scale"][:] = 1.0

    params["last"]["b"][3:] = -100.0
    return params


def threshold_params(
    n_classes: int = 3,
    t1_hu: float = -650.0,
    t2_hu: float = -400.0,
    slope: float = 16.0,
    hinge_k: float = 32.0,
    wf: int = WF,
):
    """Band-threshold parameters: class 2 below t1, 1 in [t1, t2), 0 above."""
    assert n_classes >= 3
    t1, t2 = _norm(t1_hu), _norm(t2_hu)
    a, k = float(slope), float(hinge_k * slope)
    params = _scaffold(n_classes, wf, {1: t2})
    last_w, last_b = params["last"]["w"], params["last"]["b"]
    last_w[0, 0, 0, 0] = a
    last_b[0] = -a * t2
    last_w[0, 0, 0, 1] = a
    last_w[0, 0, 1, 1] = -k
    last_b[1] = -a * t1
    last_w[0, 0, 0, 2] = -a
    last_b[2] = a * t1
    return params


def laterality_params(
    n_classes: int = 3,
    t0_hu: float = -925.0,
    t1_hu: float = -650.0,
    t2_hu: float = -400.0,
    slope: float = 16.0,
    hinge_k: float = 32.0,
    wf: int = WF,
):
    """Parameters whose masks look like R231's laterality output on
    :func:`lung_phantom`: class 0 below t0 (outside air) and above t2 (soft
    tissue), class 2 in [t0, t1) (the left lung), class 1 in [t1, t2) (the
    right lung)."""
    assert n_classes >= 3
    t0, t1, t2 = _norm(t0_hu), _norm(t1_hu), _norm(t2_hu)
    a, k = float(slope), float(hinge_k * slope)
    params = _scaffold(n_classes, wf, {1: t1, 2: t2})
    last_w, last_b = params["last"]["w"], params["last"]["b"]
    last_w[0, 0, 0, 1] = a
    last_w[0, 0, 2, 1] = -k
    last_b[1] = -a * t1
    last_w[0, 0, 0, 2] = a
    last_w[0, 0, 1, 2] = -k
    last_b[2] = -a * t0
    return params


def reference_state_dict(
    n_classes: int,
    *,
    depth: int = DEPTH,
    wf: int = WF,
    residual: bool = False,
    up_mode: str = "upsample",
    seed: int = 0,
):
    """A random state dict in the reference U-Net's layout (lungmask
    resunet.py, batch_norm=True), as a ``.pth`` of that configuration holds
    it: float32 numpy arrays, keyed as ``models/convert.detect_config`` and
    ``convert_state_dict`` read them, ``last.bias`` last. Every block carries
    its ``residual_input_conv`` / ``residual_batchnorm`` (dead unless
    ``residual``). Drawn from ``numpy.random.default_rng(seed)``: conv
    weights and biases U(±1/√fan_in) as torch's default init, BatchNorm
    weights U(0.5, 1.5), biases U(−0.2, 0.2), running means N(0, 0.2),
    running variances U(0.5, 2); the head is widened (×64, zero bias) so
    that the class varies from pixel to pixel."""
    if up_mode not in ("upsample", "upconv"):
        raise ValueError(f"unknown up_mode {up_mode!r}")
    rng = np.random.default_rng(seed)
    chans = encoder_channels(depth, wf)
    sd = {}

    def conv(name, cin, cout, k, transposed=False):
        bound = 1.0 / np.sqrt(cin * k * k if not transposed else cout * k * k)
        shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        sd[name + ".weight"] = rng.uniform(-bound, bound, shape).astype(np.float32)
        sd[name + ".bias"] = rng.uniform(-bound, bound, (cout,)).astype(np.float32)

    def bn(name, c):
        sd[name + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[name + ".bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
        sd[name + ".running_mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        sd[name + ".running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        sd[name + ".num_batches_tracked"] = np.zeros((), np.int64)

    def block(prefix, cin, cout, res_layout, first):
        if not res_layout:  # [Conv, ReLU, BN, Conv, ReLU, BN]
            conv(prefix + ".block.0", cin, cout, 3)
            bn(prefix + ".block.2", cout)
            conv(prefix + ".block.3", cout, cout, 3)
            bn(prefix + ".block.5", cout)
        elif first:  # [Conv, ReLU, BN, Conv]
            conv(prefix + ".block.0", cin, cout, 3)
            bn(prefix + ".block.2", cout)
            conv(prefix + ".block.3", cout, cout, 3)
        else:  # [ReLU, BN, Conv, ReLU, BN, Conv]
            bn(prefix + ".block.1", cin)
            conv(prefix + ".block.2", cin, cout, 3)
            bn(prefix + ".block.4", cout)
            conv(prefix + ".block.5", cout, cout, 3)

    def res_path(prefix, cin, cout):
        conv(prefix + ".residual_input_conv", cin, cout, 1)
        bn(prefix + ".residual_batchnorm", cout)

    prev = IN_CHANNELS
    for i, c in enumerate(chans):
        block(f"down_path.{i}", prev, c, residual, first=(i == 0))
        res_path(f"down_path.{i}", prev, c)
        prev = c
    for j, i in enumerate(reversed(range(depth - 1))):
        c = chans[i]
        if up_mode == "upconv":
            conv(f"up_path.{j}.up", prev, c, 2, transposed=True)
        else:
            conv(f"up_path.{j}.up.1", prev, c, 1)
        block(f"up_path.{j}.conv_block", prev, c, False, first=False)
        res_path(f"up_path.{j}", prev, c)
        prev = c
    conv("last", prev, n_classes, 1)
    sd["last.weight"] *= 64.0
    sd["last.bias"][:] = 0.0
    return sd


def lung_phantom(n_slices: int, size: int = 512) -> np.ndarray:
    """Lung-like int16 CT phantom (N, size, size), seeded (a copy of the
    benchmark phantom, ``bench._synthetic_volume``, which is ``size=512``).

    Outside air −1000 HU, body 40 HU, left lung −850 HU (class 2 under
    :func:`laterality_params`), right lung −550 HU (class 1), vessels drifting
    through the lungs and satellite pockets in the body, ±30 HU noise."""
    h = w = size
    rng = np.random.default_rng(0)
    vol = np.full((n_slices, h, w), -1000, dtype=np.int16)
    yy, xx = np.mgrid[0:h, 0:w]
    body = ((yy - h / 2) / (h * 0.40)) ** 2 + ((xx - w / 2) / (w * 0.35)) ** 2 < 1
    lung_l = ((yy - h / 2) / (h * 0.2)) ** 2 + ((xx - w * 0.35) / (w * 0.12)) ** 2 < 1
    lung_r = ((yy - h / 2) / (h * 0.2)) ** 2 + ((xx - w * 0.65) / (w * 0.12)) ** 2 < 1
    vessels = []  # (lung mask, y, x, radius, drift-phase)
    for lung, cx in ((lung_l, 0.35), (lung_r, 0.65)):
        for _ in range(6):
            vessels.append(
                (
                    lung,
                    float(rng.integers(h * 0.42, h * 0.58)),
                    float(rng.integers(w * (cx - 0.06), w * (cx + 0.06))),
                    int(rng.integers(2, 6)),
                    float(rng.uniform(0, 2 * np.pi)),
                )
            )
    pockets = []  # (z0, z1, y, x, radius, HU)
    for j in range(4):
        z0 = int(rng.integers(0, max(1, n_slices - 4)))
        pockets.append(
            (
                z0,
                min(n_slices, z0 + int(rng.integers(4, 20))),
                int(rng.integers(h * 0.25, h * 0.75)),
                int(rng.integers(w * 0.2, w * 0.8)),
                int(rng.integers(2, 5)),
                -550 if j % 2 else -850,
            )
        )
    for i in range(n_slices):
        sl = vol[i]
        sl[body] = 40
        sl[lung_l] = -850
        sl[lung_r] = -550
        for lung, vy, vx, r, phase in vessels:
            cy_ = vy + 6 * np.sin(phase + i / 17.0)
            cx_ = vx + 6 * np.cos(phase + i / 23.0)
            disk = (yy - cy_) ** 2 + (xx - cx_) ** 2 < r * r
            sl[disk & lung] = 40
        for z0, z1, py, px, r, hu in pockets:
            if z0 <= i < z1:
                disk = (yy - py) ** 2 + (xx - px) ** 2 < r * r
                sl[disk & body & ~lung_l & ~lung_r] = hu
        sl += rng.integers(-30, 30, size=sl.shape).astype(np.int16)
    return vol


BODYMASK_EDGE_CASES = (
    "spiral", "serpentine", "checker6", "checker5", "diagonal_leak", "full", "empty",
    "borders",
)


def bodymask_edge_slices() -> np.ndarray:
    """(8, 128, 128) float32 HU slices at the edges of the bodymask chain, in
    the order of :data:`BODYMASK_EDGE_CASES` (body 40 HU, air −1000 HU):

    * ``spiral``: 3-pixel corridors in a solid body, concentric square rings
      joined by one gap each on alternating sides and open to the border:
      the flood winds through every ring, and no part of it is a hole;
    * ``serpentine``: one 7-pixel body band folded 8 times across the slice;
    * ``checker6``, ``checker5``: checkerboards of 6- and 5-pixel squares
      whose body and air squares touch only at corners (4- vs 8-connected);
    * ``diagonal_leak``: a cavity joined to the border by a chain of
      plus-shaped air cells that touch only diagonally, so the 8-neighbour
      flood reaches it (it is no hole) though no 4-connected path does;
    * ``full`` and ``empty``;
    * ``borders``: bodies touching all four borders and corners."""
    n = 128
    out = np.full((len(BODYMASK_EDGE_CASES), n, n), -1000, dtype=np.float32)
    yy, xx = np.mgrid[0:n, 0:n]
    spiral = np.full((n, n), 40.0, np.float32)
    for k, lo in enumerate(range(1, 60, 6)):  # ring k: its corridor spans lo..lo+2
        hi = n - 1 - lo
        ring = (np.maximum(np.abs(yy - 63.5), np.abs(xx - 63.5)) <= hi - 63.5) & ~(
            np.maximum(np.abs(yy - 63.5), np.abs(xx - 63.5)) < hi - 63.5 - 2
        )
        spiral[ring] = -1000
        gap = slice(60, 66)  # the gap through the wall inside ring k
        if k % 2:
            spiral[gap, lo + 3 : lo + 6] = -1000
        else:
            spiral[gap, hi - 5 : hi - 2] = -1000
    spiral[60:66, 0:4] = -1000  # the outer ring's door to the border
    out[0] = spiral
    for k in range(8):  # serpentine: horizontal bands joined at alternating ends
        y0 = 6 + 15 * k
        out[1, y0 : y0 + 7, 6:122] = 40
        if k < 7:
            x0 = 115 if k % 2 == 0 else 6
            out[1, y0 : y0 + 22, x0 : x0 + 7] = 40
    out[2] = np.where(((yy // 6) + (xx // 6)) % 2 == 0, 40, -1000)
    out[3] = np.where(((yy // 5) + (xx // 5)) % 2 == 0, 40, -1000)
    leak = np.full((n, n), 40.0, np.float32)
    leak[50:70, 50:70] = -1000
    for c in range(1, 52, 2):  # plus shapes centred on the diagonal
        for dy, dx in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)):
            leak[c + dy, c + dx] = -1000
    out[4] = leak
    out[5] = 40
    b = out[7]
    for y0, x0 in ((0, 0), (0, 100), (100, 0), (100, 100)):
        b[y0 : y0 + 28, x0 : x0 + 28] = 40
    b[0:12, 45:83] = 40
    b[116:128, 45:83] = 40
    b[45:83, 0:12] = 40
    b[45:83, 116:128] = 40
    b[40:88, 40:88] = 40
    b[56:72, 56:72] = -1000  # a cavity
    return out


def codec_slice(seed: int, size: int = 64) -> np.ndarray:
    """One int16 CT slice for codec fixtures (size², seeded): the phantom's
    single slice at ``size``² plus uniform noise in [−200, 200) HU drawn from
    ``seed``, so every encoder sees edges and busy texture."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(-200, 200, size=(size, size)).astype(np.int16)
    return lung_phantom(1, size=size)[0] + noise
