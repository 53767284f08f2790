"""The port's one device convention: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None, force_cpu: bool = False) -> torch.device:
    """``force_cpu`` or ``device="cpu"`` → CPU; an explicit CUDA device or
    ``None`` → CUDA, which must exist."""
    if force_cpu:
        return torch.device("cpu")
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass force_cpu=True or device='cpu' "
            "(--cpu on the command line) to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
