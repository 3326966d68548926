"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never moves to the CPU by itself."""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str) -> torch.device:
    """``torch.device`` for ``Params.device``; raises when "cuda" is asked
    for and no CUDA GPU is available."""
    if name not in DEVICES:
        raise ValueError(f"unknown device {name!r}; expected one of {DEVICES}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA GPU is available "
            "(torch.cuda.is_available() is False); pass device='cpu' "
            "(--device cpu) to run the plain PyTorch engines on the CPU"
        )
    return torch.device(name)


def kernels_native(device: torch.device) -> bool:
    """Whether the hand-written kernels are the fast tier here: a CUDA
    device of compute capability 9.0 (the kernels are built for sm_90a)."""
    return device.type == "cuda" and torch.cuda.get_device_capability(device) == (9, 0)
