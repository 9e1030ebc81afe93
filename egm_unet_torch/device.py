"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; a missing GPU raises rather
    than silently running on the CPU.  Pass ``"cpu"`` to run the plain
    PyTorch versions of the kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "egm_unet_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
