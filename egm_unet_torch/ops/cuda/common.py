"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_activation(name: str, t: torch.Tensor, ndim: int = 4) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D (NHWC), got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous NHWC")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} must lie on the CPU or a CUDA device, got "
                         f"{t.device}")


def check_same_device(*named) -> None:
    devs = {t.device for _, t in named if t is not None}
    if len(devs) > 1:
        raise ValueError("tensors on different devices: " + ", ".join(
            f"{n}={t.device}" for n, t in named if t is not None))


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
