"""Argument checks and device facts shared by the kernel wrappers."""

from __future__ import annotations

import functools

import torch

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # shared memory one block may opt into on an H100


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def check_no_autograd(name: str, *tensors) -> None:
    """A hand-written kernel has no backward: run inside an autograd graph it
    would hand back an output without a ``grad_fn`` and every gradient above
    it would silently be zero.  So a wrapper raises when autograd is on and
    an input or weight requires grad, on every device (on the CPU the plain
    version would differentiate, and a test there should fail as the card
    would).  The training graph (``fold_bn=False``) never calls a kernel;
    the inference graph runs under ``torch.inference_mode()`` or
    ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is a forward-only kernel and an input requires grad with "
            "autograd on: call the folded model under torch.no_grad() or "
            "torch.inference_mode(), or train the unfolded graph "
            "(create_model(..., fold_bn=False))")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
