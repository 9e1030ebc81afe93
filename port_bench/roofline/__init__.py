"""The yardstick of the per-layer metrics: the chip's published peaks, the
bytes and operations each hand-written kernel's function needs at the
shapes of a cell (counted from the layer shapes, not read from the
program), the whole model's FLOPs, and the names of the device kernels that
implement each operation (``names/<operation>/<kernel name>``, one empty
file per name: a later kernel adds a file, it edits none)."""

from __future__ import annotations

from pathlib import Path

# NVIDIA H100 SXM data sheet, dense rates: HBM3 bytes/s, bf16 tensor-core
# and float32 CUDA-core FLOP/s (the float32 paths here run with TF32 off)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ITEMSIZE = {"bfloat16": 2, "float32": 4}

NAMES_DIR = Path(__file__).resolve().parent / "names"


def kernel_names(*operations: str) -> set:
    """The union of the device-kernel names listed for ``operations``."""
    out = set()
    for op in operations:
        d = NAMES_DIR / op
        if not d.is_dir():
            raise FileNotFoundError(f"no kernel names listed for operation {op!r} in {d}")
        out |= {p.name for p in d.iterdir() if p.is_file()}
    return out


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time of a call: bytes over the HBM rate or operations over
    the dtype's peak, whichever is larger."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])
