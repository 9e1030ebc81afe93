"""PyTorch + CUDA port of ``egm_unet_tpu``'s serving and training paths.

This package serves the BN-folded EGM-UNet (A+B+C and its ablations) on an
NVIDIA Hopper GPU, and trains its BatchNorm graph (``cli/train.py``).
Activations are NHWC and conv kernels HWIO, as in the JAX package, so the
two compare like with like.  Each of the JAX package's six Pallas kernels is
hand-written CUDA here (``ops/cuda``), with a plain PyTorch version beside
it, used for CPU tensors only; the training graph runs none of them.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from egm_unet_torch.device import resolve_device  # noqa: F401
