"""PyTorch + CUDA port of ``egm_unet_tpu``'s serving path.

This package runs the BN-folded EGM-UNet (A+B+C and its ablations) on an
NVIDIA Hopper GPU.  Activations are NHWC and conv kernels HWIO, as in the
JAX package, so the two compare like with like.  Three of the JAX package's
Pallas kernels are hand-written CUDA here (``ops/cuda``): the fused MCALayer
enhancement, the 3x3 implicit-GEMM conv and the fused decoder
upsample+concat+conv.  Each has a plain PyTorch version beside it, used for
CPU tensors only.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from egm_unet_torch.device import resolve_device  # noqa: F401
