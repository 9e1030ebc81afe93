"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version.

| kernel          | wrapper                     | replaces (JAX package)                  |
|-----------------|-----------------------------|-----------------------------------------|
| conv3x3_gemm    | ``conv3x3.conv3x3_gemm``    | ``ops/pallas/conv3x3.py::conv3x3_gemm`` |
| mca_fused       | ``mca.mca_fused``           | ``ops/pallas/mca.py::mca_fused``        |
| up_concat_conv  | ``upconv.up_concat_conv``   | ``ops/pallas/upconv.py::up_concat_conv``|
| csa_attention   | ``csa.csa_attention``       | ``ops/pallas/csa.py::csa_attention``    |

Each wrapper module keeps ``launches``, a plain count of kernel launches.
"""

from egm_unet_torch.ops.cuda import conv3x3, csa, mca, upconv

KERNEL_MODULES = {"conv3x3_gemm": conv3x3, "mca_fused": mca,
                  "up_concat_conv": upconv, "csa_attention": csa}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
