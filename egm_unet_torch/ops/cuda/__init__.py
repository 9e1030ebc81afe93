"""Hand-written CUDA kernels of the serving paths, each beside its plain
PyTorch version.

| kernel            | wrapper                       | replaces (JAX package)                       |
|-------------------|-------------------------------|----------------------------------------------|
| conv3x3_gemm      | ``conv3x3.conv3x3_gemm``      | ``ops/pallas/conv3x3.py::conv3x3_gemm``      |
| conv3x3_pair_gemm | ``conv3x3.conv3x3_pair_gemm`` | ``ops/pallas/conv3x3.py::conv3x3_pair_gemm`` |
| mca_fused         | ``mca.mca_fused``             | ``ops/pallas/mca.py::mca_fused``             |
| up_concat_conv    | ``upconv.up_concat_conv``     | ``ops/pallas/upconv.py::up_concat_conv``     |
| upsample2x_fused  | ``resize2x.upsample2x_fused`` | ``ops/pallas/resize2x.py::upsample2x_fused`` |
| csa_attention     | ``csa.csa_attention``         | ``ops/pallas/csa.py::csa_attention``         |
| mca_gates         | ``gates.mca_gates``           | none (the gates are plain jnp there)         |
| eafe_edge         | ``edge.eafe_edge``            | none (the EAFE's edge is plain jnp there)    |

Each wrapper keeps a plain count of its kernel's launches in its module.
"""

from egm_unet_torch.ops.cuda import conv3x3, csa, edge, gates, mca, resize2x, upconv

# kernel -> (module, name of its launch counter there)
KERNEL_COUNTERS = {"conv3x3_gemm": (conv3x3, "launches"),
                   "conv3x3_pair_gemm": (conv3x3, "pair_launches"),
                   "mca_fused": (mca, "launches"),
                   "up_concat_conv": (upconv, "launches"),
                   "upsample2x_fused": (resize2x, "launches"),
                   "csa_attention": (csa, "launches"),
                   "mca_gates": (gates, "launches"),
                   "eafe_edge": (edge, "launches")}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNEL_COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)
