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

Every launch goes through a ``build.Entry``, which counts it in
``build.LAUNCHES``.
"""

# each wrapper module registers its entries on import
from egm_unet_torch.ops.cuda import (build, conv3x3, csa, edge, gates, mca,  # noqa: F401
                                     resize2x, upconv)


def launch_counts() -> dict:
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    for name in build.LAUNCHES:
        build.LAUNCHES[name] = 0
