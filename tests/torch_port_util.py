"""Shared helpers of the egm_unet_torch parity tests: seeded numpy weights for
a flax module (no eager ``init``, which is slow on the CPU), and numpy <->
torch conversion."""

from __future__ import annotations

import jax
import numpy as np
import torch


def random_variables(module, *args, seed: int = 0, **kwargs):
    """A variables tree of numpy arrays with the structure of
    ``module.init(key, *args, **kwargs)``: He-uniform conv kernels, small
    biases, randomized BatchNorm statistics and affine parameters, MCA blend
    weights in [0, 1) and gate kernels in [-1, 1), LayerNorm scales around 1,
    normal embeddings and positional tables, fan-in scaled projections."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [p.key for p in path]
        name = names[-1]
        shape = s.shape
        if "batch_stats" == names[0]:
            if name == "mean":
                return rng.normal(0.0, 0.3, shape).astype(np.float32)
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)  # var
        if any(n.startswith("BatchNorm") for n in names):
            if name == "scale":
                return rng.uniform(0.7, 1.3, shape).astype(np.float32)
            return rng.normal(0.0, 0.1, shape).astype(np.float32)
        if len(names) >= 2 and names[-2] in ("h_cw", "w_hc", "c_hw"):
            if name == "weight":
                return rng.uniform(0.0, 1.0, shape).astype(np.float32)
            return rng.uniform(-1.0, 1.0, shape).astype(np.float32)
        if name == "scale" and shape == ():  # RecursiveGatedAttention
            return np.asarray(rng.uniform(0.5, 1.5), np.float32)
        if name == "scale":  # LayerNorm
            return rng.uniform(0.7, 1.3, shape).astype(np.float32)
        if name == "embedding" or name.endswith("_embedding") or name.endswith(
                "_embedding_res"):
            return rng.normal(0.0, 0.3, shape).astype(np.float32)
        if name in ("proj", "text_projection", "tc_k1", "tc_k2"):
            bound = np.sqrt(3.0 / shape[0])
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if name.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            bound = np.sqrt(6.0 / fan_in)
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        return np.asarray(rng.uniform(-0.1, 0.1, shape), np.float32)  # biases

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def assert_close(port: torch.Tensor, ref, rtol: float, atol: float) -> None:
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=rtol, atol=atol)
