"""Fused CSA attention (kernel K6).

Replaces ``egm_unet_tpu/ops/pallas/csa.py::csa_attention``: for q, k, v of
shape [B, S, D] and ``num_heads`` heads of width hd = D / num_heads,

    out = merge_heads((softmax(q_h q_h^T * hd^-1/2)
                       + softmax(k_h k_h^T * hd^-1/2)) v_h)

with float32 scores, softmaxes and sums.  The CUDA kernels
(``csrc/csa_attention.cu``) read q, k, v where they lie, one block per
(batch, head, query tile) with two online-softmax accumulators, so no [S, S]
tensor is stored.  q, k and v may be strided views with last stride 1 (the
three ``chunk`` views of a fused ``in_proj`` output); the result is
contiguous.  ``csa_variant`` names the kernel a dtype gets:

- bfloat16, ``"mma_bf16"``: the tensor cores (``mma.sync`` on bf16 tiles
  filled by the TMA unit or by ``cp.async``, the weights rounded to bf16 in
  registers before they meet v, as in ``csa_plain``); the tensor-core rate
  bounds the work at the path's shape.
- float32, ``"ffma_f32"``: FFMA on the CUDA cores, in full float32, which
  holds 1e-4 relative (TF32 would not).  Its bound is 6*B*H*S^2*hd FLOP over
  67 TFLOP/s: 1.035 ms at [64, 485, 768], 0.0854 ms at [32, 197, 768].  Each
  thread's register tiles (8 query rows x 8 keys, 8 rows x 8 columns of the
  output) take 4 FFMAs per float read from shared memory by 16-byte loads;
  the key tiles arrive by 16-byte ``cp.async`` in a two-stage ring while the
  previous one is multiplied; and a warp of 32 query rows past S idles while
  the ragged last key step runs over its valid keys, so that S = 197 and 485
  pad little (``csa_f32_tiles``, ``csa_f32_flops``).

``csa_attention`` launches the kernel for CUDA tensors and runs ``csa_plain``
for CPU tensors; nothing falls back from one to the other.  It is
differentiable: the backward pass is ``csa_backward``, the closed form of the
gradient that the JAX package's ``custom_vjp`` takes of its einsum path (a
VJP in plain tensor ops there too, not a Pallas kernel).  It recomputes the
two softmaxes from the saved q, k, v and calls neither ``csa_plain`` nor
``multi_head_attention``.
"""

from __future__ import annotations

import torch

from egm_unet_torch.ops.attention import multi_head_attention
from egm_unet_torch.ops.cuda import build
from egm_unet_torch.ops.cuda.common import (DTYPE_CODES, check_same_device,
                                            stream_handle)

_CSA = build.Entry("csa_attention", "csa_attention", "egm_csa_attention",
                   "p" * 4 + "i" * 4 + "l" * 6 + "ip")

MAX_HEAD_DIM = 128



def csa_variant(dtype: torch.dtype) -> str:
    """The kernel ``csa_attention`` launches for CUDA tensors of ``dtype``:
    ``"mma_bf16"`` (tensor cores) or ``"ffma_f32"`` (CUDA cores)."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
    return "mma_bf16" if dtype == torch.bfloat16 else "ffma_f32"


# The float32 kernel's walk (csrc/csa_attention.cu, csa_ffma_kernel): a warp
# holds 32 query rows of one state, so a block of four warps holds
# F32_QUERY_TILE rows, and a warp whose rows all lie past S does no arithmetic;
# keys go F32_KEY_TILE a step (its lanes' layout), and the ragged last step
# scores its keys in groups of 8, 16 or 32.
F32_QUERY_TILE = 64
F32_KEY_TILE = 32


def head_pad(hd: int) -> int:
    """The head width a kernel template rounds ``hd`` up to (32, 64 or 128);
    the columns past hd are zeros in shared memory."""
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head width {hd} not in 1..{MAX_HEAD_DIM}")
    return 32 if hd <= 32 else 64 if hd <= 64 else 128


def csa_f32_tiles(s: int, hd: int) -> tuple:
    """``(query rows, keys)`` a block of the float32 kernel takes per tile and
    per step, for sequence length ``s`` and head width ``hd``: 64 query rows
    (four warps, two blocks an SM at hd <= 64) and 32 keys.  S fits the work,
    not the tile: rows pad to 32, since a warp past S idles, and the ragged
    last key step scores 8, 16 or 32 keys (``f32_keys_scored``); hd only
    bounds it (``head_pad``)."""
    head_pad(hd)
    if s <= 0:
        raise ValueError(f"sequence length {s} must be positive")
    return F32_QUERY_TILE, F32_KEY_TILE


def f32_keys_scored(s: int) -> int:
    """Keys whose scores the float32 kernel computes for sequence length s:
    every full step's 32, and the ragged last step's valid keys rounded up to
    8, 16 or 32 (P V runs over the valid keys only)."""
    full, rest = divmod(s, F32_KEY_TILE)
    return full * F32_KEY_TILE + (0 if rest == 0 else 8 if rest <= 8 else
                                  16 if rest <= 16 else F32_KEY_TILE)


def csa_f32_smem(hd: int) -> int:
    """Dynamic shared memory of a float32 block, in bytes: the query side's q
    and k rows transposed ([2][hdp][64]), two ring stages of the key tile (q
    and k rows at pitch hdp + 4, v rows at pitch hdp) and one P tile per warp
    ([32 keys][36])."""
    hdp = head_pad(hd)
    stage = 2 * F32_KEY_TILE * (hdp + 4) + F32_KEY_TILE * hdp
    return 4 * (2 * hdp * F32_QUERY_TILE + 2 * stage
                + 2 * (F32_QUERY_TILE // 32) * F32_KEY_TILE * 36)


def csa_f32_flops(s: int, hd: int) -> tuple:
    """``(walk, executed)`` FLOPs of the float32 kernel per (batch, head): the
    walk's two states each run a score product and a P V product, 8 * S^2 *
    hd unpadded; executed counts the query rows of the warps that work (S
    rounded up to 32), the scored keys and the padded head width."""
    rows = -(-s // 32) * 32
    hdp = head_pad(hd)
    executed = 2 * 2 * rows * hdp * (f32_keys_scored(s) + s)
    return 8.0 * s * s * hd, float(executed)


def _check(q, k, v, num_heads):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.ndim != 3:
            raise ValueError(f"{name} must be [B, S, D], got shape {tuple(t.shape)}")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} must have last stride 1, got strides "
                             f"{tuple(t.stride())}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name} must lie on the CPU or a CUDA device, got "
                             f"{t.device}")
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if min(q.shape) == 0:
        raise ValueError(f"empty input of shape {tuple(q.shape)}")
    d = q.shape[-1]
    if num_heads <= 0 or d % num_heads:
        raise ValueError(f"width {d} not divisible by num_heads {num_heads}")
    if d // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"head width {d // num_heads} > {MAX_HEAD_DIM}")
    check_same_device(("q", q), ("k", k), ("v", v))


def csa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the einsum path of
    ``ops/attention.py`` (float32 scores and softmaxes, weights rounded to
    ``v.dtype`` before the last product)."""
    return multi_head_attention(q, k, v, num_heads, csa=True)


def _forward(q, k, v, num_heads):
    if q.device.type == "cpu":
        return csa_plain(q, k, v, num_heads)
    b, s, d = q.shape
    out = torch.empty((b, s, d), dtype=q.dtype, device=q.device)
    strides = [n for t in (q, k, v) for n in (t.stride(1), t.stride(0))]
    _CSA(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
         num_heads, d // num_heads, *strides, DTYPE_CODES[q.dtype],
         stream_handle(q.device))
    return out


def csa_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 grad_out: torch.Tensor, num_heads: int) -> tuple:
    """``(dq, dk, dv)`` of ``csa_attention`` at q, k, v for the output
    gradient ``grad_out``, in closed form.  Per head, with s = hd^-1/2,
    ``P1 = softmax(s q q^T)``, ``P2 = softmax(s k k^T)`` and
    ``W = P1 + P2``:

        dv = W^T g,   dW = g v^T,
        dS_i = P_i * (dW - rowsum(dW * P_i)),
        dq = s dS_1 q + s dS_1^T q,   dk = s dS_2 k + s dS_2^T k.

    It rounds as the forward does: scores and softmaxes in float32 (float64
    for float64 inputs), W rounded to ``v.dtype`` before it meets g, and
    ``g v^T`` in the inputs' dtype, as autograd rounds them through
    ``csa_plain``; the gradients come back in the inputs' dtype.  q, k, v may
    be strided views with last stride 1."""
    b, s, d = q.shape
    hd = d // num_heads
    scale = hd ** -0.5
    dt = v.dtype
    acc = torch.promote_types(dt, torch.float32)

    def heads(t):
        return t.reshape(b, s, num_heads, hd).permute(0, 2, 1, 3)

    def merge(t):
        return t.permute(0, 2, 1, 3).reshape(b, s, d).to(dt)

    vh, gh = heads(v), heads(grad_out.to(dt))
    d_w = torch.matmul(gh, vh.transpose(-1, -2)).to(acc)
    ahs = [heads(a).to(acc) for a in (q, k)]
    probs = [torch.softmax(torch.matmul(ah, ah.transpose(-1, -2)) * scale, dim=-1)
             for ah in ahs]
    d_v = merge(torch.matmul((probs[0] + probs[1]).to(dt).transpose(-1, -2), gh))
    d_qk = []
    for ah, p in zip(ahs, probs):
        d_s = p * (d_w - (d_w * p).sum(dim=-1, keepdim=True)) * scale
        d_qk.append(merge(torch.matmul(d_s, ah) + torch.matmul(d_s.transpose(-1, -2), ah)))
    return d_qk[0], d_qk[1], d_v


class _CSAFunction(torch.autograd.Function):
    """Forward: the kernel.  Backward: ``csa_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return _forward(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, grad_out):
        return (*csa_backward(*ctx.saved_tensors, grad_out, ctx.num_heads), None)


def csa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
    """q, k, v [B, S, D] with last stride 1 (any row and batch strides), one
    dtype (float32 or bfloat16), head width D / num_heads <= 128; returns a
    contiguous [B, S, D] in that dtype."""
    _check(q, k, v, num_heads)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _CSAFunction.apply(q, k, v, num_heads)
    return _forward(q, k, v, num_heads)
