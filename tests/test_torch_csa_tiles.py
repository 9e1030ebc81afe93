"""Host-side choices of K6's float32 kernel (``csa_ffma_kernel``) and its
blocked arithmetic: the tiles ``csa_f32_tiles`` as a pure function of (S, hd),
the walk's coverage of every query row and key, the lanes' layout
over a score tile and an output tile, the padded work at the paths' sequence
lengths, each block's shared memory against a hand count, and a float32
emulation of the walk (half-depth partial scores, key steps of 32 with the
ragged last one masked, two online states with per-lane row sums, ``O1 / l1
+ O2 / l2``) against ``csa_plain`` and the JAX kernel in interpret mode.  All
of it runs on the CPU in seconds; the kernel itself is held against its plain
version on the card by ``chip_smoke.py``.

Tolerance of the emulation: float32 2e-4 relative and absolute, the bar
``tests/test_torch_csa.py`` sets for the same comparison (softmax sums in
another order)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from egm_unet_tpu.ops.pallas.csa import csa_attention as jcsa

from egm_unet_torch.ops.cuda import csa

from tests.torch_port_util import assert_close, to_torch

SMEM_LIMIT = 232448  # what one block may opt into on an H100
SM_LIMIT = 228 * 1024  # shared memory of one SM
RESERVED = 1024  # what the card keeps per block
SMS = 132
LOG2E = 1.4426950408889634

# the paths' sequence lengths (ViT-B/16 at 352 and 224 px), then the tile
# boundaries: S = 1, the ragged last step's groups, on and one past the key
# step and the query tile's warps, and a long S
LENGTHS = [485, 197, 1, 2, 8, 9, 16, 17, 31, 32, 33, 63, 64, 65, 96, 97, 128, 1000]
HEAD_WIDTHS = [1, 8, 9, 31, 32, 33, 63, 64, 65, 100, 127, 128]


@pytest.mark.parametrize("s", LENGTHS)
def test_tiles_are_a_pure_function_of_s_and_hd(s):
    for hd in HEAD_WIDTHS:
        bq, bk = csa.csa_f32_tiles(s, hd)
        assert (bq, bk) == csa.csa_f32_tiles(int(np.int64(s)), int(np.int32(hd)))
        # four warps of 32 rows, two a state; at S <= 32 one warp a state idles
        assert bq == csa.F32_QUERY_TILE == 64 and bk == csa.F32_KEY_TILE == 32


@pytest.mark.parametrize("bad", [(0, 64), (-1, 64), (10, 0), (10, 129), (10, -3)])
def test_tiles_reject_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        csa.csa_f32_tiles(*bad)


@pytest.mark.parametrize("s", LENGTHS)
def test_query_tiles_and_key_steps_cover_every_row_and_key_once(s):
    bq, bk = csa.csa_f32_tiles(s, 64)
    rows = np.zeros(s, np.int32)
    for q0 in range(0, s, bq):  # one block per query tile
        for wr in range(bq // 32):  # its row groups, one warp per state each
            r0 = q0 + 32 * wr
            if r0 >= s:  # the warp idles: none of its rows is a query
                continue
            rows[r0:min(r0 + 32, s)] += 1
    assert (rows == 1).all()
    keys = np.zeros(s, np.int32)
    for k0 in range(0, s, bk):
        kv = min(bk, s - k0)
        keys[k0:k0 + kv] += 1
        # the step scores 8, 16 or 32 keys; P V runs over its kv keys
        scored = 8 if kv <= 8 else 16 if kv <= 16 else 32
        assert kv <= scored <= bk and scored - kv < 16
    assert (keys == 1).all()
    assert csa.f32_keys_scored(s) - s < 16 and csa.f32_keys_scored(s) >= s


def test_lanes_cover_a_score_tile_and_an_output_tile_once():
    """A lane is (h, rg, cq) = (lane >> 4, (lane >> 2) & 3, lane & 3).  After
    the half-warps trade halves of their score tiles it holds rows 8 rg + i
    and keys cq + 4 jj + 16 h (i < 8, jj < 4); in P V it holds rows 8 rg + i
    and columns 4 cg + 32 c + e, cg = cq + 4 h (e < 4, c < hd_pad / 32)."""
    for hdp in (32, 64, 128):
        scores = np.zeros((32, 32), np.int32)
        outs = np.zeros((32, hdp), np.int32)
        for lane in range(32):
            h, rg, cq = lane >> 4, (lane >> 2) & 3, lane & 3
            cg = cq + 4 * h
            for i in range(8):
                for jj in range(4):
                    scores[8 * rg + i, cq + 4 * jj + 16 * h] += 1
                for c in range(hdp // 32):
                    outs[8 * rg + i, 4 * cg + 32 * c:4 * cg + 32 * c + 4] += 1
        assert (scores == 1).all() and (outs == 1).all()
        # before the trade each half-warp holds 8 keys of its rows over half
        # of the depth: the upper one in the order jj ^ 4, so that the lower
        # one keeps its groups 0..3 and the upper one 4..7
        for h in (0, 1):
            held = sorted(cq + 4 * (jj ^ (4 * h)) for cq in range(4) for jj in range(8))
            assert held == list(range(32))


@pytest.mark.parametrize("s,bound", [(197, 1.15), (485, 1.06)])
def test_padded_work_is_small_at_the_path_lengths(s, bound):
    """Executed FFMA work over the walk's unpadded 8 S^2 hd (two states, a
    score and a P V product each) at hd 64: the first float32 kernel's 64 x 64
    tiles padded S = 197 to 256 x 256 (1.69x) and 485 to 512 x 512 (1.11x)."""
    walk, executed = csa.csa_f32_flops(s, 64)
    rows = -(-s // 32) * 32  # the rows of the warps that work
    scored = {197: 6 * 32 + 8, 485: 15 * 32 + 8}[s]  # a last step of 5 keys: one group of 8
    assert walk == 8.0 * s * s * 64
    assert executed == 2 * 2 * rows * 64 * (scored + s)
    assert executed / walk < bound
    old = (-(-s // 64) * 64) ** 2 / s ** 2
    assert executed / walk < old


def test_shared_memory_by_hand():
    # hd 64, 64 query rows: q and k rows transposed 2 * 64 * 64, two ring
    # stages of (q rows + k rows at pitch 68 + v rows at 64) * 32 keys, four
    # warps' P tiles of 32 x 36, all float32
    hd64 = 4 * (2 * 64 * 64 + 2 * (2 * 32 * 68 + 32 * 64) + 4 * 32 * 36)
    assert hd64 == csa.csa_f32_smem(64) == 102400
    # at least two blocks an SM at hd 64
    assert 2 * (hd64 + RESERVED) <= SM_LIMIT
    for hd in (1, 9, 32, 33, 64, 65, 100, 128):
        hdp = csa.head_pad(hd)
        hand = 4 * (2 * hdp * 64 + 2 * (2 * 32 * (hdp + 4) + 32 * hdp) + 4 * 32 * 36)
        assert csa.csa_f32_smem(hd) == hand <= SMEM_LIMIT
        # the epilogue's [64][hdp + 4] exchange of O2 / l2 fits the ring
        assert 64 * (hdp + 4) <= 2 * (2 * 32 * (hdp + 4) + 32 * hdp)


@pytest.mark.parametrize("b,s", [(32, 197), (32, 485), (64, 485)])
def test_enough_blocks_for_two_waves(b, s):
    heads, hd = 12, 64
    bq = csa.csa_f32_tiles(s, hd)[0]
    blocks = b * heads * -(-s // bq)
    per_sm = SM_LIMIT // (csa.csa_f32_smem(hd) + RESERVED)
    assert per_sm >= 2
    assert blocks >= 2 * SMS * per_sm


def ffma_walk(q, k, v, num_heads):
    """The float32 kernel's walk in plain PyTorch: per block of 64
    query rows, warps of 32 rows (one per state; a warp whose rows lie past S
    idles); per key step of 32, scores as the sum of two half-depth products
    (the two half-warps) from the query side scaled by hd^-1/2 log2(e), keys
    past S masked, a running maximum per row and a running sum per lane (the
    lane's keys cq + 4 jj + 16 h), o rescaled and P V over the valid keys;
    at the end out = O1 * (1 / l1) + O2 * (1 / l2), l the sum of the lanes'."""
    b, s, d = q.shape
    hd = d // num_heads
    hdp = csa.head_pad(hd)
    bq, bk = csa.csa_f32_tiles(s, hd)
    scale = torch.tensor(LOG2E, dtype=torch.float32) / torch.sqrt(
        torch.tensor(float(hd), dtype=torch.float32))

    def heads(t):
        t = t.reshape(b, s, num_heads, hd).permute(0, 2, 1, 3)
        return F.pad(t, (0, hdp - hd))  # the zero columns of the padded tiles

    qh, kh, vh = heads(q), heads(k), heads(v)
    half = hdp // 2
    out = torch.zeros(b, num_heads, s, hdp)
    for q0 in range(0, s, bq):
        for wr in range(bq // 32):
            r0 = q0 + 32 * wr
            if r0 >= s:
                continue
            rows = slice(r0, min(r0 + 32, s))
            states = []
            for a in (qh, kh):
                aq = a[:, :, rows] * scale
                n = aq.shape[2]
                m = torch.full((b, num_heads, n, 1), -math.inf)
                l = torch.zeros((b, num_heads, n, 2, 4))  # lanes (h, cq)
                o = torch.zeros((b, num_heads, n, hdp))
                for k0 in range(0, s, bk):
                    kv = min(bk, s - k0)
                    keys = a[:, :, k0:k0 + kv]
                    sc = (aq[..., :half] @ keys[..., :half].transpose(-1, -2)
                          + aq[..., half:] @ keys[..., half:].transpose(-1, -2))
                    sc = F.pad(sc, (0, bk - kv), value=-math.inf)
                    mn = torch.maximum(m, sc.amax(-1, keepdim=True))
                    corr = torch.exp2(m - mn)
                    p = torch.exp2(sc - mn)
                    # key 16 h + 4 jj + cq: the lane (h, cq) sums over jj
                    l = l * corr[..., None] + p.reshape(b, num_heads, n, 2, 4, 4).sum(-2)
                    o = o * corr + p[..., :kv] @ vh[:, :, k0:k0 + kv]
                    m = mn
                states.append((o, l.sum((-2, -1))[..., None]))
            (o1, l1), (o2, l2) = states
            out[:, :, rows] = o1 * (1 / l1) + o2 * (1 / l2)
    return out[..., :hd].permute(0, 2, 1, 3).reshape(b, s, d)


@pytest.mark.parametrize("hd", [8, 9, 64, 100, 128])
@pytest.mark.parametrize("s", [1, 2, 63, 64, 65, 197])
def test_ffma_walk_matches_plain_and_pallas_interpret(s, hd):
    rng = np.random.default_rng(1000 * s + hd)
    heads = 2
    q, k, v = [(rng.standard_normal((2, s, heads * hd)) * sc).astype(np.float32)
               for sc in (1.5, 1.0, 1.0)]  # the smoke run's operand scales
    got = ffma_walk(*map(to_torch, (q, k, v)), heads)
    assert_close(got, csa.csa_plain(*map(to_torch, (q, k, v)), heads), 2e-4, 2e-4)
    ref = jcsa(*map(jnp.asarray, (q, k, v)), heads, interpret=True)
    assert_close(got, ref, 2e-4, 2e-4)


def test_ffma_walk_at_a_path_length():
    """S = 485 at hd 64 (the CLIPSeg tower's tokens), against the plain
    version: sixteen key steps, the last of 5 keys, in 64-row blocks."""
    rng = np.random.default_rng(485)
    q, k, v = [(rng.standard_normal((1, 485, 128)) * sc).astype(np.float32)
               for sc in (1.5, 1.0, 1.0)]
    got = ffma_walk(*map(to_torch, (q, k, v)), 2)
    assert_close(got, csa.csa_plain(*map(to_torch, (q, k, v)), 2), 2e-4, 2e-4)
