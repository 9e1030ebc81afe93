// Fused CSA (Correlative Self-Attention): per batch row and head,
//
//   out = (softmax(q q^T * scale) + softmax(k k^T * scale)) v,
//
// scale = hd^-1/2, scores, softmaxes and sums in float32, the result cast to
// the working dtype.  The weights are the SUM of two softmaxes and so are not
// row-stochastic; that is the definition, not an oversight.
//
// Replaces the TPU kernel egm_unet_tpu/ops/pallas/csa.py::csa_attention (body
// _kernel).  That kernel packs two 64-wide heads side by side into one
// 128-lane tile and separates them with lane masks, pads S to a sublane
// multiple with a -1e30 column mask, reshapes [B, S, D] to per-head-group
// slabs and back, and runs one whole [S, S] program per head group in VMEM.
// None of that carries over.  Here q, k, v and out are read and written in
// place as [B, S, D] (head h is the column range [h*hd, (h+1)*hd) with row
// stride D), the ragged edges are bounds checks, and the queries are cut into
// tiles of 64 rows so that B * H * ceil(S / 64) blocks fill the card.
//
// One block = one (batch, head, 64-query tile).  It loops over tiles of 64
// keys and keeps two online-softmax states in registers, (m1, l1, O1) for
// q q^T and (m2, l2, O2) for k k^T (two softmaxes cannot share a rescale), so
// no [S, S] tensor ever exists, any S works, and at the end
// out = O1 / l1 + O2 / l2.  q, k and v may be strided views (a row stride and
// a batch stride each, last stride 1), so the three column ranges of a fused
// in_proj output are read where they lie; out is contiguous.
//
// Two kernels, chosen by dtype (ops/cuda/csa.py::csa_variant):
//
// - bfloat16, "mma_bf16" (csa_mma_kernel): laid out like a FlashAttention-2
//   forward for mma.sync.  Four warps own 16 query rows each and keep their q
//   and k fragments in registers for the whole key loop.  The key-side tiles
//   (q rows, k rows, v rows of 64 keys) sit in a two-stage ring, the next
//   step's copies in flight during this step's products.  S = Q K^T runs on
//   the tensor cores from unscaled bf16 operands; the float32 scores are
//   multiplied by scale * log2(e) inside the exp2 argument (one FFMA and one
//   ex2.approx per weight).  Row maxima and sums are reductions over the four
//   lanes of a quad.  The weights P = exp2(s - m) are rounded to bf16 in
//   registers (the accumulator fragment of S is the A fragment of P V) and
//   never touch shared memory; the row sums l are taken from the float32 P
//   before rounding.  That is the rounding of the TPU kernel and of csa_plain
//   (weights in the working dtype before the last product), up to where the
//   normalisation sits.  The two states' chains are staggered within a step so
//   that one state's softmax stands between the other's products.
//   How the tiles arrive depends on the view.  64-wide heads on the 16-byte
//   grid (the path): one thread hands each [64, 64] tile to the TMA unit as
//   one tensor-map copy (cp.async.bulk.tensor, 128-byte swizzle so ldmatrix is
//   free of bank conflicts, rows past S zero-filled, an mbarrier per stage).
//   The same tiles by 16-byte cp.async took a large part of a step just to
//   start (twelve copies a thread): the kernel's time did not move with the query tile, the
//   ring depth or the instruction mix until the threads stopped making copies.
//   Other head widths on the 16-byte grid use cp.async into tiles with row
//   pitch hd + 8 elements; views off that grid (hd % 8 != 0, an odd stride or
//   base) take a scalar loader into the same tiles.  Head widths above 64 walk
//   32 keys a step and read the q and k fragments from shared memory, since
//   the two output accumulators alone take 128 registers there.
// - float32, "ffma_f32" (csa_ffma_kernel): FFMA on the CUDA cores in full
//   float32 (no TF32: the text trainers hold it at float32 tolerances, and it
//   holds 1e-4 relative); the float32 weights meet v unrounded.  Warps own 32
//   query rows and one state each, so a thread keeps one accumulator of 8 rows
//   x hd/8 columns, and P goes through a tile private to its warp (__syncwarp).
//
// Bound: operations.  At the path shape ([32, 485, 768], 12 heads of 64,
// bf16) the function needs 6*B*H*S^2*hd = 34.7 GFLOP = 0.035 ms at the
// tensor cores' 989 TFLOP/s, against 4*B*S*D elements = 95 MB = 0.028 ms at
// 3.35 TB/s.  The bf16 kernel runs four products per key tile instead of
// three (v meets two weight tiles) on key tiles padded to 64, with mma.sync,
// which tops out at 630-650 TFLOP/s on an H100 (probe/mma_sync_peak.cu), below
// the wgmma rate; the
// exponentials (two per score) and the softmax arithmetic take about as long
// as the products.  See PERF.md for what it reaches.
//
// In float32 the same count over the CUDA cores' 67 TFLOP/s FFMA rate is the
// bound: 1.035 ms at [64, 485, 768] (the CLIPSeg trainer's batch), 0.518 ms
// at [32, 485, 768] (the fusion CLIs), 0.0854 ms at [32, 197, 768] (the
// Long-CLIP fine-tune); the bytes take 0.11, 0.057, 0.023 ms.  The walk with
// two accumulators does 8*S^2*hd per head, 4/3 of the count.  The first
// float32 kernel (4x4 register tiles) reached 3.9x and 7x that bound, held by
// three limits, and this one answers each:
// 1. Shared-memory reads.  Scalar loads from transposed tiles of odd pitch
//    gave 2 FFMAs per float read, and an SM reads 32 floats a clock against
//    128 FFMAs.  Now every operand is a 16-byte load and each thread's tile
//    is 8 query rows x 8 keys in the scores (the two half-warps split the
//    depth and trade halves of their tiles by one shuffle per score) and 8
//    rows x 8 columns in P V: 4 FFMAs per float read in both.  The query side
//    is transposed once, when it is staged, scaled by scale * log2(e); the
//    key side stays in rows (pitch hd_pad + 4, so the four rows a quarter-warp
//    reads at one column lie on four bank groups).
// 2. No overlap of copies and math.  The key tile's q, k and v rows arrive by
//    16-byte cp.async into a two-stage ring, the next tile's copies in flight
//    during this one's products, with one __syncthreads a step.  Views off
//    the 16-byte grid (hd % 4 != 0, an odd base or stride) take a scalar
//    loader into the same tiles.
// 3. Padded work.  Tiles of 64 x 64 padded S = 197 to 256 x 256 (1.69x).
//    Now a warp whose 32 query rows lie past S idles, so rows pad to 32 in
//    blocks of 64 (ops/cuda/csa.py::csa_f32_tiles), keys go 32 a step, and
//    the ragged last step scores 8, 16 or 32 keys and runs
//    P V over its valid keys only: 1.15x at S = 197 and 1.06x at S = 485
//    (csa_f32_flops).
// Each lane keeps its own share of a row's sum (the 8 lanes of the row add
// them once, at the end), and the exponentials are ex2.approx.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

// row and batch strides of q, k and v, in elements (the last stride is 1)
struct Strides {
  long long q_row, q_batch, k_row, k_batch, v_row, v_batch;
};

// ---------------------------------------------------------------- float32, FFMA

constexpr int kFK = 32;       // keys per step
constexpr int kFW = 2;        // warps per state: a block holds 64 query rows
constexpr int kFStages = 2;   // ring depth of the key-side tiles
constexpr int kPP = 36;       // row pitch of a warp's P tile (one row per key, 32 query rows)

// floats of one ring stage: the key tile's q rows and k rows (pitch HDP + 4:
// the score loads read four neighbouring rows at one column, which the pad
// puts on four bank groups), then its v rows (pitch HDP)
__host__ __device__ constexpr int f32_stage_floats(int HDP) {
  return 2 * kFK * (HDP + 4) + kFK * HDP;
}

// dynamic shared memory of csa_ffma_kernel<HDP>: the query side transposed,
// the ring, one P tile per warp (tests/test_torch_csa_tiles.py counts it by
// hand)
__host__ __device__ constexpr int f32_smem_bytes(int HDP) {
  return (2 * HDP * 32 * kFW + kFStages * f32_stage_floats(HDP) + 2 * kFW * kFK * kPP) *
         (int)sizeof(float);
}

// Where the 8 query rows of row group rg sit in a row of a P tile: groups
// 0..3 at 0, 16, 8, 24, so that the two groups a quarter-warp stores for one
// key are four bank groups apart.
__device__ __forceinline__ int p_rows(int rg) { return 16 * (rg & 1) + 8 * (rg >> 1); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 2^x by the special-function unit alone (ex2.approx: 2^-inf = 0, relative
// error about 2^-22, far below the bf16 rounding of the weights and inside the
// float32 kernel's 1e-4)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One warp's partial score tile over its half of the head width: s[i][jj] +=
// sum_d A[d][i] * B[key(jj)][d] for its 8 query rows i and 8 keys.  A: the
// query side, transposed ([d][row], pitch BQ), at this lane's rows; B: the
// key tile's rows (pitch HDP + 4), at its first column of the half.  Keys:
// cq + 4 jj, except that with SWAP the upper half-warp holds key groups jj ^ 4
// (so that the exchange below needs no selects).  NJ < 8: only the first NJ
// key groups (the ragged last tile).
template <int HDP, int BQ, int NJ, bool SWAP>
__device__ __forceinline__ void ffma_scores(float (&s)[8][8], const float* __restrict__ A,
                                            const float* __restrict__ B, int cq, int h) {
  constexpr int KP = HDP + 4;
  // key groups per pass over a 4-deep slice: all 8, or 4 at a time at head
  // widths above 64, where the accumulator of P V takes 128 registers
  constexpr int JB = HDP > 64 && NJ > 4 ? 4 : NJ;
  static_assert(!SWAP || NJ == 8, "the swapped key order covers the whole tile");
  const float* b_lo = B + (cq + (SWAP ? 16 * h : 0)) * KP;
  const float* b_hi = B + (cq + (SWAP ? 16 - 16 * h : 16)) * KP;
#pragma unroll
  for (int d0 = 0; d0 < HDP / 2; d0 += 4) {
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += JB) {
      float4 b[JB];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const int g = j0 + jj;
        b[jj] = ld4((g < 4 ? b_lo + 4 * g * KP : b_hi + 4 * (g - 4) * KP) + d0);
      }
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float4 a0 = ld4(A + (d0 + dd) * BQ), a1 = ld4(A + (d0 + dd) * BQ + 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < JB; ++jj)
            s[i][j0 + jj] = fmaf(a[i], comp(b[jj], dd), s[i][j0 + jj]);
      }
    }
  }
}

// The float32 kernel: one block = one (batch, head, BQ-query tile), BQ = 64.
// Warps 0 and 1 hold state 1 (q q^T) and warps 2 and 3 state 2 (k k^T),
// each for 32 query rows, so that a warp keeps one output accumulator (8 rows
// x HDP/8 columns a thread) and the two states never share a rescale.  A lane
// is (h, rg, cq): rows 8 rg .. 8 rg + 7 of its warp's 32; in the scores keys
// cq + 4 jj of the step's 32 over half h of the head width (the half-warps
// split the depth, then trade halves of their tiles by one shuffle per
// element); in P V columns 4 cg + 32 c, cg = cq + 4 h.  Each thread reads 16
// floats by four 16-byte loads for 64 FFMAs in both products.
template <int HDP>
__global__ void __launch_bounds__(64 * kFW)
csa_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, int S, int H, int hd,
                int q_tiles, float scale_log2e, Strides st, int vec) {
  constexpr int BQ = 32 * kFW, NT = 64 * kFW, KP = HDP + 4, NC = HDP / 32;
  constexpr int STAGE = f32_stage_floats(HDP);
  extern __shared__ __align__(16) float smem_f32[];
  float* QT = smem_f32;                    // [2][HDP][BQ]: q, k rows of the queries, transposed
  float* ring = QT + 2 * HDP * BQ;         // per stage: q rows, k rows, v rows of the key tile
  float* Pall = ring + kFStages * STAGE;   // [2 kFW][kFK][kPP]: each warp's P^T

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int state = warp / kFW, wr = warp % kFW;
  const int h = lane >> 4, rg = (lane >> 2) & 3, cq = lane & 3, cg = cq + 4 * h;
  const int qt = blockIdx.x % q_tiles;
  const int head = (blockIdx.x / q_tiles) % H;
  const int b = blockIdx.x / (q_tiles * H);
  const int D = H * hd;
  const int q0 = qt * BQ;
  const int steps = (S + kFK - 1) / kFK;
  q += b * st.q_batch + (long long)head * hd;
  k += b * st.k_batch + (long long)head * hd;
  v += b * st.v_batch + (long long)head * hd;

  // rows row0 .. row0 + 31 of src (row stride ld), columns [0, hd), into a
  // [kFK][pitch] tile; zeros past S and past hd.  vec: 16-byte cp.async.
  auto load_tile = [&](float* dst, const float* src, long long ld, int row0, int pitch) {
    if (vec) {
      constexpr int CH = HDP / 4, RSTEP = NT / CH;  // a thread's column is fixed
      const int r0 = tid / CH, c = (tid % CH) * 4;
      const float* from = src + (row0 + r0) * ld + c;
      const uint32_t to = egm::mma::smem_addr(dst + r0 * pitch + c);
#pragma unroll
      for (int i = 0; i < kFK / RSTEP; ++i) {
        const bool ok = row0 + r0 + i * RSTEP < S && c < hd;
        egm::mma::cp_async_16(to + i * RSTEP * pitch * 4, ok ? from : src, ok);
        from += RSTEP * ld;
      }
    } else {
      for (int e = tid; e < kFK * HDP; e += NT) {
        const int r = e / HDP, d = e % HDP;
        dst[r * pitch + d] = row0 + r < S && d < hd ? src[(row0 + r) * ld + d] : 0.f;
      }
    }
  };
  auto load_stage = [&](int t) {
    float* tl = ring + (t % kFStages) * STAGE;
    load_tile(tl, q, st.q_row, t * kFK, KP);
    load_tile(tl + kFK * KP, k, st.k_row, t * kFK, KP);
    load_tile(tl + 2 * kFK * KP, v, st.v_row, t * kFK, HDP);
  };
  load_stage(0);
  egm::mma::cp_async_commit();

  // the query side, once: QT[s][d][r] = src[q0 + r][d] * scale * log2(e), the
  // transposition made here so that a thread's 8 rows are two 16-byte loads
#pragma unroll
  for (int s2 = 0; s2 < 2; ++s2) {
    const float* src = s2 ? k : q;
    const long long ld = s2 ? st.k_row : st.q_row;
    float* dst = QT + s2 * HDP * BQ;
    if (vec) {
      for (int e = tid; e < BQ * HDP / 4; e += NT) {
        const int r = e % BQ, c = (e / BQ) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + r < S && c < hd) x = ld4(src + (q0 + r) * ld + c);
        dst[(c + 0) * BQ + r] = x.x * scale_log2e;
        dst[(c + 1) * BQ + r] = x.y * scale_log2e;
        dst[(c + 2) * BQ + r] = x.z * scale_log2e;
        dst[(c + 3) * BQ + r] = x.w * scale_log2e;
      }
    } else {
      for (int e = tid; e < BQ * HDP; e += NT) {
        const int r = e % BQ, d = e / BQ;
        dst[d * BQ + r] = q0 + r < S && d < hd ? src[(q0 + r) * ld + d] * scale_log2e : 0.f;
      }
    }
  }

  // per row: the running maximum m (the same on the row's 8 lanes) and this
  // lane's share of the running sum l
  float m[8], l[8];
  float4 o[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* A = QT + state * HDP * BQ + 32 * wr + 8 * rg + h * (HDP / 2) * BQ;
  // a warp whose 32 rows all lie past S (the last query tile's second row
  // group at S = 197) keeps to the barriers and copies and does no arithmetic
  const bool active = q0 + 32 * wr < S;
  float* P = Pall + warp * kFK * kPP;
  const int prow = p_rows(rg);

  for (int t = 0; t < steps; ++t) {
    egm::mma::cp_async_wait<0>();  // step t has landed
    __syncthreads();               // ... for every thread; step t - 1 is consumed
    if (t + 1 < steps) load_stage(t + 1);
    egm::mma::cp_async_commit();
    const float* tile = ring + (t % kFStages) * STAGE;
    const float* B = tile + state * kFK * KP + h * (HDP / 2);
    const float* V = tile + 2 * kFK * KP;
    const int kv = min(kFK, S - t * kFK);
    if (!active) continue;

    // scores of this warp's state; then each half-warp keeps 4 of its 8
    // columns, summed over both halves of the depth: keys cq + 4 jj + 16 h
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
    float x[8][4];
    if (kv > 16) {
      ffma_scores<HDP, BQ, 8, true>(s, A, B, cq, h);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          x[i][jj] = s[i][jj] + __shfl_xor_sync(0xffffffffu, s[i][jj + 4], 16);
    } else {
      // at most 16 keys: the lower half-warp's 4 groups hold every valid key
      // (the upper one's keys are all >= 16 and masked below)
      if (kv > 8)
        ffma_scores<HDP, BQ, 4, false>(s, A, B, cq, h);
      else
        ffma_scores<HDP, BQ, 2, false>(s, A, B, cq, h);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          x[i][jj] = s[i][jj] + __shfl_xor_sync(0xffffffffu, s[i][jj], 16);
    }

    // online softmax in the log2 domain; a row's 32 keys lie on the 8 lanes
    // of its row group (xor 1, 2, 16)
    if (kv < kFK) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (cq + 4 * jj + 16 * h >= kv)
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i][jj] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mt = fmaxf(fmaxf(x[i][0], x[i][1]), fmaxf(x[i][2], x[i][3]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
      const float mn = fmaxf(m[i], mt);  // finite: key 0 of every tile is valid
      const float corr = fast_exp2(m[i] - mn);  // 0 at the first tile (m = -inf)
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        x[i][jj] = fast_exp2(x[i][jj] - mn);
        sum += x[i][jj];
      }
      l[i] = l[i] * corr + sum;  // this lane's 4 keys; the 8 lanes' sums meet at the end
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        o[i][c].x *= corr;
        o[i][c].y *= corr;
        o[i][c].z *= corr;
        o[i][c].w *= corr;
      }
    }

    // P^T into this warp's own tile: row = key, 8 query rows per store pair
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float* dst = P + (cq + 4 * jj + 16 * h) * kPP + prow;
      *reinterpret_cast<float4*>(dst) = make_float4(x[0][jj], x[1][jj], x[2][jj], x[3][jj]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4][jj], x[5][jj], x[6][jj], x[7][jj]);
    }
    __syncwarp();

    // O += P V over the valid keys only
    auto pv = [&](int j) {
      const float4 p0 = ld4(P + j * kPP + prow), p1 = ld4(P + j * kPP + prow + 4);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = ld4(V + j * HDP + 4 * cg + 32 * c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          o[i][c].x = fmaf(p[i], vv.x, o[i][c].x);
          o[i][c].y = fmaf(p[i], vv.y, o[i][c].y);
          o[i][c].z = fmaf(p[i], vv.z, o[i][c].z);
          o[i][c].w = fmaf(p[i], vv.w, o[i][c].w);
        }
      }
    };
    if (kv == kFK) {
#pragma unroll
      for (int j = 0; j < kFK; ++j) pv(j);
    } else {
#pragma unroll 2
      for (int j = 0; j < kv; ++j) pv(j);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 16);
  }
  // out = O1 / l1 + O2 / l2: the state-2 warps hand O2 / l2 to the state-1
  // warps of the same rows through the (consumed) ring
  __syncthreads();
  float* X = ring;  // [BQ][KP]
  if (state == 1 && active) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        *reinterpret_cast<float4*>(X + (32 * wr + 8 * rg + i) * KP + 4 * cg + 32 * c) =
            make_float4(o[i][c].x * inv, o[i][c].y * inv, o[i][c].z * inv, o[i][c].w * inv);
    }
  }
  __syncthreads();
  if (state == 0) {
    const bool vec_out = hd % 4 == 0;  // out is contiguous and 16-byte aligned
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 32 * wr + 8 * rg + i, row = q0 + r;
      if (row >= S) continue;
      const float inv = 1.f / l[i];
      float* orow = out + ((long long)b * S + row) * D + (long long)head * hd;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 4 * cg + 32 * c;
        const float4 o2 = ld4(X + r * KP + col);
        const float y[4] = {o[i][c].x * inv + o2.x, o[i][c].y * inv + o2.y,
                            o[i][c].z * inv + o2.z, o[i][c].w * inv + o2.w};
        if (vec_out && col < hd) {
          *reinterpret_cast<float4*>(orow + col) = make_float4(y[0], y[1], y[2], y[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < hd) orow[col + e] = y[e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- bf16, mma.sync

constexpr int kMQ = 64;             // query rows per block of the tensor-core kernel
constexpr int kMT = kMQ / 16 * 32;  // its threads: one warp per 16 query rows
constexpr int kStages = 2;          // ring depth of the key-side tiles

// keys per loop step: 64, or 32 at head widths above 64, where the two
// output accumulators alone take 128 registers a thread
__host__ __device__ constexpr int keys_per_step(int HDP) { return HDP <= 64 ? 64 : 32; }

// A [ROWS][HDP] bf16 tile with row pitch HDP + 8: rows row0 .. of src (row
// stride ld), columns [0, hd); rows >= S and columns >= hd are zeros.  vec:
// 16-byte cp.async copies (hd % 8 == 0, base and strides on the 16-byte
// grid); otherwise plain loads and stores.
template <int ROWS, int HDP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                          int row0, int S, long long ld, int hd, bool vec) {
  constexpr int PITCH = HDP + 8;
  if (vec) {
    constexpr int CH = HDP / 8;  // 16-byte pieces per row
    for (int e = threadIdx.x; e < ROWS * CH; e += kMT) {
      const int r = e / CH, c = (e % CH) * 8;
      const bool ok = row0 + r < S && c < hd;
      egm::mma::cp_async_16(egm::mma::smem_addr(dst + r * PITCH + c),
                            ok ? src + (row0 + r) * ld + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * HDP; e += kMT) {
      const int r = e / HDP, d = e % HDP;
      const bool ok = row0 + r < S && d < hd;
      dst[r * PITCH + d] = ok ? src[(row0 + r) * ld + d] : __float2bfloat16_rn(0.f);
    }
  }
}

// One online-softmax state of this warp's 16 query rows (q q^T or k k^T): m
// (running maximum of the raw scores) and l per row (g, g + 8), o as mma C
// fragments, and what one key step carries between its parts.
template <int HDP>
struct CsaState {
  float m[2], l[2], o[HDP / 8][4];
  float mt[2], corr[2], sum[2], mc[2];  // within a step
};

// A lane's ldmatrix address in a tile: the shared-memory address of its row
// and the 16-byte piece it reads of the row's pair of pieces `even`, even + 1.
// Padded tiles (row pitch HDP + 8 elements): piece even + c, c the lane's 0
// or 1.  Tiles the copy unit wrote with the 128-byte swizzle (128-byte rows,
// piece index xor row % 8): (even + c) ^ (row % 8).  Both are even ^ x with
// x = c or c ^ (row % 8), since even is even; row % 8 is lane % 8 throughout.
struct LaneAddr {
  uint32_t row, x;
  __device__ __forceinline__ uint32_t operator()(int even) const {
    return row + ((static_cast<uint32_t>(even) ^ x) << 4);
  }
};

// s += A B^T for 16-deep slice kb of the head width: A this warp's q or k
// fragment, B the key tile's q or k rows (an [n][k] tile, ROWB bytes a row).
template <int HDP, int KB, bool HOLD, int ROWB>
__device__ __forceinline__ void csa_scores(float (&s)[KB / 8][4],
                                           const uint32_t (&afrag)[HOLD ? HDP / 16 : 1][4],
                                           LaneAddr a_addr, LaneAddr b_addr, int kb) {
  uint32_t a[4], bq[KB / 16][4];
  if (HOLD) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = afrag[HOLD ? kb : 0][e];
  } else {
    egm::mma::ldmatrix_x4(a, a_addr(2 * kb));
  }
#pragma unroll
  for (int j2 = 0; j2 < KB / 16; ++j2)
    egm::mma::ldmatrix_x4(bq[j2], b_addr(2 * kb) + j2 * 16 * ROWB);
#pragma unroll
  for (int j2 = 0; j2 < KB / 16; ++j2) {
    egm::mma::mma_bf16(s[2 * j2], a, bq[j2][0], bq[j2][1]);
    egm::mma::mma_bf16(s[2 * j2 + 1], a, bq[j2][2], bq[j2][3]);
  }
}

// o += P V for the 16 keys of slice k2: P the weights s rounded to bf16 in
// registers (two neighbouring C fragments are one A fragment), V the [k][n]
// tile at v_addr, ROWB bytes a row.
template <int HDP, int KB, int ROWB>
__device__ __forceinline__ void csa_weighted_v(float (&o)[HDP / 8][4],
                                               const float (&s)[KB / 8][4], LaneAddr v_addr,
                                               int k2) {
  uint32_t p[4], bv[HDP / 16][4];
  p[0] = egm::mma::pack_bf16(s[2 * k2][0], s[2 * k2][1]);
  p[1] = egm::mma::pack_bf16(s[2 * k2][2], s[2 * k2][3]);
  p[2] = egm::mma::pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]);
  p[3] = egm::mma::pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3]);
#pragma unroll
  for (int n2 = 0; n2 < HDP / 16; ++n2)
    egm::mma::ldmatrix_x4_trans(bv[n2], v_addr(2 * n2) + k2 * 16 * ROWB);
#pragma unroll
  for (int n2 = 0; n2 < HDP / 16; ++n2) {
    egm::mma::mma_bf16(o[2 * n2], p, bv[n2][0], bv[n2][1]);
    egm::mma::mma_bf16(o[2 * n2 + 1], p, bv[n2][2], bv[n2][3]);
  }
}

// Part `part` (0..3) of the online-softmax update of one state over the score
// tile s, in the log2 domain; the weights are exp2(s * c - m * c) with
// c = scale * log2(e), one FFMA and one MUFU each.  Rows g (elements 0, 1)
// and g + 8 (elements 2, 3); columns 8 j + 2 t, + 1.  The parts are cut so
// that a caller can put the other state's tensor-core work between them.
template <int HDP, int KB>
__device__ __forceinline__ void csa_softmax_part(int part, float (&s)[KB / 8][4],
                                                 CsaState<HDP>& st, int kv, float c) {
  constexpr int NJ = KB / 8;
  if (part == 0) {  // mask the keys past S (last tile only), row maxima
    if (kv < KB) {
      const int col0 = (threadIdx.x & 3) * 2;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + col0 + (e & 1) >= kv) s[j][e] = -INFINITY;
    }
    st.mt[0] = st.mt[1] = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.mt[e >> 1] = fmaxf(st.mt[e >> 1], s[j][e]);
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        st.mt[r] = fmaxf(st.mt[r], __shfl_xor_sync(0xffffffffu, st.mt[r], off));
  } else if (part == 1 || part == 2) {  // the weights, half of the columns each
    if (part == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // finite: every key tile has a valid column, and a query row past S
        // is a row of zeros whose scores are 0
        const float mn = fmaxf(st.m[r], st.mt[r]);
        st.corr[r] = fast_exp2((st.m[r] - mn) * c);  // 0 at the first tile (m = -inf)
        st.m[r] = mn;
        st.mc[r] = -mn * c;
        st.sum[r] = 0.f;
      }
    }
#pragma unroll
    for (int j = (part - 1) * (NJ / 2); j < part * (NJ / 2); ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(fmaf(s[j][e], c, st.mc[e >> 1]));
        st.sum[e >> 1] += s[j][e];  // from the float32 weights, before rounding
      }
  } else {  // row sums, and the old accumulator on the new maximum
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) st.sum[r] += __shfl_xor_sync(0xffffffffu, st.sum[r], off);
#pragma unroll
    for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * st.corr[r] + st.sum[r];
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      st.o[n][0] *= st.corr[0];
      st.o[n][1] *= st.corr[0];
      st.o[n][2] *= st.corr[1];
      st.o[n][3] *= st.corr[1];
    }
  }
}

// One key step for this warp's 16 query rows.  The two states' chains are
// staggered so that the tensor cores and the arithmetic units work at once:
// S1 = Q Qk^T; then S2 = K Kk^T slice by slice with the softmax of S1 in
// between; then O1 += P1 V slice by slice with the softmax of S2 in between;
// then O2 += P2 V.  a_addr[i], b_addr[i], v_addr are this lane's ldmatrix
// addresses in the tiles; kv is the number of valid keys of the tile.
template <int HDP, int KB, bool HOLD, int ROWB>
__device__ __forceinline__ void csa_step(const uint32_t (&afrag)[2][HOLD ? HDP / 16 : 1][4],
                                         const LaneAddr (&a_addr)[2],
                                         const LaneAddr (&b_addr)[2], LaneAddr v_addr, int kv,
                                         float scale_log2e, CsaState<HDP> (&st)[2]) {
  constexpr int NKB = HDP / 16, NK2 = KB / 16;
  float s[2][KB / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < KB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;

#pragma unroll
  for (int kb = 0; kb < NKB; ++kb)
    csa_scores<HDP, KB, HOLD, ROWB>(s[0], afrag[0], a_addr[0], b_addr[0], kb);
#pragma unroll
  for (int kb = 0; kb < NKB; ++kb) {
    csa_scores<HDP, KB, HOLD, ROWB>(s[1], afrag[1], a_addr[1], b_addr[1], kb);
#pragma unroll
    for (int part = 4 * kb / NKB; part < 4 * (kb + 1) / NKB; ++part)
      csa_softmax_part<HDP, KB>(part, s[0], st[0], kv, scale_log2e);
  }
#pragma unroll
  for (int k2 = 0; k2 < NK2; ++k2) {
    csa_weighted_v<HDP, KB, ROWB>(st[0].o, s[0], v_addr, k2);
#pragma unroll
    for (int part = 4 * k2 / NK2; part < 4 * (k2 + 1) / NK2; ++part)
      csa_softmax_part<HDP, KB>(part, s[1], st[1], kv, scale_log2e);
  }
#pragma unroll
  for (int k2 = 0; k2 < NK2; ++k2) csa_weighted_v<HDP, KB, ROWB>(st[1].o, s[1], v_addr, k2);
}

constexpr int kTmaRows = 64;  // rows of the tensor maps' box

// HDP: the head width rounded up to 32, 64 or 128.  Up to 64 a warp keeps its
// rows' q and k fragments in registers for the whole key loop; at 128 the
// fragments are read from shared memory at every step.
//
// TMA (head width exactly 64, views on the 16-byte grid): one thread hands
// each [64, 64] tile to the copy unit as one tensor-map copy with the
// 128-byte swizzle, rows past S filled with zeros, completion counted by one
// mbarrier per ring stage (index kStages: the query tiles).  The threads
// execute no copy instruction of their own, which is what bounded the
// cp.async form.  Otherwise the tiles are padded and arrive by cp.async (16
// bytes per thread and copy) or, off the 16-byte grid, by plain loads.
template <int HDP, bool TMA>
__global__ void __launch_bounds__(kMT)
csa_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S,
               int H, int hd, int q_tiles, float scale_log2e, Strides st, int vec,
               const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v) {
  static_assert(!TMA || HDP == 64, "the tensor-map path is for 64-wide heads");
  constexpr int PITCH = TMA ? HDP : HDP + 8;  // elements a tile row
  constexpr int ROWB = PITCH * 2;
  constexpr int KB = keys_per_step(HDP);
  constexpr int QTILE = kMQ * PITCH, KTILE = KB * PITCH;
  constexpr bool HOLD = HDP <= 64;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  // the swizzle pattern is a function of the address: tiles start on 1024 bytes
  unsigned char* smem_base =
      TMA ? smem_mma + ((1024u - (egm::mma::smem_addr(smem_mma) & 1023u)) & 1023u) : smem_mma;
  __nv_bfloat16* Qq = reinterpret_cast<__nv_bfloat16*>(smem_base);  // q rows of the queries
  __nv_bfloat16* Kq = Qq + QTILE;                                  // k rows of the queries
  __nv_bfloat16* ring = Kq + QTILE;  // per stage: q rows, k rows, v rows of the key tile
  __shared__ __align__(8) unsigned long long bars[kStages + 1];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qt = blockIdx.x % q_tiles;
  const int h = (blockIdx.x / q_tiles) % H;
  const int b = blockIdx.x / (q_tiles * H);
  const int D = H * hd;
  const int q0 = qt * kMQ;
  const int steps = (S + KB - 1) / KB;
  q += b * st.q_batch + (long long)h * hd;
  k += b * st.k_batch + (long long)h * hd;
  v += b * st.v_batch + (long long)h * hd;

  auto load_stage = [&](int t) {  // key step t into its ring stage
    __nv_bfloat16* tl = ring + (t % kStages) * 3 * KTILE;
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        const uint32_t bar = egm::mma::smem_addr(&bars[t % kStages]);
        egm::mma::mbarrier_expect(bar, 3 * KTILE * 2);
        egm::mma::tma_load_3d(egm::mma::smem_addr(tl), &map_q, h * hd, t * KB, b, bar);
        egm::mma::tma_load_3d(egm::mma::smem_addr(tl + KTILE), &map_k, h * hd, t * KB, b, bar);
        egm::mma::tma_load_3d(egm::mma::smem_addr(tl + 2 * KTILE), &map_v, h * hd, t * KB, b, bar);
      }
    } else {
      load_tile<KB, HDP>(tl, q, t * KB, S, st.q_row, hd, vec);
      load_tile<KB, HDP>(tl + KTILE, k, t * KB, S, st.k_row, hd, vec);
      load_tile<KB, HDP>(tl + 2 * KTILE, v, t * KB, S, st.v_row, hd, vec);
    }
  };
  if constexpr (TMA) {
    static_assert(KB == kTmaRows && kMQ % kTmaRows == 0, "tiles are whole boxes");
    if (threadIdx.x == 0) {
      for (int i = 0; i <= kStages; ++i) egm::mma::mbarrier_init(egm::mma::smem_addr(&bars[i]), 1);
      egm::mma::fence_async_proxy();
      const uint32_t bar = egm::mma::smem_addr(&bars[kStages]);
      egm::mma::mbarrier_expect(bar, 2 * QTILE * 2);
      for (int r = 0; r < kMQ; r += kTmaRows) {
        egm::mma::tma_load_3d(egm::mma::smem_addr(Qq + r * PITCH), &map_q, h * hd, q0 + r, b, bar);
        egm::mma::tma_load_3d(egm::mma::smem_addr(Kq + r * PITCH), &map_k, h * hd, q0 + r, b, bar);
      }
    }
    __syncthreads();  // the barriers are initialised for every thread
    for (int t = 0; t < kStages && t < steps; ++t) load_stage(t);
    egm::mma::mbarrier_wait(egm::mma::smem_addr(&bars[kStages]), 0);
  } else {
    load_tile<kMQ, HDP>(Qq, q, q0, S, st.q_row, hd, vec);
    load_tile<kMQ, HDP>(Kq, k, q0, S, st.k_row, hd, vec);
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < steps) load_stage(t);
      egm::mma::cp_async_commit();
    }
  }

  // this lane's rows and pieces in an A tile, an [n][k] B tile and a [k][n] B
  // tile (mma.cuh); swizzled tiles xor the piece with row % 8 = lane % 8
  const uint32_t swz = TMA ? (lane & 7) : 0;
  const uint32_t a_row = (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ROWB;
  const uint32_t b_row = ((lane & 7) + 8 * (lane >> 4)) * ROWB;
  const uint32_t v_row = ((lane & 7) + 8 * ((lane >> 3) & 1)) * ROWB;
  const uint32_t a_x = (lane >> 4) ^ swz, b_x = ((lane >> 3) & 1) ^ swz, v_x = (lane >> 4) ^ swz;
  const LaneAddr a_addr[2] = {{egm::mma::smem_addr(Qq) + a_row, a_x},
                              {egm::mma::smem_addr(Kq) + a_row, a_x}};

  uint32_t afrag[2][HOLD ? HDP / 16 : 1][4];
  CsaState<HDP> state[2];  // 0: q q^T, 1: k k^T
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    state[i].m[0] = state[i].m[1] = -INFINITY;
    state[i].l[0] = state[i].l[1] = 0.f;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) state[i].o[n][e] = 0.f;
  }

  for (int t = 0; t < steps; ++t) {
    if constexpr (TMA) {
      egm::mma::mbarrier_wait(egm::mma::smem_addr(&bars[t % kStages]), (t / kStages) & 1);
    } else {
      egm::mma::cp_async_wait<kStages - 2>();  // step t has landed
      __syncthreads();                         // ... for every thread; step t - 1 is consumed
      if (t + kStages - 1 < steps) load_stage(t + kStages - 1);
      egm::mma::cp_async_commit();
    }
    if (HOLD && t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int kb = 0; kb < (HOLD ? HDP / 16 : 1); ++kb)
          egm::mma::ldmatrix_x4(afrag[i][kb], a_addr[i](2 * kb));
    }
    const uint32_t tile = egm::mma::smem_addr(ring + (t % kStages) * 3 * KTILE);
    const LaneAddr b_addr[2] = {{tile + b_row, b_x}, {tile + KTILE * 2 + b_row, b_x}};
    csa_step<HDP, KB, HOLD, ROWB>(afrag, a_addr, b_addr, {tile + 2 * KTILE * 2 + v_row, v_x},
                                  min(KB, S - t * KB), scale_log2e, state);
    if constexpr (TMA) {
      __syncthreads();  // the stage is consumed: refill it
      if (t + kStages < steps) load_stage(t + kStages);
    }
  }

  const bool pairs = ((D | hd) & 1) == 0;  // 4-byte stores stay aligned
  const int g = lane >> 2, col0 = (lane & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    const float inv1 = 1.f / state[0].l[r], inv2 = 1.f / state[1].l[r];
    __nv_bfloat16* orow = out + ((long long)b * S + row) * D + (long long)h * hd;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      const int d = n * 8 + col0;
      const float x0 = state[0].o[n][2 * r] * inv1 + state[1].o[n][2 * r] * inv2;
      const float x1 = state[0].o[n][2 * r + 1] * inv1 + state[1].o[n][2 * r + 1] * inv2;
      if (pairs && d + 1 < hd) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < hd) orow[d] = __float2bfloat16_rn(x0);
        if (d + 1 < hd) orow[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, S, H, hd;
  Strides st;
};

bool grid_of(const Args& a, int bq, int* q_tiles, unsigned* blocks) {
  *q_tiles = (a.S + bq - 1) / bq;
  const long long n = (long long)a.B * a.H * *q_tiles;
  *blocks = (unsigned)n;
  return n > 0 && n <= 2147483647LL;
}

template <int HDP>
int launch_ffma(const Args& a, int vec, cudaStream_t stream) {
  constexpr int smem_bytes = f32_smem_bytes(HDP);
  auto kern = csa_ffma_kernel<HDP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's 228 KB as shared memory, so that the blocks fit side by side
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  int q_tiles;
  unsigned blocks;
  if (!grid_of(a, 32 * kFW, &q_tiles, &blocks)) return (int)cudaErrorInvalidValue;
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)a.hd);
  kern<<<blocks, 64 * kFW, smem_bytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.S, a.H, a.hd, q_tiles,
      scale_log2e, a.st, vec);
  return (int)cudaGetLastError();
}

// [B, S, D] bf16 view with row and batch strides in elements; box 64 x 64,
// 128-byte swizzle.
bool make_map(CUtensorMap* map, const void* base, int B, int S, int D, long long row,
              long long batch) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  // a batch of one may come with any batch stride
  const cuuint64_t strides[2] = {(cuuint64_t)row * 2, (cuuint64_t)(B == 1 ? S * row : batch) * 2};
  const cuuint32_t box[3] = {64, kTmaRows, 1};
  return egm::mma::make_tensor_map(map, base, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HDP, bool TMA>
int launch_mma(const Args& a, int vec, cudaStream_t stream) {
  constexpr int row = TMA ? HDP : HDP + 8;
  constexpr int smem_bytes = (2 * kMQ + 3 * kStages * keys_per_step(HDP)) * row *
                                 (int)sizeof(__nv_bfloat16) + (TMA ? 1024 : 0);
  auto kern = csa_mma_kernel<HDP, TMA>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int q_tiles;
  unsigned blocks;
  if (!grid_of(a, kMQ, &q_tiles, &blocks)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3] = {};
  if (TMA) {
    const int D = a.H * a.hd;
    if (!make_map(&maps[0], a.q, a.B, a.S, D, a.st.q_row, a.st.q_batch) ||
        !make_map(&maps[1], a.k, a.B, a.S, D, a.st.k_row, a.st.k_batch) ||
        !make_map(&maps[2], a.v, a.B, a.S, D, a.st.v_row, a.st.v_batch))
      return (int)cudaErrorInvalidValue;
  }
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)a.hd);
  using bf16 = __nv_bfloat16;
  kern<<<blocks, kMT, smem_bytes, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.S, a.H, a.hd, q_tiles,
      scale_log2e, a.st, vec, maps[0], maps[1], maps[2]);
  return (int)cudaGetLastError();
}

// Every row piece of a view on the 16-byte grid: base, row and batch strides
// (in elements of `elem` bytes).
bool on_grid(const void* p, long long row, long long batch, int elem) {
  const int per = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row % per == 0 && batch % per == 0;
}

}  // namespace

// q, k, v: [B, S, H * hd] views of one dtype (0 float32, 1 bfloat16) with last
// stride 1, row strides *_row and batch strides *_batch in elements; out:
// contiguous [B, S, H * hd] of that dtype; hd <= 128.  float32 runs the FFMA
// kernel, bfloat16 the tensor-core kernel.
extern "C" int egm_csa_attention(const void* q, const void* k, const void* v, void* out, int B,
                                 int S, int H, int hd, long long q_row, long long q_batch,
                                 long long k_row, long long k_batch, long long v_row,
                                 long long v_batch, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > 128) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, B, S, H, hd, {q_row, q_batch, k_row, k_batch, v_row, v_batch}};
  if (dtype == egm::kFloat32) {
    // 16-byte cp.async copies need every row piece on the 16-byte grid;
    // otherwise a scalar loader fills the same tiles
    const int vec = hd % 4 == 0 && on_grid(q, q_row, q_batch, 4) &&
                    on_grid(k, k_row, k_batch, 4) && on_grid(v, v_row, v_batch, 4);
    if (hd <= 32) return launch_ffma<32>(a, vec, s);
    if (hd <= 64) return launch_ffma<64>(a, vec, s);
    return launch_ffma<128>(a, vec, s);
  }
  if (dtype == egm::kBFloat16) {
    const int vec = hd % 8 == 0 && on_grid(q, q_row, q_batch, 2) &&
                    on_grid(k, k_row, k_batch, 2) && on_grid(v, v_row, v_batch, 2);
    // a tensor map wants rows that do not overlap and batches that do not either
    const auto spread = [&](long long row, long long batch) {
      return row >= (long long)H * hd && (B == 1 || batch >= S * row);
    };
    if (vec && hd == 64 && spread(q_row, q_batch) && spread(k_row, k_batch) &&
        spread(v_row, v_batch))
      return launch_mma<64, true>(a, vec, s);
    if (hd <= 32) return launch_mma<32, false>(a, vec, s);
    if (hd <= 64) return launch_mma<64, false>(a, vec, s);
    return launch_mma<128, false>(a, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}
