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
// - float32, "cuda_cores_f32" (csa_kernel): 4x4 register tiles over
//   transposed float32 shared-memory operands on the CUDA cores; the float32
//   weights meet v unrounded.  It holds 1e-4 relative, which TF32 would not.
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
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // key rows per loop step
constexpr int kNT = 256;  // threads: 16 x 16, each owns 4 query rows x 4 strided columns
constexpr int kLD = 65;   // row pitch of the transposed tiles (conflict-free transposing stores)

// row and batch strides of q, k and v, in elements (the last stride is 1)
struct Strides {
  long long q_row, q_batch, k_row, k_batch, v_row, v_batch;
};

// dst[d * kLD + r] = src[r * D + d] * mul, zero outside rows < rows_valid, d < hd
template <typename T, int HDP>
__device__ __forceinline__ void load_transposed(float* __restrict__ dst,
                                                const T* __restrict__ src, int rows_valid,
                                                long long D, int hd, float mul) {
  for (int e = threadIdx.x; e < 64 * HDP; e += kNT) {
    const int r = e / HDP, d = e % HDP;
    float val = 0.f;
    if (r < rows_valid && d < hd) val = egm::to_f32(src[r * D + d]) * mul;
    dst[d * kLD + r] = val;
  }
}

// dst[r * HDP + d] = src[r * D + d], zero outside
template <typename T, int HDP>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const T* __restrict__ src,
                                          int rows_valid, long long D, int hd) {
  for (int e = threadIdx.x; e < 64 * HDP; e += kNT) {
    const int r = e / HDP, d = e % HDP;
    float val = 0.f;
    if (r < rows_valid && d < hd) val = egm::to_f32(src[r * D + d]);
    dst[e] = val;
  }
}

// One online-softmax step over this thread's 4 x 4 piece of a score tile
// (log2 domain).  Columns tx + 16 j >= cols_valid are masked.  On return s
// holds exp2(s - m_new), corr the factor for the old accumulator.
__device__ __forceinline__ void online_softmax(float (&s)[4][4], float (&m)[4], float (&l)[4],
                                               float (&corr)[4], int cols_valid, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (tx + 16 * j >= cols_valid) s[i][j] = -INFINITY;
      mt = fmaxf(mt, s[i][j]);
    }
    // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float mn = fmaxf(m[i], mt);  // finite: every key tile has a valid column
    corr[i] = exp2f(m[i] - mn);        // 0 at the first tile (m = -inf)
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = exp2f(s[i][j] - mn);
      sum += s[i][j];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[i] = l[i] * corr[i] + sum;
    m[i] = mn;
  }
}

// HDP: the head width rounded up to 32, 64 or 128; columns d >= hd are zeros
// in shared memory and are never written out.
template <typename T, int HDP>
__global__ void __launch_bounds__(kNT)
csa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, int S, int H, int hd, int q_tiles, float scale_log2e,
           Strides st) {
  constexpr int NC = HDP / 16;                             // output columns per thread
  constexpr int KEYR = (HDP > kBK ? HDP : kBK) * kLD;      // key-side region, reused for P
  extern __shared__ float smem[];
  float* Qq = smem;             // [HDP][kLD] q rows of the queries, times scale * log2(e)
  float* Kq = Qq + HDP * kLD;   // [HDP][kLD] k rows of the queries, times scale * log2(e)
  float* Qk = Kq + HDP * kLD;   // [HDP][kLD] q rows of the key tile; then P1 [kBK][kLD]
  float* Kk = Qk + KEYR;        // [HDP][kLD] k rows of the key tile; then P2 [kBK][kLD]
  float* Vs = Kk + KEYR;        // [kBK][HDP] v rows of the key tile

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int qt = blockIdx.x % q_tiles;
  const int h = (blockIdx.x / q_tiles) % H;
  const int b = blockIdx.x / (q_tiles * H);
  const int D = H * hd;
  const int q0 = qt * kBQ;
  const long long base = (long long)b * S * D + (long long)h * hd;  // out at [b, 0, h*hd]
  q += b * st.q_batch + (long long)h * hd;
  k += b * st.k_batch + (long long)h * hd;
  v += b * st.v_batch + (long long)h * hd;

  load_transposed<T, HDP>(Qq, q + q0 * st.q_row, min(kBQ, S - q0), st.q_row, hd, scale_log2e);
  load_transposed<T, HDP>(Kq, k + q0 * st.k_row, min(kBQ, S - q0), st.k_row, hd, scale_log2e);

  float m1[4], l1[4], m2[4], l2[4];
  float o1[4][NC], o2[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m1[i] = m2[i] = -INFINITY;
    l1[i] = l2[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o1[i][c] = o2[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kBK) {
    const int kv = min(kBK, S - k0);
    __syncthreads();  // the previous step's P and V are consumed
    load_transposed<T, HDP>(Qk, q + k0 * st.q_row, kv, st.q_row, hd, 1.f);
    load_transposed<T, HDP>(Kk, k + k0 * st.k_row, kv, st.k_row, hd, 1.f);
    load_rows<T, HDP>(Vs, v + k0 * st.v_row, kv, st.v_row, hd);
    __syncthreads();

    float s1[4][4], s2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s1[i][j] = s2[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float a1[4], a2[4], b1[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a1[i] = Qq[d * kLD + ty * 4 + i];
        a2[i] = Kq[d * kLD + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1[j] = Qk[d * kLD + tx + 16 * j];
        b2[j] = Kk[d * kLD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s1[i][j] = fmaf(a1[i], b1[j], s1[i][j]);
          s2[i][j] = fmaf(a2[i], b2[j], s2[i][j]);
        }
    }

    float c1[4], c2[4];
    online_softmax(s1, m1, l1, c1, kv, tx);
    online_softmax(s2, m2, l2, c2, kv, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        o1[i][c] *= c1[i];
        o2[i][c] *= c2[i];
      }

    __syncthreads();  // every thread is done reading Qk / Kk
    float* P1 = Qk;
    float* P2 = Kk;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        P1[(tx + 16 * j) * kLD + ty * 4 + i] = s1[i][j];
        P2[(tx + 16 * j) * kLD + ty * 4 + i] = s2[i][j];
      }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float p1[4], p2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p1[i] = P1[j * kLD + ty * 4 + i];
        p2[i] = P2[j * kLD + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[j * HDP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o1[i][c] = fmaf(p1[i], vv, o1[i][c]);
          o2[i][c] = fmaf(p2[i], vv, o2[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv1 = 1.f / l1[i], inv2 = 1.f / l2[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < hd)
        out[base + (long long)row * D + d] =
            egm::from_f32<T>(o1[i][c] * inv1 + o2[i][c] * inv2);
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

// 2^x by the special-function unit alone (ex2.approx: 2^-inf = 0, relative
// error about 2^-22, far below the bf16 rounding of the weights)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

template <typename T, int HDP>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int KEYR = (HDP > kBK ? HDP : kBK) * kLD;
  constexpr int smem_bytes = (2 * HDP * kLD + 2 * KEYR + kBK * HDP) * (int)sizeof(float);
  auto kern = csa_kernel<T, HDP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int q_tiles;
  unsigned blocks;
  if (!grid_of(a, kBQ, &q_tiles, &blocks)) return (int)cudaErrorInvalidValue;
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)a.hd);
  kern<<<blocks, kNT, smem_bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.S, a.H, a.hd, q_tiles, scale_log2e, a.st);
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

}  // namespace

// q, k, v: [B, S, H * hd] views of one dtype (0 float32, 1 bfloat16) with last
// stride 1, row strides *_row and batch strides *_batch in elements; out:
// contiguous [B, S, H * hd] of that dtype; hd <= 128.  float32 runs the
// CUDA-core kernel, bfloat16 the tensor-core kernel.
extern "C" int egm_csa_attention(const void* q, const void* k, const void* v, void* out, int B,
                                 int S, int H, int hd, long long q_row, long long q_batch,
                                 long long k_row, long long k_batch, long long v_row,
                                 long long v_batch, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > 128) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, B, S, H, hd, {q_row, q_batch, k_row, k_batch, v_row, v_batch}};
  if (dtype == egm::kFloat32) {
    if (hd <= 32) return launch_f32<float, 32>(a, s);
    if (hd <= 64) return launch_f32<float, 64>(a, s);
    return launch_f32<float, 128>(a, s);
  }
  if (dtype == egm::kBFloat16) {
    // 16-byte copies need every row piece on the 16-byte grid
    const auto on_grid = [](const void* p, long long row, long long batch) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row % 8 == 0 && batch % 8 == 0;
    };
    const int vec = hd % 8 == 0 && on_grid(q, q_row, q_batch) && on_grid(k, k_row, k_batch) &&
                    on_grid(v, v_row, v_batch);
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
