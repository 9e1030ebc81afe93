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
// q q^T and (m2, l2, O2) for k k^T, so no [S, S] tensor ever exists, any S
// works, and at the end out = O1 / l1 + O2 / l2.  The float32 weights meet v
// without the TPU kernel's rounding of the weights to the working dtype; the
// difference is below one rounding step of the output.
//
// Bound: operations.  At the path shape ([32, 485, 768], 12 heads of 64,
// bf16) the function needs 6*B*H*S^2*hd = 34.7 GFLOP = 0.035 ms at the
// tensor cores' 989 TFLOP/s, against 4*B*S*D elements = 95 MB = 0.028 ms at
// 3.35 TB/s.  This version multiplies on the CUDA cores in float32 (4x4
// register tiles over transposed shared-memory operands) and carries two
// accumulators (four products per tile instead of three), so it runs far
// from that bound; moving the three products to mma.sync / wgmma in bf16 is
// the next step for this kernel.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // key rows per loop step
constexpr int kNT = 256;  // threads: 16 x 16, each owns 4 query rows x 4 strided columns
constexpr int kLD = 65;   // row pitch of the transposed tiles (conflict-free transposing stores)

// dst[d * kLD + r] = src[r * D + d] * mul, zero outside rows < rows_valid, d < hd
template <typename T, int HDP>
__device__ __forceinline__ void load_transposed(float* __restrict__ dst,
                                                const T* __restrict__ src, int rows_valid,
                                                int D, int hd, float mul) {
  for (int e = threadIdx.x; e < 64 * HDP; e += kNT) {
    const int r = e / HDP, d = e % HDP;
    float val = 0.f;
    if (r < rows_valid && d < hd) val = egm::to_f32(src[(long long)r * D + d]) * mul;
    dst[d * kLD + r] = val;
  }
}

// dst[r * HDP + d] = src[r * D + d], zero outside
template <typename T, int HDP>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const T* __restrict__ src,
                                          int rows_valid, int D, int hd) {
  for (int e = threadIdx.x; e < 64 * HDP; e += kNT) {
    const int r = e / HDP, d = e % HDP;
    float val = 0.f;
    if (r < rows_valid && d < hd) val = egm::to_f32(src[(long long)r * D + d]);
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
           T* __restrict__ out, int S, int H, int hd, int q_tiles, float scale_log2e) {
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
  const long long base = (long long)b * S * D + (long long)h * hd;  // [b, 0, h*hd]

  load_transposed<T, HDP>(Qq, q + base + (long long)q0 * D, min(kBQ, S - q0), D, hd,
                          scale_log2e);
  load_transposed<T, HDP>(Kq, k + base + (long long)q0 * D, min(kBQ, S - q0), D, hd,
                          scale_log2e);

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
    load_transposed<T, HDP>(Qk, q + base + (long long)k0 * D, kv, D, hd, 1.f);
    load_transposed<T, HDP>(Kk, k + base + (long long)k0 * D, kv, D, hd, 1.f);
    load_rows<T, HDP>(Vs, v + base + (long long)k0 * D, kv, D, hd);
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

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int hd,
           cudaStream_t stream) {
  constexpr int KEYR = (HDP > kBK ? HDP : kBK) * kLD;
  constexpr int smem_bytes = (2 * HDP * kLD + 2 * KEYR + kBK * HDP) * (int)sizeof(float);
  auto kern = csa_kernel<T, HDP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (S + kBQ - 1) / kBQ;
  const long long blocks = (long long)B * H * q_tiles;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const float scale_log2e = 1.4426950408889634f / sqrtf((float)hd);
  kern<<<(unsigned)blocks, kNT, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, hd, q_tiles, scale_log2e);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int hd,
        cudaStream_t stream) {
  if (hd <= 32) return launch<T, 32>(q, k, v, out, B, S, H, hd, stream);
  if (hd <= 64) return launch<T, 64>(q, k, v, out, B, S, H, hd, stream);
  if (hd <= 128) return launch<T, 128>(q, k, v, out, B, S, H, hd, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out: contiguous [B, S, H * hd] of one dtype (0 float32, 1
// bfloat16); hd <= 128.
extern "C" int egm_csa_attention(const void* q, const void* k, const void* v, void* out, int B,
                                 int S, int H, int hd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == egm::kFloat32) return run<float>(q, k, v, out, B, S, H, hd, s);
  if (dtype == egm::kBFloat16) return run<__nv_bfloat16>(q, k, v, out, B, S, H, hd, s);
  return (int)cudaErrorInvalidValue;
}
