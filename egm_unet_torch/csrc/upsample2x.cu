// 2x bilinear align_corners=True upsample, NHWC: (B, h, w, C) -> (B, 2h, 2w, C),
// the UNet decoder's nn.Upsample(scale_factor=2, align_corners=True).
//
// Replaces the TPU kernel egm_unet_tpu/ops/pallas/resize2x.py::upsample2x_fused
// (bodies _merged_kernel, _w_kernel, _h_kernel).  That kernel blends the W
// axis as even/odd phases of the slab and its two sublane rolls, and runs the
// H axis as a banded matmul over host-compacted blocks of the interpolation
// matrix; the one-kernel / two-kernel split by channel count, the f32 scratch
// for strided stores and the H, W % 8 guard are Mosaic constraints.  None of
// that carries over: what it computes is, per output element,
//
//   t(r)  = round_T(cw_lo * x[r, c_lo] + cw_hi * x[r, c_hi])   r = r_lo, r_hi
//   out   = round_T(rw_lo * t(r_lo) + rw_hi * t(r_hi))
//
// with the column weights the float32 rows of the interpolation matrix, the
// row weights the same rows rounded to the working dtype T, and every product
// and sum in float32.  The taps (lo, hi, w_lo, w_hi) per output row and column
// come from the host.  Products and sums are __fmul_rn / __fadd_rn so that no
// FMA contraction moves the last bit against the plain version, and a tap of
// weight zero is left out of the sum, so a non-finite neighbour it would have
// read cannot reach the output.
//
// Bound: 4 multiplies per output element against one element written and a
// quarter of one read, so device-memory bytes bound it.  A block owns a band
// of BR = 16 output rows by a strip of BQ output columns of one image, all
// channels: it stages the input patch those rows and columns read (at most
// BR/2 + 2 rows by BQ/2 + 2 columns, checked by a trap) and its taps in
// shared memory, by 16-byte cp.async where C fills whole 16-byte vectors and
// x and out are 16-byte aligned (the "band_cp_async" variant), else element
// by element ("band_scalar").  Each thread owns one vector (8 bf16 or 4
// float32 channels, or one element) of one output column and walks the band's
// rows: it blends each input row's two columns once, rounded to T, keeps the
// last two in registers, and blends them along H into each output row, which
// it writes as one 16-byte store; neighbouring threads write neighbouring
// vectors of the contiguous output row.  Indices are 32-bit from blockIdx,
// with one 64-bit image base.  Any h, w, C (up to the patch's shared memory).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NT = 256, BR = 16;

// input rows (or columns) that n consecutive outputs read, at most
__host__ __device__ constexpr int patch_max(int n) { return (n - 1) / 2 + 3; }

__device__ __forceinline__ float blend2(float w_lo, float v_lo, float w_hi, float v_hi) {
  const float s = __fmul_rn(w_lo, v_lo);
  return w_hi != 0.f ? __fadd_rn(s, __fmul_rn(w_hi, v_hi)) : s;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// shared memory of one block: the taps, then the patch
__host__ __device__ constexpr int taps_bytes(int bq) { return 16 * (BR + bq); }
inline int smem_bytes(int bq, int C, int itemsize) {
  return taps_bytes(bq) + patch_max(BR) * patch_max(bq) * C * itemsize;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
upsample2x_band_kernel(const T* __restrict__ x, T* __restrict__ out,
                       const int* __restrict__ rlo, const int* __restrict__ rhi,
                       const float* __restrict__ rwl, const float* __restrict__ rwh,
                       const int* __restrict__ clo, const int* __restrict__ chi,
                       const float* __restrict__ cwl, const float* __restrict__ cwh, int h,
                       int w, int C, int bq) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_rlo = reinterpret_cast<int*>(smem);
  int* s_rhi = s_rlo + BR;
  float* s_rwl = reinterpret_cast<float*>(s_rhi + BR);
  float* s_rwh = s_rwl + BR;
  int* s_clo = reinterpret_cast<int*>(s_rwh + BR);
  int* s_chi = s_clo + bq;
  float* s_cwl = reinterpret_cast<float*>(s_chi + bq);
  float* s_cwh = s_cwl + bq;
  P* patch = reinterpret_cast<P*>(smem + taps_bytes(bq));

  const int H2 = 2 * h, W2 = 2 * w, CV = C / VEC;
  const int q0 = blockIdx.x * bq, p0 = blockIdx.y * BR, b = blockIdx.z;
  const int nq = min(bq, W2 - q0), np = min(BR, H2 - p0);
  const int r0 = rlo[p0], rows = rhi[p0 + np - 1] - r0 + 1;
  const int k0 = clo[q0], cols = chi[q0 + nq - 1] - k0 + 1;
  if (rows > patch_max(BR) || cols > patch_max(bq)) __trap();

  const int tid = threadIdx.x;
  if (tid < np) {
    s_rlo[tid] = rlo[p0 + tid] - r0;
    s_rhi[tid] = rhi[p0 + tid] - r0;
    s_rwl[tid] = rwl[p0 + tid];
    s_rwh[tid] = rwh[p0 + tid];
  }
  for (int q = tid; q < nq; q += NT) {
    s_clo[q] = clo[q0 + q] - k0;
    s_chi[q] = chi[q0 + q] - k0;
    s_cwl[q] = cwl[q0 + q];
    s_cwh[q] = cwh[q0 + q];
  }
  const P* xb = reinterpret_cast<const P*>(x + (size_t)b * h * w * C);
  const int units = rows * cols * CV;
  for (int u = tid; u < units; u += NT) {
    const int v = u % CV, pix = u / CV;
    const int rr = pix / cols, kk = pix - rr * cols;
    const P* src = xb + ((r0 + rr) * w + k0 + kk) * CV + v;
    if constexpr (VEC > 1)
      egm::mma::cp_async_16(egm::mma::smem_addr(patch + u), src, true);
    else
      patch[u] = *src;
  }
  if constexpr (VEC > 1) {
    egm::mma::cp_async_commit();
    egm::mma::cp_async_wait<0>();
  }
  __syncthreads();

  P* ob = reinterpret_cast<P*>(out + (size_t)b * H2 * W2 * C);
  for (int e = tid; e < nq * CV; e += NT) {
    const int q = e / CV, v = e - q * CV;
    const int c_lo = s_clo[q], c_hi = s_chi[q];
    const float cw0 = s_cwl[q], cw1 = s_cwh[q];
    // the column blends of the last two input rows, rounded to T
    int ra = -1, rb = -1;
    float ta[VEC], tb[VEC];
    auto colblend = [&](int r, float (&t)[VEC]) {
      const P u0 = patch[(r * cols + c_lo) * CV + v];
      const P u1 = patch[(r * cols + c_hi) * CV + v];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        t[i] = egm::round_to<T>(
            blend2(cw0, egm::to_f32(u0.v[i]), cw1, egm::to_f32(u1.v[i])));
    };
    for (int p = 0; p < np; ++p) {
      const int lo = s_rlo[p], hi = s_rhi[p];
      const float a0 = s_rwl[p], a1 = s_rwh[p];
      // rows only move forward: keep (ra, ta) = lo and (rb, tb) = lo + 1
      if (ra != lo) {
        if (rb == lo) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) ta[i] = tb[i];
        } else {
          colblend(lo, ta);
        }
        ra = lo;
        rb = -1;
      }
      P res;
      if (a1 != 0.f) {
        if (rb != hi) {
          colblend(hi, tb);
          rb = hi;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          res.v[i] = egm::from_f32<T>(__fadd_rn(__fmul_rn(a0, ta[i]), __fmul_rn(a1, tb[i])));
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) res.v[i] = egm::from_f32<T>(__fmul_rn(a0, ta[i]));
      }
      ob[((p0 + p) * W2 + q0 + q) * CV + v] = res;
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, void* out, const int* i0, const int* i1, const float* f0,
           const float* f1, const int* j0, const int* j1, const float* g0, const float* g1,
           int B, int h, int w, int C, int bq, cudaStream_t stream) {
  auto kern = upsample2x_band_kernel<T, VEC>;
  const int smem = smem_bytes(bq, C, (int)sizeof(T));
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess)
    return (int)cudaErrorInvalidValue;
  dim3 grid((2 * w + bq - 1) / bq, (2 * h + BR - 1) / BR, B);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), i0, i1, f0,
                                   f1, j0, j1, g0, g1, h, w, C, bq);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, void* out, const void* rlo, const void* rhi, const void* rwl,
        const void* rwh, const void* clo, const void* chi, const void* cwl, const void* cwh,
        int B, int h, int w, int C, int bq, int vec, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  if ((long long)B * h * w * C == 0) return (int)cudaSuccess;
  if (bq < 1 || B > 65535 || (2LL * h + BR - 1) / BR > 65535 ||
      4LL * h * w * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int* i0 = static_cast<const int*>(rlo);
  const int* i1 = static_cast<const int*>(rhi);
  const float* f0 = static_cast<const float*>(rwl);
  const float* f1 = static_cast<const float*>(rwh);
  const int* j0 = static_cast<const int*>(clo);
  const int* j1 = static_cast<const int*>(chi);
  const float* g0 = static_cast<const float*>(cwl);
  const float* g1 = static_cast<const float*>(cwh);
  if (vec) {
    if (C % V != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch<T, V>(x, out, i0, i1, f0, f1, j0, j1, g0, g1, B, h, w, C, bq, stream);
  }
  return launch<T, 1>(x, out, i0, i1, f0, f1, j0, j1, g0, g1, B, h, w, C, bq, stream);
}

}  // namespace

// x [B,h,w,C], out [B,2h,2w,C], one dtype (0 float32, 1 bfloat16); row taps
// (length 2h) and column taps (length 2w) as int32 indices and float32
// weights, the row weights already rounded to the working dtype.  bq output
// columns per strip; vec 1 the 16-byte variant (C a multiple of 16 bytes, x
// and out 16-byte aligned, else cudaErrorInvalidValue), 0 the scalar one.
extern "C" int egm_upsample2x(const void* x, void* out, const void* rlo, const void* rhi,
                              const void* rwl, const void* rwh, const void* clo,
                              const void* chi, const void* cwl, const void* cwh, int B,
                              int h, int w, int C, int bq, int vec, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egm::kFloat32)
    return run<float>(x, out, rlo, rhi, rwl, rwh, clo, chi, cwl, cwh, B, h, w, C, bq, vec, s);
  if (dtype == egm::kBFloat16)
    return run<__nv_bfloat16>(x, out, rlo, rhi, rwl, rwh, clo, chi, cwl, cwh, B, h, w, C, bq,
                              vec, s);
  return (int)cudaErrorInvalidValue;
}
