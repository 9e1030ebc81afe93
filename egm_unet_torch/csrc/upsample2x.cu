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
// quarter of one read, so device-memory bandwidth bounds it.  One thread
// makes 16 bytes of one output pixel's channels (8 bf16 or 4 float32) from
// four 16-byte reads, which neighbouring outputs share through L1/L2; a
// channel count or a pointer off the 16-byte grid takes the scalar kernel.
// Any h, w, C.
#include "common.cuh"

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float blend2(float w_lo, float v_lo, float w_hi, float v_hi) {
  const float s = __fmul_rn(w_lo, v_lo);
  return w_hi != 0.f ? __fadd_rn(s, __fmul_rn(w_hi, v_hi)) : s;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out,
                  const int* __restrict__ rlo, const int* __restrict__ rhi,
                  const float* __restrict__ rwl, const float* __restrict__ rwh,
                  const int* __restrict__ clo, const int* __restrict__ chi,
                  const float* __restrict__ cwl, const float* __restrict__ cwh,
                  int B, int h, int w, int C) {
  using P = Pack<T, VEC>;
  const int CV = C / VEC;
  const int H2 = 2 * h, W2 = 2 * w;
  const long long total = (long long)B * H2 * W2 * CV;
  const long long step = (long long)gridDim.x * NT;
  for (long long idx = (long long)blockIdx.x * NT + threadIdx.x; idx < total; idx += step) {
    const int cv = (int)(idx % CV);
    long long r = idx / CV;
    const int q = (int)(r % W2);
    r /= W2;
    const int p = (int)(r % H2);
    const int b = (int)(r / H2);

    const int r0 = rlo[p], r1 = rhi[p], q0 = clo[q], q1 = chi[q];
    const float a0 = rwl[p], a1 = rwh[p], c0 = cwl[q], c1 = cwh[q];
    const T* base = x + (long long)b * h * w * C + (long long)cv * VEC;
    const P v00 = *reinterpret_cast<const P*>(base + ((long long)r0 * w + q0) * C);
    const P v01 = *reinterpret_cast<const P*>(base + ((long long)r0 * w + q1) * C);
    P res;
    if (a1 != 0.f) {
      const P v10 = *reinterpret_cast<const P*>(base + ((long long)r1 * w + q0) * C);
      const P v11 = *reinterpret_cast<const P*>(base + ((long long)r1 * w + q1) * C);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float t0 = egm::round_to<T>(
            blend2(c0, egm::to_f32(v00.v[i]), c1, egm::to_f32(v01.v[i])));
        const float t1 = egm::round_to<T>(
            blend2(c0, egm::to_f32(v10.v[i]), c1, egm::to_f32(v11.v[i])));
        res.v[i] = egm::from_f32<T>(__fadd_rn(__fmul_rn(a0, t0), __fmul_rn(a1, t1)));
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float t0 = egm::round_to<T>(
            blend2(c0, egm::to_f32(v00.v[i]), c1, egm::to_f32(v01.v[i])));
        res.v[i] = egm::from_f32<T>(__fmul_rn(a0, t0));
      }
    }
    *reinterpret_cast<P*>(out + (((long long)b * H2 + p) * W2 + q) * C +
                          (long long)cv * VEC) = res;
  }
}

template <typename T>
int run(const void* x, void* out, const void* rlo, const void* rhi, const void* rwl,
        const void* rwh, const void* clo, const void* chi, const void* cwl,
        const void* cwh, int B, int h, int w, int C, cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const bool wide = C % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long total = (long long)B * 2 * h * 2 * w * (wide ? C / VEC : C);
  if (total == 0) return (int)cudaSuccess;
  long long blocks = (total + NT - 1) / NT;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride loop covers the rest
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const int* i0 = static_cast<const int*>(rlo);
  const int* i1 = static_cast<const int*>(rhi);
  const float* f0 = static_cast<const float*>(rwl);
  const float* f1 = static_cast<const float*>(rwh);
  const int* j0 = static_cast<const int*>(clo);
  const int* j1 = static_cast<const int*>(chi);
  const float* g0 = static_cast<const float*>(cwl);
  const float* g1 = static_cast<const float*>(cwh);
  if (wide)
    upsample2x_kernel<T, VEC><<<(unsigned)blocks, NT, 0, stream>>>(
        xp, op, i0, i1, f0, f1, j0, j1, g0, g1, B, h, w, C);
  else
    upsample2x_kernel<T, 1><<<(unsigned)blocks, NT, 0, stream>>>(
        xp, op, i0, i1, f0, f1, j0, j1, g0, g1, B, h, w, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B,h,w,C], out [B,2h,2w,C], one dtype (0 float32, 1 bfloat16); row taps
// (length 2h) and column taps (length 2w) as int32 indices and float32
// weights, the row weights already rounded to the working dtype.
extern "C" int egm_upsample2x(const void* x, void* out, const void* rlo, const void* rhi,
                              const void* rwl, const void* rwh, const void* clo,
                              const void* chi, const void* cwl, const void* cwh, int B,
                              int h, int w, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egm::kFloat32)
    return run<float>(x, out, rlo, rhi, rwl, rwh, clo, chi, cwl, cwh, B, h, w, C, s);
  if (dtype == egm::kBFloat16)
    return run<__nv_bfloat16>(x, out, rlo, rhi, rwl, rwh, clo, chi, cwl, cwh, B, h, w, C,
                              s);
  return (int)cudaErrorInvalidValue;
}
