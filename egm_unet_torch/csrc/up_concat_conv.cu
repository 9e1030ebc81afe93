// Fused decoder stage: relu(conv3x3(concat([x2, up2x(x1)], -1), W) + b), with
// up2x the bilinear align_corners=True 2x upsample.  NHWC x HWIO, float32
// accumulation.
//
// Replaces the TPU kernel egm_unet_tpu/ops/pallas/upconv.py::up_concat_conv
// (body _upconv_kernel).  That kernel upsamples each row tile with per-tile
// interpolation matmuls on the MXU before a nine-tap conv; the matmuls are a
// TPU device and do not carry over.
//
// Here the conv is the implicit GEMM of common.cuh with K = 9*(C2+C1), and
// the concat and the upsampled tensor are never stored: the loader reads
// channels [0, C2) from x2 and forms channels [C2, C2+C1) from the 2x2
// align_corners taps of x1.  The taps (lo, hi, w_lo, w_hi) per output row
// and column come from the host, taken from the same interpolation matrix as
// the plain version and rounded to the working dtype, and the blend rounds
// to the working dtype after the row pass and after the column pass, where
// the plain two-matmul upsample rounds.
//
// Bound: as conv3x3.cu, the tensor-core rate at these widths; this first
// version runs the products on the CUDA cores and recomputes each upsampled
// value once per conv tap, trading arithmetic for the upsampled tensor's
// write and read.
#include "common.cuh"

namespace {

template <typename T>
struct UpConcatLoader {
  const T* __restrict__ x2;  // [B, H, W, C2]
  const T* __restrict__ x1;  // [B, h, w, C1]
  const int* __restrict__ rlo;
  const int* __restrict__ rhi;
  const float* __restrict__ rwl;
  const float* __restrict__ rwh;
  const int* __restrict__ clo;
  const int* __restrict__ chi;
  const float* __restrict__ cwl;
  const float* __restrict__ cwh;
  int H, W, h, w, C2, C1;

  __device__ __forceinline__ float operator()(int b, int y, int xx, int c) const {
    if (c < C2) return egm::to_f32(x2[(((long long)b * H + y) * W + xx) * C2 + c]);
    const T* base = x1 + (long long)b * h * w * C1 + (c - C2);
    const int r0 = rlo[y], r1 = rhi[y], q0 = clo[xx], q1 = chi[xx];
    const float a0 = rwl[y], a1 = rwh[y];
    const float v00 = egm::to_f32(base[((long long)r0 * w + q0) * C1]);
    const float v10 = egm::to_f32(base[((long long)r1 * w + q0) * C1]);
    const float v01 = egm::to_f32(base[((long long)r0 * w + q1) * C1]);
    const float v11 = egm::to_f32(base[((long long)r1 * w + q1) * C1]);
    // row pass, rounded to the working dtype, then the column pass
    const float t0 = egm::round_to<T>(a0 * v00 + a1 * v10);
    const float t1 = egm::round_to<T>(a0 * v01 + a1 * v11);
    return egm::round_to<T>(cwl[xx] * t0 + cwh[xx] * t1);
  }
};

template <typename T>
int run(const void* x2, const void* x1, const void* w, const void* bias, void* out,
        const void* rlo, const void* rhi, const void* rwl, const void* rwh,
        const void* clo, const void* chi, const void* cwl, const void* cwh, int B,
        int h, int wd, int C1, int C2, int Co, cudaStream_t stream) {
  UpConcatLoader<T> ld{static_cast<const T*>(x2),     static_cast<const T*>(x1),
                       static_cast<const int*>(rlo),  static_cast<const int*>(rhi),
                       static_cast<const float*>(rwl), static_cast<const float*>(rwh),
                       static_cast<const int*>(clo),  static_cast<const int*>(chi),
                       static_cast<const float*>(cwl), static_cast<const float*>(cwh),
                       2 * h,
                       2 * wd,
                       h,
                       wd,
                       C2,
                       C1};
  return egm::launch_igemm3x3<T>(ld, static_cast<const T*>(w),
                                 static_cast<const float*>(bias), static_cast<T*>(out), B,
                                 2 * h, 2 * wd, C2 + C1, Co, /*relu=*/1, stream);
}

}  // namespace

// x2 [B,2h,2w,C2], x1 [B,h,w,C1], w [3,3,C2+C1,Co], bias float32 [Co],
// out [B,2h,2w,Co]; row taps (length 2h) and column taps (length 2w) as
// int32 indices and float32 weights.  dtype: 0 float32, 1 bfloat16.
extern "C" int egm_up_concat_conv(const void* x2, const void* x1, const void* w,
                                  const void* bias, void* out, const void* rlo,
                                  const void* rhi, const void* rwl, const void* rwh,
                                  const void* clo, const void* chi, const void* cwl,
                                  const void* cwh, int B, int h, int wd, int C1, int C2,
                                  int Co, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egm::kFloat32)
    return run<float>(x2, x1, w, bias, out, rlo, rhi, rwl, rwh, clo, chi, cwl, cwh, B, h,
                      wd, C1, C2, Co, s);
  if (dtype == egm::kBFloat16)
    return run<__nv_bfloat16>(x2, x1, w, bias, out, rlo, rhi, rwl, rwh, clo, chi, cwl, cwh,
                              B, h, wd, C1, C2, Co, s);
  return (int)cudaErrorInvalidValue;
}
