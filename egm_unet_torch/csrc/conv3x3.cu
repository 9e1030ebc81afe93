// 3x3 / stride 1 / pad 1 convolution + optional bias + optional ReLU, NHWC x
// HWIO, float32 accumulation: the folded ConvBNReLU / BasicConv conv.
//
// Replaces the TPU kernel egm_unet_tpu/ops/pallas/conv3x3.py::conv3x3_gemm
// (body _kernel).  That kernel im2cols the dy taps of a pre-padded row slab
// in VMEM and combines the dx taps after the GEMM with f32 rolls, and pads
// C and Co to 128 lanes; all three are Mosaic workarounds with no use here.
//
// On the H100 this is an implicit GEMM, M = B*H*W pixels, N = Co,
// K = 9*C (common.cuh): each block owns a tile of output pixels x output
// channels and runs the K loop over the 9 taps x C in shared-memory chunks.
// Zero padding comes from bounds checks on the input coordinates, so no
// padded copy is written, and any C works (C = 3 for the stem conv).
//
// Bound: at the path's widths (C, Co >= 32) the work is well above the
// card's bf16 ridge (~295 FLOP/byte), so the tensor-core rate bounds it;
// this first version multiplies on the CUDA cores in float32 and so runs far
// from that bound.  Moving the inner product to wgmma/mma.sync is the next
// step for this kernel.
#include "common.cuh"

namespace {

template <typename T>
struct Conv3x3Loader {
  const T* __restrict__ x;
  int H, W, C;
  __device__ __forceinline__ float operator()(int b, int y, int xx, int c) const {
    return egm::to_f32(x[(((long long)b * H + y) * W + xx) * C + c]);
  }
};

template <typename T>
int run(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
        int C, int Co, int relu, cudaStream_t stream) {
  Conv3x3Loader<T> ld{static_cast<const T*>(x), H, W, C};
  return egm::launch_igemm3x3<T>(ld, static_cast<const T*>(w),
                                 static_cast<const float*>(bias), static_cast<T*>(out), B,
                                 H, W, C, Co, relu, stream);
}

}  // namespace

// x [B,H,W,C], w [3,3,C,Co], bias float32 [Co] or null, out [B,H,W,Co];
// x, w and out share the dtype `dtype` (0 float32, 1 bfloat16).
extern "C" int egm_conv3x3(const void* x, const void* w, const void* bias, void* out,
                           int B, int H, int W, int C, int Co, int relu, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egm::kFloat32) return run<float>(x, w, bias, out, B, H, W, C, Co, relu, s);
  if (dtype == egm::kBFloat16)
    return run<__nv_bfloat16>(x, w, bias, out, B, H, W, C, Co, relu, s);
  return (int)cudaErrorInvalidValue;
}
