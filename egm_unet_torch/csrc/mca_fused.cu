// Fused MCALayer enhancement (module "C"), NHWC, in one pass after the gate
// vectors:
//
//   x_out = x * (g_h + g_w + g_c) / 3            rounded to the working dtype
//   out   = 0.4 x_out + 0.2 (max3 - min3)(x_out) + 0.2 avg3((x_out - avg3 x_out)^2)
//         + 0.1 (1.1 x_out) + 0.1 shuffle_g(x_out)
//
// 3x3 windows, stride 1.  max/min ignore positions outside the image (the
// +-inf padding of the pools), avg divides by 9 with zeros outside
// (count_include_pad), and the variance chain only sums positions inside
// the image, as egm_unet_tpu/ops/pallas/mca.py:93-101 masks them.
//
// Replaces the TPU kernel egm_unet_tpu/ops/pallas/mca.py::mca_fused (body
// _mca_kernel).  That kernel streams (tile_h+4)-row slabs of a gated,
// pre-padded copy of x through VMEM with double-buffered DMAs and does the
// shuffle as a permutation matmul; here the gating happens in the load, no
// padded copy exists, and the shuffle is a direct read.
//
// Bound: ~40 flops per element against 2 bytes read and 2 written (bf16),
// so device-memory bandwidth bounds it.  Each block stages a
// (TH+4) x (TW+4) halo tile of x_out for CC channels in shared memory,
// forms the 3x3 means and the masked squared deviations there, and writes
// the TH x TW output tile once; x is read about (TH+4)(TW+4)/(TH*TW) times,
// mostly from L2.  The shuffle term reads channel (j % g)*(C/g) + j/g of the
// centre pixel straight from x and gates it again.
#include "common.cuh"

namespace {

constexpr int TH = 8, TW = 8, CC = 32, NT = 256;
constexpr int HH = TH + 4, HW = TW + 4;  // x_out halo tile
constexpr int DH = TH + 2, DW = TW + 2;  // squared-deviation tile

template <typename T>
__device__ __forceinline__ float gated(const T* __restrict__ x, const float* __restrict__ gh,
                                       const float* __restrict__ gw,
                                       const float* __restrict__ gc, int b, int y, int xx,
                                       int c, int H, int W, int C) {
  const float g = (gh[b * H + y] + gw[b * W + xx] + gc[b * C + c]) / 3.0f;
  const float v = egm::to_f32(x[(((long long)b * H + y) * W + xx) * C + c]);
  return egm::round_to<T>(__fmul_rn(v, g));
}

template <typename T>
__global__ void __launch_bounds__(NT)
mca_fused_kernel(const T* __restrict__ x, const float* __restrict__ gh,
                 const float* __restrict__ gw, const float* __restrict__ gc,
                 T* __restrict__ out, int H, int W, int C, int groups, int cchunks) {
  __shared__ float xo[HH * HW][CC];
  __shared__ float d2[DH * DW][CC];

  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int b = blockIdx.z / cchunks;
  const int c0 = (blockIdx.z % cchunks) * CC;

  // 1. gated x_out over the halo tile, zero outside the image
  for (int e = tid; e < HH * HW * CC; e += NT) {
    const int cl = e % CC, p = e / CC;
    const int y = h0 + p / HW - 2, xx = w0 + p % HW - 2, c = c0 + cl;
    float v = 0.f;
    if (y >= 0 && y < H && xx >= 0 && xx < W && c < C)
      v = gated(x, gh, gw, gc, b, y, xx, c, H, W, C);
    xo[p][cl] = v;
  }
  __syncthreads();

  // 2. squared deviation from the 3x3 mean, zero outside the image
  for (int e = tid; e < DH * DW * CC; e += NT) {
    const int cl = e % CC, q = e / CC;
    const int qy = q / DW, qx = q % DW;
    const int y = h0 + qy - 1, xx = w0 + qx - 1;
    float v = 0.f;
    if (y >= 0 && y < H && xx >= 0 && xx < W) {
      float s = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) s = __fadd_rn(s, xo[(qy + di) * HW + qx + dj][cl]);
      const float d = __fsub_rn(xo[(qy + 1) * HW + qx + 1][cl], s / 9.0f);
      v = __fmul_rn(d, d);
    }
    d2[q][cl] = v;
  }
  __syncthreads();

  // 3. combine
  const int cg = C / groups;
  for (int e = tid; e < TH * TW * CC; e += NT) {
    const int cl = e % CC, p = e / CC;
    const int py = p / TW, px = p % TW;
    const int y = h0 + py, xx = w0 + px, c = c0 + cl;
    if (y >= H || xx >= W || c >= C) continue;
    const float xi = xo[(py + 2) * HW + px + 2][cl];
    float mx = xi, mn = xi, var = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        var = __fadd_rn(var, d2[(py + di) * DW + px + dj][cl]);
        const int yy = y + di - 1, xq = xx + dj - 1;
        if (yy >= 0 && yy < H && xq >= 0 && xq < W) {
          const float v = xo[(py + 1 + di) * HW + px + 1 + dj][cl];
          mx = fmaxf(mx, v);
          mn = fminf(mn, v);
        }
      }
    }
    var = var / 9.0f;
    const int src = (c % groups) * cg + c / groups;
    const float sh = gated(x, gh, gw, gc, b, y, xx, src, H, W, C);
    float o = __fmul_rn(0.4f, xi);
    o = __fadd_rn(o, __fmul_rn(0.2f, __fsub_rn(mx, mn)));
    o = __fadd_rn(o, __fmul_rn(0.2f, var));
    o = __fadd_rn(o, __fmul_rn(0.1f, __fmul_rn(1.1f, xi)));
    o = __fadd_rn(o, __fmul_rn(0.1f, sh));
    out[(((long long)b * H + y) * W + xx) * C + c] = egm::from_f32<T>(o);
  }
}

template <typename T>
int run(const void* x, const float* gh, const float* gw, const float* gc, void* out,
        int B, int H, int W, int C, int groups, cudaStream_t stream) {
  const int cchunks = (C + CC - 1) / CC;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * cchunks);
  mca_fused_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(x), gh, gw, gc,
                                              static_cast<T*>(out), H, W, C, groups,
                                              cchunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B,H,W,C] (dtype 0 float32, 1 bfloat16); gates float32 [B,H], [B,W],
// [B,C] after the sigmoid; out like x.  C % groups == 0.
extern "C" int egm_mca_fused(const void* x, const void* gh, const void* gw, const void* gc,
                             void* out, int B, int H, int W, int C, int groups, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(gh);
  const float* w = static_cast<const float*>(gw);
  const float* c = static_cast<const float*>(gc);
  if (dtype == egm::kFloat32) return run<float>(x, h, w, c, out, B, H, W, C, groups, s);
  if (dtype == egm::kBFloat16)
    return run<__nv_bfloat16>(x, h, w, c, out, B, H, W, C, groups, s);
  return (int)cudaErrorInvalidValue;
}
