// Shared pieces of the port's CUDA kernels: dtype conversion and the
// implicit-GEMM core of the two 3x3 convolutions (conv3x3.cu and
// up_concat_conv.cu).
//
// Layouts follow the JAX package: activations NHWC, conv kernels HWIO, so
// the HWIO kernel viewed as a row-major [9*C, Co] matrix is the GEMM's B
// operand with k = (dy*3 + dx)*C + c.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace egm {

// dtype codes shared with the Python wrappers
enum : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round a float32 value to the working dtype T and widen it back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// out[m, n] = act(sum_k A[m, k] * Wt[k, n] + bias[n]) for a 3x3 / stride 1 /
// pad 1 convolution: m = (b, y, x) runs over the B*H*W output pixels and
// k = (tap, c) over 9*Ct, tap = dy*3 + dx.  The Loader returns the conv
// input at (b, y + dy - 1, x + dx - 1, c); positions outside the image are
// the zero padding and never reach it.
//
// Block tile BM pixels x BN output channels, K in chunks of BK staged in
// shared memory as float32; each thread owns a TM x TN register tile and
// accumulates in float32 on the CUDA cores.  The k column a thread loads is
// fixed within a chunk, so its (tap, c) advance incrementally and each of its
// pixels is decoded once, before the K loop.
template <typename T, int BM, int BN, int TM, int TN, class Loader>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
igemm3x3_kernel(Loader ld, const T* __restrict__ wt, const float* __restrict__ bias,
                T* __restrict__ out, int B, int H, int W, int Ct, int Co, int relu) {
  constexpr int BK = 16;
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int A_LOADS = BM * BK / NT;
  constexpr int B_LOADS = (BN * BK + NT - 1) / NT;
  static_assert(NT % BK == 0, "thread count must be a multiple of BK");
  static_assert((BM * BK) % NT == 0, "A tile must split evenly");

  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Ct;

  // this thread's A loads: k column a_k, pixels a_m + i * (NT / BK)
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int pb[A_LOADS], py[A_LOADS], px[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    long long m = m0 + a_m + i * (NT / BK);
    if (m < M) {
      int b = (int)(m / ((long long)H * W));
      int r = (int)(m - (long long)b * H * W);
      pb[i] = b;
      py[i] = r / W;
      px[i] = r - (r / W) * W;
    } else {
      pb[i] = -1;
      py[i] = 0;
      px[i] = 0;
    }
  }
  int tap = a_k / Ct;
  int c = a_k - tap * Ct;

  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool kv = tap < 9;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      float v = 0.f;
      const int yy = py[i] + dy, xx = px[i] + dx;
      if (kv && pb[i] >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = ld(pb[i], yy, xx, c);
      As[a_k][a_m + i * (NT / BK)] = v;
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int e = tid + i * NT;
      if (e < BK * BN) {
        const int kl = e / BN, nl = e % BN;
        const int k = k0 + kl, n = n0 + nl;
        Bs[kl][nl] = (k < K && n < Co) ? to_f32(wt[(long long)k * Co + n]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kl = 0; kl < BK; ++kl) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kl][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kl][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    c += BK;
    while (c >= Ct) {
      c -= Ct;
      ++tap;
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= Co) continue;
      float v = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
      if (relu) v = fmaxf(v, 0.f);
      out[m * Co + n] = from_f32<T>(v);
    }
  }
}

// Picks the tile shape by output width (the narrow convs of the path have
// Co = 8..32) and launches on `stream`.  Returns cudaGetLastError().
template <typename T, class Loader>
int launch_igemm3x3(const Loader& ld, const T* wt, const float* bias, T* out, int B,
                    int H, int W, int Ct, int Co, int relu, cudaStream_t stream) {
  const long long M = (long long)B * H * W;
  if (Co <= 16) {
    dim3 grid((unsigned)((M + 127) / 128), (Co + 15) / 16);
    igemm3x3_kernel<T, 128, 16, 4, 2, Loader>
        <<<grid, 256, 0, stream>>>(ld, wt, bias, out, B, H, W, Ct, Co, relu);
  } else if (Co <= 32) {
    dim3 grid((unsigned)((M + 127) / 128), (Co + 31) / 32);
    igemm3x3_kernel<T, 128, 32, 4, 4, Loader>
        <<<grid, 256, 0, stream>>>(ld, wt, bias, out, B, H, W, Ct, Co, relu);
  } else {
    dim3 grid((unsigned)((M + 63) / 64), (Co + 63) / 64);
    igemm3x3_kernel<T, 64, 64, 4, 4, Loader>
        <<<grid, 256, 0, stream>>>(ld, wt, bias, out, B, H, W, Ct, Co, relu);
  }
  return (int)cudaGetLastError();
}

}  // namespace egm
