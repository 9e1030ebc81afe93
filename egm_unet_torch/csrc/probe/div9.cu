// K8's division by 9 (eafe_edge.cu, div9) against IEEE division
// (__fdiv_rn(s, 9.f)) on every float32 bit pattern, and what each costs on
// zero and on random dividends: IEEE division leaves its fast path where the
// dividend is zero or tiny, and a ReLU'd map's window sums are often zero.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o div9 egm_unet_torch/csrc/probe/div9.cu
//   ./div9
//
// Prints the number of bit patterns whose quotients differ (NaN against NaN
// counts as equal), the first few, and the ms of 64 divisions a thread over
// 2^24 dividends for both functions, zeros and random.  Not built by
// ops/cuda/build.py and not used by the package.
#include <cstdio>
#include <cstdint>

#include "../eafe_edge.cu"

__global__ void compare(unsigned long long* bad, unsigned int* first, uint32_t hi) {
  const uint32_t bits = (hi << 24) | (blockIdx.x * blockDim.x + threadIdx.x);
  const float s = __uint_as_float(bits);
  const float a = __fdiv_rn(s, 9.f), b = div9(s);
  const bool same = __float_as_uint(a) == __float_as_uint(b) || (a != a && b != b);
  if (!same) {
    const unsigned long long n = atomicAdd(bad, 1ull);
    if (n < 8) first[n] = bits;
  }
}

template <bool IEEE>
__global__ void timed(const float* x, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float s = x[i], acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < 64; ++k) {
    acc += IEEE ? __fdiv_rn(s, 9.f) : div9(s);
    s = __fmul_rn(s, 1.0000001f);
  }
  out[i] = acc;
}

int main() {
  unsigned long long* bad;
  unsigned int* first;
  cudaMalloc(&bad, sizeof(unsigned long long));
  cudaMalloc(&first, 8 * sizeof(unsigned int));
  cudaMemset(bad, 0, sizeof(unsigned long long));
  for (uint32_t hi = 0; hi < 256; ++hi) compare<<<(1 << 24) / 256, 256>>>(bad, first, hi);
  unsigned long long n = 0;
  unsigned int f[8] = {};
  cudaMemcpy(&n, bad, sizeof n, cudaMemcpyDeviceToHost);
  cudaMemcpy(f, first, sizeof f, cudaMemcpyDeviceToHost);
  printf("div9 vs __fdiv_rn: %llu of 2^32 bit patterns differ\n", n);
  for (unsigned long long i = 0; i < n && i < 8; ++i) printf("  differs at 0x%08x\n", f[i]);

  const int N = 1 << 24;
  float *x, *out;
  cudaMalloc(&x, N * sizeof(float));
  cudaMalloc(&out, N * sizeof(float));
  float* h = new float[N];
  uint32_t r = 12345;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < N; ++i) {
      r = r * 1664525u + 1013904223u;
      h[i] = pass == 0 ? 0.f : ((int)(r >> 8) - (1 << 23)) * 1e-4f;
    }
    cudaMemcpy(x, h, N * sizeof(float), cudaMemcpyHostToDevice);
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    for (int ieee = 0; ieee < 2; ++ieee) {
      float ms = 0.f;
      for (int rep = 0; rep < 3; ++rep) {
        cudaEventRecord(e0);
        if (ieee) timed<true><<<N / 256, 256>>>(x, out);
        else timed<false><<<N / 256, 256>>>(x, out);
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
        cudaEventElapsedTime(&ms, e0, e1);
      }
      printf("%s dividends, %s: %.3f ms\n", pass == 0 ? "zero" : "random",
             ieee ? "__fdiv_rn" : "div9", ms);
    }
  }
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
  return n == 0 ? 0 : 1;
}
