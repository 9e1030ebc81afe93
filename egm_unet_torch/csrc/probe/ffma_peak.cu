// What float32 FFMA reaches on the card when nothing else is in the way:
// every thread updates NACC independent accumulators (acc = acc * x + y) in a
// loop, no shared or device memory traffic.  The float32 kernels of this
// package (csa_attention.cu's csa_ffma_kernel, the float32 convolutions)
// multiply with this instruction, so this rate at the card's clocks under
// load, not the data sheet's 67 TFLOP/s (its boost clock), is their ceiling.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o ffma_peak egm_unet_torch/csrc/probe/ffma_peak.cu
//   ./ffma_peak
//
// Prints one line per configuration: TFLOP/s over all SMs.  Not built by
// ops/cuda/build.py and not used by the package.
#include <cstdio>

template <int NACC>
__global__ void __launch_bounds__(256) fma_chains(float* out, int iters, float x, float y) {
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = threadIdx.x * 1e-3f + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = fmaf(acc[i], x, y);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NACC; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the loop alive
}

template <int NACC>
void run(int sms, int warps_per_block, int blocks_per_sm) {
  const int blocks = sms * blocks_per_sm, threads = warps_per_block * 32, iters = 200000;
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  fma_chains<NACC><<<blocks, threads>>>(out, 1000, 0.999f, 1e-3f);  // warm up
  cudaEventRecord(e0);
  fma_chains<NACC><<<blocks, threads>>>(out, iters, 0.999f, 1e-3f);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double ffmas = (double)blocks * threads * iters * NACC;
  printf("accumulators %2d, warps/block %d, blocks/SM %d: %.3f ms, %.1f TFLOP/s\n", NACC,
         warps_per_block, blocks_per_sm, ms, 2.0 * ffmas / ms / 1e9);
  cudaFree(out);
}

int main() {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) != cudaSuccess || sms < 1) {
    fprintf(stderr, "no CUDA device\n");
    return 1;
  }
  run<8>(sms, 4, 2);   // eight warps an SM, as csa_ffma_kernel runs at hd 64
  run<16>(sms, 4, 2);
  run<16>(sms, 8, 2);
  run<32>(sms, 8, 1);
  return 0;
}
