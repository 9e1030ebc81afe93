// What mma.sync.m16n8k16 (bf16 operands, float32 accumulators) reaches on the
// card when nothing else is in the way: every warp multiplies register
// fragments into NACC independent accumulators in a loop, no shared or device
// memory traffic.  The bf16 kernels of this package (conv3x3_pair.cu,
// csa_attention.cu) multiply with this instruction, so this rate, not the
// published tensor-core peak (which takes wgmma), is their ceiling.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o mma_sync_peak egm_unet_torch/csrc/probe/mma_sync_peak.cu
//   ./mma_sync_peak
//
// Prints one line per configuration: TFLOP/s over all SMs and nanoseconds per
// mma per SM.  Not built by ops/cuda/build.py and not used by the package.
#include <cstdio>

#include "../mma.cuh"

template <int NACC>
__global__ void __launch_bounds__(256) multiply(float* out, int iters) {
  float acc[NACC][4];
  for (int i = 0; i < NACC; ++i)
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x * 5u, b1 = 11u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) egm::mma::mma_bf16(acc[i], a, b0, b1);
  }
  float s = 0.f;
  for (int i = 0; i < NACC; ++i)
    for (int e = 0; e < 4; ++e) s += acc[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the loop alive
}

template <int NACC>
void run(int sms, int warps_per_block, int blocks_per_sm) {
  const int blocks = sms * blocks_per_sm, iters = 20000;
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * warps_per_block * 32);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  multiply<NACC><<<blocks, warps_per_block * 32>>>(out, 100);  // warm up
  cudaEventRecord(e0);
  multiply<NACC><<<blocks, warps_per_block * 32>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = (double)blocks * warps_per_block * iters * NACC;
  printf("accumulators %2d, warps/block %d, blocks/SM %d: %.3f ms, %.1f TFLOP/s, "
         "%.2f ns per mma per SM\n",
         NACC, warps_per_block, blocks_per_sm, ms, mmas * 4096 / ms / 1e9,
         ms * 1e6 / (mmas / sms));
  cudaFree(out);
}

int main() {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) != cudaSuccess || sms < 1) {
    fprintf(stderr, "no CUDA device\n");
    return 1;
  }
  run<16>(sms, 8, 1);
  run<16>(sms, 4, 2);
  run<8>(sms, 8, 1);
  run<4>(sms, 8, 1);
  run<16>(sms, 8, 2);
  return 0;
}
