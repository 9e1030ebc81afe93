// Fused DoubleConv: out = relu(conv2(relu(conv1(x) + b1)) + b2), both convs
// 3x3 / stride 1 / pad 1, NHWC x HWIO, float32 accumulation, in one launch.
// The (B, H, W, Cm) output of conv1 never reaches device memory.
//
// Replaces the TPU kernel egm_unet_tpu/ops/pallas/conv3x3.py::conv3x3_pair_gemm
// (body _pair_kernel).  That kernel streams (rb+4)-row slabs of a pre-padded,
// lane-padded copy of x through VMEM, im2cols the dy taps and combines the dx
// taps with rolls; the padding, the slabs and the rolls are Mosaic devices.
// What carries over is what it computes: conv1 + bias + ReLU on the output
// tile and a one-pixel halo around it, rounded to the working dtype, set to
// ZERO where the halo position lies outside the image (there it is conv2's
// zero padding; conv1 evaluated there is not zero, it sees real pixels
// through its own window), then conv2 + bias + ReLU on the tile.
//
// Here one block owns a TH x TW tile of output pixels of one image and all of
// Co.  Stage 1 is an implicit GEMM, M = the (TH+2)(TW+2) halo positions,
// N = Cm, K = 9*C, whose result goes to shared memory in the working dtype;
// stage 2 is an implicit GEMM, M = TH*TW, N = Co, K = 9*Cm, whose A operand
// is read from that shared-memory tile.  Both run in 64 x BN sub-tiles with
// K staged in chunks of 16 as float32, each thread holding a 4 x (BN/16)
// register tile on the CUDA cores (the scheme of common.cuh).  One block
// loops over all of Co, so conv1 is computed once per tile, not once per
// output-channel tile.
//
// The intermediate needs (TH+2)(TW+2)*Cm elements of shared memory, so the
// host picks the tile by Cm and dtype (ops/cuda/conv3x3.py::pair_tile):
// 8x16 while it fits the 227 KB a block may opt into, then 8x8, 4x4, 2x2.
// Smaller tiles spend more of stage 1 on the halo: (TH+2)(TW+2)/(TH*TW) is
// 1.41 at 8x16, 1.56 at 8x8, 2.25 at 4x4, 4 at 2x2.  Sites whose Cm and Co
// are both <= 32 use BN = 32 so that half of each sub-tile is not padding.
//
// Bound: at the path's widths the work is far above the card's bf16 ridge,
// so the tensor-core rate bounds it; this first version multiplies on the
// CUDA cores in float32 and recomputes conv1 on the halo, and so runs far
// from that bound.  Any C, Cm, Co (C = 3 for the stem) and any H, W: ragged
// tiles are masked with bounds checks.
#include "common.cuh"

namespace {

constexpr int BM = 64, BK = 16, TM = 4, NT = 256;
constexpr int A_LOADS = BM * BK / NT;  // A rows a thread stages per K chunk
static_assert(A_LOADS == TM, "the loaders keep one row state per staged row");

__host__ __device__ constexpr size_t staging_bytes(int bn) {
  return sizeof(float) * BK * (BM + 4 + bn);
}

// acc += A[64 rows, K] * Wt[K, n0 .. n0+BN) for one 64 x BN sub-tile.  A(i,
// tap, c) is row a_m + 16*i of the sub-tile at k = tap*Ck + c (0 where that
// row or tap lies outside); Wt is row-major [9*Ck, N].
template <typename T, int BN, class ALoad>
__device__ __forceinline__ void block_gemm(const ALoad& A, const T* __restrict__ wt, int Ck,
                                           int N, int n0, float (*As)[BM + 4],
                                           float (*Bs)[BN], float (&acc)[TM][BN / 16]) {
  constexpr int TN = BN / 16;
  constexpr int B_LOADS = BK * BN / NT;
  const int tid = threadIdx.x;
  const int a_k = tid % BK, a_m = tid / BK;
  const int ty = tid / 16, tx = tid % 16;
  const int K = 9 * Ck;
  int tap = a_k / Ck;
  int c = a_k - tap * Ck;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i)
      As[a_k][a_m + i * (NT / BK)] = tap < 9 ? A(i, tap, c) : 0.f;
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int e = tid + i * NT;
      const int kl = e / BN, nl = e % BN;
      const int k = k0 + kl, n = n0 + nl;
      Bs[kl][nl] = (k < K && n < N) ? egm::to_f32(wt[(long long)k * N + n]) : 0.f;
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
    while (c >= Ck) {
      c -= Ck;
      ++tap;
    }
  }
}

// stage 1's A operand: x at the 3x3 window of a halo position
template <typename T>
struct XLoad {
  const T* __restrict__ xb;  // this image
  int H, W, C;
  int py[TM], px[TM];  // image coordinates of this thread's rows
  bool ok[TM];         // row is a halo position inside the image
  __device__ __forceinline__ float operator()(int i, int tap, int c) const {
    const int yy = py[i] + tap / 3 - 1, xx = px[i] + tap % 3 - 1;
    if (!ok[i] || yy < 0 || yy >= H || xx < 0 || xx >= W) return 0.f;
    return egm::to_f32(xb[((long long)yy * W + xx) * C + c]);
  }
};

// stage 2's A operand: the shared-memory intermediate at the 3x3 window of
// an output pixel; base is the window's top-left halo position, -1 for a row
// past the tile
template <typename T, int PW>
struct MidLoad {
  const T* mid;
  int Cm;
  int base[TM];
  __device__ __forceinline__ float operator()(int i, int tap, int c) const {
    if (base[i] < 0) return 0.f;
    return egm::to_f32(mid[(base[i] + (tap / 3) * PW + tap % 3) * Cm + c]);
  }
};

template <typename T, int TH, int TW, int BN>
__global__ void __launch_bounds__(NT)
conv3x3_pair_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                    const float* __restrict__ b1, const T* __restrict__ w2,
                    const float* __restrict__ b2, T* __restrict__ out, int H, int W, int C,
                    int Cm, int Co) {
  constexpr int TN = BN / 16;
  constexpr int PW = TW + 2;
  constexpr int P1 = (TH + 2) * PW;  // halo positions
  constexpr int P2 = TH * TW;        // output pixels
  extern __shared__ __align__(16) unsigned char smem[];
  float (*As)[BM + 4] = reinterpret_cast<float (*)[BM + 4]>(smem);
  float (*Bs)[BN] = reinterpret_cast<float (*)[BN]>(smem + sizeof(float) * BK * (BM + 4));
  T* mid = reinterpret_cast<T*>(smem + staging_bytes(BN));  // [P1][Cm]

  const int tid = threadIdx.x;
  const int a_m = tid / BK;
  const int ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  float acc[TM][TN];

  // stage 1: mid[p, :] = relu(conv1(x) + b1) at halo position p, 0 outside
  XLoad<T> xa;
  xa.xb = x + (long long)b * H * W * C;
  xa.H = H;
  xa.W = W;
  xa.C = C;
  for (int m0 = 0; m0 < P1; m0 += BM) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int p = m0 + a_m + i * (NT / BK);
      xa.py[i] = y0 - 1 + p / PW;
      xa.px[i] = x0 - 1 + p % PW;
      xa.ok[i] = p < P1 && xa.py[i] >= 0 && xa.py[i] < H && xa.px[i] >= 0 && xa.px[i] < W;
    }
    for (int n0 = 0; n0 < Cm; n0 += BN) {
      block_gemm<T, BN>(xa, w1, C, Cm, n0, As, Bs, acc);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int p = m0 + ty * TM + i;
        if (p >= P1) continue;
        const int yy = y0 - 1 + p / PW, xx = x0 - 1 + p % PW;
        const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + tx * TN + j;
          if (n >= Cm) continue;
          const float v = inside ? fmaxf(acc[i][j] + b1[n], 0.f) : 0.f;
          mid[p * Cm + n] = egm::from_f32<T>(v);
        }
      }
    }
  }
  __syncthreads();

  // stage 2: out = relu(conv2(mid) + b2) on the tile's pixels inside the image
  MidLoad<T, PW> ma;
  ma.mid = mid;
  ma.Cm = Cm;
  for (int m0 = 0; m0 < P2; m0 += BM) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + a_m + i * (NT / BK);
      ma.base[i] = m < P2 ? (m / TW) * PW + m % TW : -1;
    }
    for (int n0 = 0; n0 < Co; n0 += BN) {
      block_gemm<T, BN>(ma, w2, Cm, Co, n0, As, Bs, acc);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty * TM + i;
        if (m >= P2) continue;
        const int oy = y0 + m / TW, ox = x0 + m % TW;
        if (oy >= H || ox >= W) continue;
        T* row = out + (((long long)b * H + oy) * W + ox) * Co;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + tx * TN + j;
          if (n < Co) row[n] = egm::from_f32<T>(fmaxf(acc[i][j] + b2[n], 0.f));
        }
      }
    }
  }
}

template <typename T, int TH, int TW, int BN>
int launch(const T* x, const T* w1, const float* b1, const T* w2, const float* b2, T* out,
           int B, int H, int W, int C, int Cm, int Co, cudaStream_t stream) {
  const size_t smem =
      staging_bytes(BN) + sizeof(T) * (size_t)(TH + 2) * (TW + 2) * (size_t)Cm;
  auto kernel = conv3x3_pair_kernel<T, TH, TW, BN>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NT, smem, stream>>>(x, w1, b1, w2, b2, out, H, W, C, Cm, Co);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
        void* out, int B, int H, int W, int C, int Cm, int Co, int th, int tw, int bn,
        cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* w1p = static_cast<const T*>(w1);
  const T* w2p = static_cast<const T*>(w2);
  const float* b1p = static_cast<const float*>(b1);
  const float* b2p = static_cast<const float*>(b2);
  T* op = static_cast<T*>(out);
#define EGM_PAIR_CASE(TH_, TW_, BN_)             \
  if (th == TH_ && tw == TW_ && bn == BN_)       \
    return launch<T, TH_, TW_, BN_>(xp, w1p, b1p, w2p, b2p, op, B, H, W, C, Cm, Co, s);
  EGM_PAIR_CASE(8, 16, 32)
  EGM_PAIR_CASE(8, 16, 64)
  EGM_PAIR_CASE(8, 8, 64)
  EGM_PAIR_CASE(4, 4, 64)
  EGM_PAIR_CASE(2, 2, 64)
#undef EGM_PAIR_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [B,H,W,C], w1 [3,3,C,Cm], w2 [3,3,Cm,Co], b1 [Cm] and b2 [Co] float32,
// out [B,H,W,Co]; x, w1, w2 and out share the dtype `dtype` (0 float32,
// 1 bfloat16).  (th, tw, bn) is the tile: one of (8,16,32), (8,16,64),
// (8,8,64), (4,4,64), (2,2,64), picked by the host so that the intermediate
// fits shared memory.
extern "C" int egm_conv3x3_pair(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out, int B, int H,
                                int W, int C, int Cm, int Co, int th, int tw, int bn,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (dtype == egm::kFloat32)
    return run<float>(x, w1, b1, w2, b2, out, B, H, W, C, Cm, Co, th, tw, bn, s);
  if (dtype == egm::kBFloat16)
    return run<__nv_bfloat16>(x, w1, b1, w2, b2, out, B, H, W, C, Cm, Co, th, tw, bn, s);
  return (int)cudaErrorInvalidValue;
}
