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
// is read from that shared-memory tile.  One block loops over all of Co, so
// conv1 is computed once per tile, not once per output-channel tile.
//
// Two kernels, chosen by dtype (ops/cuda/conv3x3.py::pair_variant):
//
// - bfloat16, "mma_bf16" (pair_mma_kernel): both GEMMs run on the tensor cores
//   (mma.sync m16n8k16, bf16 operands, float32 accumulators; bf16 products are
//   exact in float32, so only the order of the sums differs from the plain
//   version).  Both stages are the implicit-GEMM stage of igemm_mma.cuh,
//   shared with K2 (conv3x3.cu) and K5 (up_concat_conv.cu): eight warps, 4
//   along M x 2 along N, walk N in chunks of BN (32, 64 or 128 per stage; a
//   warp's tile is up to 48 x 64, which is what keeps the shared-memory
//   traffic per product down) and K in steps of 16 channels x all nine taps,
//   A gathered by ldmatrix row addresses.  Stage 1 gathers from a 16-channel
//   chunk of the (TH+4)(TW+4) input halo, whose zero fill is conv1's zero
//   padding; stage 2 gathers straight from the intermediate, whose row pitch
//   is 16*m + 8 elements and whose pad channels are written as zeros.
//   Who copies depends on the tile.  The wide sites' tiles (16x16, and 8x16
//   with 128-column chunks) are filled by the TMA unit: thread 0 starts one
//   tensor-map copy for the input-halo chunk (a [B, H, W, C] map, box 16
//   channels x the halo, 32-byte swizzle; what lies outside the image arrives
//   as zeros) and one per 64 weight columns (a [9, Cin, N] map, box 64 x 16 x
//   9, 128-byte swizzle), and an mbarrier per ring slot says when they have
//   landed.  By cp.async the same loads cost every thread up to eleven copy
//   instructions a step, a large part of the widest site's time.  These tiles need
//   every channel count a multiple of 8 and 16-byte aligned tensors.  The other
//   tiles (resident weights, and 8x8 and down) use 16-byte cp.async into padded
//   tiles, or scalar loaders where a channel count is off the 16-byte grid (the
//   stem's C = 3, odd Cm or Co).  Epilogues add the bias and apply the ReLU on the accumulator
//   fragments; stage 1 packs two bf16 values per 32-bit shared store, stage 2
//   per 32-bit global store.
//   Where every weight tile of both stages fits in shared memory beside the
//   rest (the 32-wide stem and up4: 18 and 69 KB), the weights are loaded once
//   and stay resident, the grid is as many blocks as the card holds at once,
//   and each block walks many tiles: a 128-pixel tile would otherwise re-read
//   all weights from L2 for 4 MFLOP of work, and that traffic, not the
//   tensor cores, set those sites' time.
// - float32, "cuda_cores_f32" (conv3x3_pair_kernel): 64 x BN sub-tiles with K
//   staged in chunks of 16 as float32, each thread holding a 4 x (BN/16)
//   register tile on the CUDA cores (the scheme of common.cuh).  It holds
//   1e-4 relative, which TF32 would not.
//
// The intermediate needs (TH+2)(TW+2) rows of shared memory, so the host
// picks the tile by the widths, the alignment and the dtype
// (ops/cuda/conv3x3.py::pair_tile).  bfloat16: 8x16 with resident weights
// where they fit; else 16x16 while the intermediate fits (Cm <= 128 or so),
// 8x16 (both only on the 16-byte grid), 8x8, 4x4, 2x2.  float32: 8x16
// while it fits the 227 KB a block may opt into, then 8x8, 4x4, 2x2.
// Smaller tiles spend more of stage 1 on the halo and re-read the weights
// more often: (TH+2)(TW+2)/(TH*TW) is 1.27 at 16x16, 1.41 at 8x16, 1.56 at
// 8x8, 2.25 at 4x4, 4 at 2x2.
//
// Bound: at the path's widths the work is far above the card's bf16 ridge,
// so the tensor-core rate bounds it (the stem and up4, 32 wide at 576x768,
// sit near the ridge).  The kernel recomputes conv1 on the halo and pads M
// to 16, N to BN and each tap's channels to 16 (the stem's C = 3 runs nine
// 16-deep products where flattening (tap, c) would need two); mma.sync
// itself tops out at 630-650 TFLOP/s on an H100 (probe/mma_sync_peak.cu),
// below the wgmma rate.  See
// PERF.md for what it reaches.  Any C, Cm, Co and any H, W: ragged tiles are
// masked.
#include "common.cuh"
#include "igemm_mma.cuh"

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

// ---------------------------------------------------------------- bf16, mma.sync

namespace tc {

using egm::igemm::bf16;
using egm::igemm::CC;
using egm::igemm::NT;
using egm::igemm::WROWS;
using egm::igemm::aligned16;
using egm::igemm::gemm_stage;
using egm::igemm::load_weights;
using egm::igemm::map_hwio;
using egm::igemm::map_nhwc;
using egm::igemm::opt_in_smem;
using egm::igemm::persistent_blocks;
using egm::igemm::resident_elems;
using egm::igemm::round_up;
using egm::igemm::Ring;
using egm::igemm::Slots;
using egm::igemm::SrcBuf;
using egm::igemm::SrcHalo;
using egm::igemm::StageIn;
using egm::mma::smem_addr;

struct Flags {
  int vec_x, vec_w1, vec_w2;  // 16-byte copies are possible for x, w1, w2
};

// The shared-memory layout, shared by the kernel and the launch: the
// intermediate [P1][mid_pitch], then R ring slots (igemm_mma.cuh::Slots, for
// the wider column chunk), each the input-halo chunk followed by the weight
// tile.  WRES (the weights stay resident): the slots hold the input-halo chunk
// only, and behind the ring lie all weight tiles of stage 1, then of stage 2,
// in step order.  TMA: the ring starts on a multiple of 1024 bytes.
template <int TH, int TW, int BN1, int BN2, bool WRES, bool TMA>
struct Layout {
  static constexpr int PW = TW + 2, P1 = (TH + 2) * PW, P2 = TH * TW;
  static constexpr int PWX = TW + 4, NPX = (TH + 4) * PWX;
  static constexpr int BNMAX = BN1 > BN2 ? BN1 : BN2;
  using S = Slots<NPX, BNMAX, WRES, TMA>;
  static constexpr int XBUF = S::XBUF, SLOT = S::SLOT, R = S::R;
  __host__ __device__ static int mid_pitch(int Cm) { return round_up(Cm, 16) + 8; }
  // elements of the resident weight tiles of a stage Cin -> N walked in BN columns
  __host__ __device__ static int resident(int Cin, int N, int BN) {
    return resident_elems((Cin + CC - 1) / CC, N, BN);
  }
  __host__ static size_t bytes(int C, int Cm, int Co) {
    size_t n = (size_t)P1 * mid_pitch(Cm) + R * SLOT;
    if (WRES) n += resident(C, Cm, BN1) + resident(Cm, Co, BN2);
    return sizeof(bf16) * n + (TMA ? 1024 : 0);
  }
};

// One block walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ... of the
// tiles_x * tiles_y * B tiles (x fastest, so blocks that run together share
// their halos in L2).  Without resident weights the grid has one block per
// tile; with them it has as many blocks as the card holds at once.
//
// TMA (no resident weights, every channel count a multiple of 8, 16-byte
// aligned tensors): thread 0 hands each step's input-halo chunk and weight
// boxes to the copy unit as tensor-map copies, whose zero fill out of bounds
// is the zero padding, the channel tail and the column tail at once; an
// mbarrier per slot says when they have landed.  By cp.async the same loads
// cost every thread up to eleven copy instructions a step.
template <int TH, int TW, int BN1, int BN2, bool WRES, bool TMA>
__global__ void __launch_bounds__(NT)
pair_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const float* __restrict__ b2, bf16* __restrict__ out, int H, int W, int C,
                int Cm, int Co, int tiles_x, int tiles_y, int tiles, Flags fl,
                const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w1,
                const __grid_constant__ CUtensorMap map_w2) {
  using L = Layout<TH, TW, BN1, BN2, WRES, TMA>;
  constexpr int WN = 2, WM = 8 / WN;  // warps along N and along M
  constexpr int PW = L::PW, P1 = L::P1, P2 = L::P2, PWX = L::PWX;
  constexpr int MB1 = (P1 + 15) / 16, MB2 = (P2 + 15) / 16;
  constexpr int MW1 = (MB1 + WM - 1) / WM, MW2 = (MB2 + WM - 1) / WM;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int MP = L::mid_pitch(Cm);
  bf16* mid = reinterpret_cast<bf16*>(smem_tc);  // [P1][MP]
  bf16* slots = mid + P1 * MP;                   // [R] slots
  if constexpr (TMA) slots += ((1024u - (smem_addr(slots) & 1023u)) & 1023u) / 2;
  bf16* w1res = slots + L::R * L::SLOT;           // WRES: stage 1's weight tiles
  bf16* w2res = w1res + L::resident(C, Cm, BN1);  // WRES: stage 2's
  __shared__ __align__(8) unsigned long long bars[L::R];
  Ring ring{slots, bars, 0};
  if constexpr (TMA) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < L::R; ++i) egm::mma::mbarrier_init(smem_addr(&bars[i]), 1);
      egm::mma::fence_async_proxy();
    }
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  // the row of an m-block this lane addresses for ldmatrix (mma.cuh)
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);

  if constexpr (WRES) {  // one cp.async group, older than every step's
    bf16* dst = w1res;
    for (int n0 = 0; n0 < Cm; n0 += BN1)
      for (int cc = 0; cc * CC < C; ++cc, dst += WROWS * (BN1 + 8))
        load_weights<BN1>(dst, w1, C, Cm, n0, cc * CC, C - cc * CC, fl.vec_w1);
    for (int n0 = 0; n0 < Co; n0 += BN2)
      for (int cc = 0; cc * CC < Cm; ++cc, dst += WROWS * (BN2 + 8))
        load_weights<BN2>(dst, w2, Cm, Co, n0, cc * CC, Cm - cc * CC, fl.vec_w2);
    egm::mma::cp_async_commit();
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (tiles_x * tiles_y);
    const int y0 = (tile / tiles_x) % tiles_y * TH, x0 = tile % tiles_x * TW;
    const bf16* xb = x + (long long)b * H * W * C;

    // stage 1: mid[p, :] = relu(conv1(x) + b1) at halo position p, 0 outside
    // the image and in the pad channels
    {
      int a_row[MW1];
#pragma unroll
      for (int i = 0; i < MW1; ++i) {
        const int p = (wm * MW1 + i) * 16 + lrow;
        a_row[i] = p < P1 ? (p / PW) * PWX + p % PW : 0;  // rows past P1 are discarded
      }
      const int mid_cols = MP - 8;
      auto epi = [&](int nw, float (&acc)[MW1][BN1 / WN / 8][4]) {
#pragma unroll
        for (int i = 0; i < MW1; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = (wm * MW1 + i) * 16 + g + 8 * r;
            if (wm * MW1 + i >= MB1 || p >= P1) continue;
            const int yy = y0 - 1 + p / PW, xx = x0 - 1 + p % PW;
            const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
            for (int j = 0; j < BN1 / WN / 8; ++j) {
              const int n = nw + j * 8 + t2;
              if (n >= mid_cols) continue;
              const float v0 = (inside && n < Cm) ? fmaxf(acc[i][j][2 * r] + b1[n], 0.f) : 0.f;
              const float v1 =
                  (inside && n + 1 < Cm) ? fmaxf(acc[i][j][2 * r + 1] + b1[n + 1], 0.f) : 0.f;
              *reinterpret_cast<uint32_t*>(mid + p * MP + n) = egm::mma::pack_bf16(v0, v1);
            }
          }
      };
      const StageIn in{w1, C, Cm, 0, Cm, (bool)fl.vec_w1, w1res, &map_w1};
      const SrcHalo<L::NPX, PWX, TMA> src{xb, H, W, C, y0 - 2, x0 - 2, b, (bool)fl.vec_x, &map_x};
      gemm_stage<MB1, BN1, WN, L::R, WRES, TMA, L::SLOT, L::XBUF>(in, src, ring, a_row, epi);
    }

    // stage 2: out = relu(conv2(mid) + b2) on the tile's pixels inside the image
    {
      int a_row[MW2];
#pragma unroll
      for (int i = 0; i < MW2; ++i) {
        const int m = (wm * MW2 + i) * 16 + lrow;
        a_row[i] = m < P2 ? (m / TW) * PW + m % TW : 0;
      }
      const bool pairs = (Co & 1) == 0;  // 4-byte stores stay aligned
      auto epi = [&](int nw, float (&acc)[MW2][BN2 / WN / 8][4]) {
#pragma unroll
        for (int i = 0; i < MW2; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int m = (wm * MW2 + i) * 16 + g + 8 * r;
            if (wm * MW2 + i >= MB2 || m >= P2) continue;
            const int oy = y0 + m / TW, ox = x0 + m % TW;
            if (oy >= H || ox >= W) continue;
            bf16* row = out + (((long long)b * H + oy) * W + ox) * Co;
#pragma unroll
            for (int j = 0; j < BN2 / WN / 8; ++j) {
              const int n = nw + j * 8 + t2;
              if (n >= Co) continue;
              const float v0 = fmaxf(acc[i][j][2 * r] + b2[n], 0.f);
              if (n + 1 < Co) {
                const float v1 = fmaxf(acc[i][j][2 * r + 1] + b2[n + 1], 0.f);
                if (pairs) {
                  *reinterpret_cast<uint32_t*>(row + n) = egm::mma::pack_bf16(v0, v1);
                  continue;
                }
                row[n + 1] = __float2bfloat16_rn(v1);
              }
              row[n] = __float2bfloat16_rn(v0);
            }
          }
      };
      const StageIn in{w2, Cm, Co, 0, Co, (bool)fl.vec_w2, w2res, &map_w2};
      const SrcBuf<PW> src{mid, MP, Cm};
      gemm_stage<MB2, BN2, WN, L::R, WRES, TMA, L::SLOT, L::XBUF>(in, src, ring, a_row, epi);
    }
  }
}

template <int TH, int TW, int BN1, int BN2, bool WRES, bool TMA>
int launch(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
           void* out, int B, int H, int W, int C, int Cm, int Co, Flags fl,
           cudaStream_t stream) {
  using L = Layout<TH, TW, BN1, BN2, WRES, TMA>;
  const size_t smem = L::bytes(C, Cm, Co);
  auto kernel = pair_mma_kernel<TH, TW, BN1, BN2, WRES, TMA>;
  cudaError_t err = opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long tiles = (long long)tiles_x * tiles_y * B;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  long long blocks = tiles;
  if (WRES) {  // as many blocks as run at once
    err = persistent_blocks(kernel, smem, tiles, &blocks);
    if (err != cudaSuccess) return (int)err;
  }
  CUtensorMap maps[3] = {};  // x [B][H][W][C]; w1 [9][C][Cm]; w2 [9][Cm][Co]
  if (TMA && !(map_nhwc(&maps[0], x, B, H, W, C, TW + 4, TH + 4) &&
               map_hwio(&maps[1], w1, C, Cm) && map_hwio(&maps[2], w2, Cm, Co)))
    return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2), b2, static_cast<bf16*>(out), H, W, C, Cm, Co, tiles_x,
      tiles_y, (int)tiles, fl, maps[0], maps[1], maps[2]);
  return (int)cudaGetLastError();
}

int run(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
        void* out, int B, int H, int W, int C, int Cm, int Co, int th, int tw, int bn1,
        int bn2, int resident, cudaStream_t s) {
  const Flags fl{C % 8 == 0 && aligned16(x), Cm % 8 == 0 && aligned16(w1),
                 Co % 8 == 0 && aligned16(w2)};
  const bool all_vec = fl.vec_x && fl.vec_w1 && fl.vec_w2;
  // the 16x16 tile and the 8x16 tile with 128-column chunks are served by the
  // copy unit alone, so they need everything on the 16-byte grid; the host
  // asks for another tile otherwise
#define EGM_PAIR_TC_CASE(TH_, TW_, BN1_, BN2_, WRES_, TMA_)                              \
  if (th == TH_ && tw == TW_ && bn1 == BN1_ && bn2 == BN2_ && (resident != 0) == WRES_ && \
      (!TMA_ || all_vec))                                                                 \
    return launch<TH_, TW_, BN1_, BN2_, WRES_, TMA_>(x, w1, b1, w2, b2, out, B, H, W, C, Cm,  \
                                                     Co, fl, s);
  EGM_PAIR_TC_CASE(8, 16, 32, 32, true, false)
  EGM_PAIR_TC_CASE(8, 16, 64, 32, true, false)
  EGM_PAIR_TC_CASE(8, 16, 64, 64, true, false)
  EGM_PAIR_TC_CASE(8, 16, 128, 64, false, true)
  EGM_PAIR_TC_CASE(8, 16, 128, 128, false, true)
  EGM_PAIR_TC_CASE(16, 16, 64, 32, false, true)
  EGM_PAIR_TC_CASE(16, 16, 64, 64, false, true)
  EGM_PAIR_TC_CASE(8, 8, 64, 64, false, false)
  EGM_PAIR_TC_CASE(4, 4, 64, 64, false, false)
  EGM_PAIR_TC_CASE(2, 2, 64, 64, false, false)
#undef EGM_PAIR_TC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------- float32 dispatch

int run_f32(const void* x, const void* w1, const float* b1p, const void* w2, const float* b2p,
            void* out, int B, int H, int W, int C, int Cm, int Co, int th, int tw, int bn,
            cudaStream_t s) {
  using T = float;
  const T* xp = static_cast<const T*>(x);
  const T* w1p = static_cast<const T*>(w1);
  const T* w2p = static_cast<const T*>(w2);
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
// 1 bfloat16).  (th, tw) is the pixel tile and (bn1, bn2) the column chunk of
// the two stages, picked by the host (ops/cuda/conv3x3.py::pair_tile) so that
// the intermediate fits shared memory: float32 takes (8,16), (8,8), (4,4) or
// (2,2) with bn1 = bn2 = 64, or (8,16) with 32; bfloat16 takes (8,16) with
// (128,64) or (128,128) or (16,16) with (64,32) or (64,64), which the copy
// unit serves and which therefore need C, Cm, Co % 8 == 0 and x, w1, w2 on
// 16-byte boundaries, or a smaller tile with (64,64).  resident (bfloat16
// only, (8,16) with (32,32), (64,32) or (64,64)): all weights stay in shared
// memory and a block walks many tiles.
extern "C" int egm_conv3x3_pair(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out, int B, int H,
                                int W, int C, int Cm, int Co, int th, int tw, int bn1,
                                int bn2, int resident, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || Cm < 1 || Co < 1)
    return (int)cudaErrorInvalidValue;
  const float* b1p = static_cast<const float*>(b1);
  const float* b2p = static_cast<const float*>(b2);
  if (dtype == egm::kFloat32 && bn1 == bn2 && !resident)
    return run_f32(x, w1, b1p, w2, b2p, out, B, H, W, C, Cm, Co, th, tw, bn1, s);
  if (dtype == egm::kBFloat16)
    return tc::run(x, w1, b1p, w2, b2p, out, B, H, W, C, Cm, Co, th, tw, bn1, bn2, resident,
                   s);
  return (int)cudaErrorInvalidValue;
}
