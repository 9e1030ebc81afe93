// Fused decoder stage: relu(conv3x3(concat([x2, up2x(x1)], -1), W) + b), with
// up2x the bilinear align_corners=True 2x upsample.  NHWC x HWIO, float32
// accumulation.
//
// Replaces the TPU kernel egm_unet_tpu/ops/pallas/upconv.py::up_concat_conv
// (body _upconv_kernel).  That kernel upsamples each row tile with per-tile
// interpolation matmuls on the MXU before a nine-tap conv; the matmuls are a
// TPU device and do not carry over.
//
// Here the conv is an implicit GEMM with K = 9*(C2+C1), and the concat and
// the upsampled tensor are never stored in device memory.  Channels [0, C2)
// come from x2; channels [C2, C2+C1) are blended from the 2x2 align_corners
// taps of x1.  The taps (lo, hi, w_lo, w_hi) per output row and column come
// from the host (ops/resize.py::upsample2x_taps), taken from the same
// interpolation matrix as the plain version and rounded to the working dtype,
// and the blend rounds to the working dtype after the row pass and after the
// column pass, where the plain two-matmul upsample rounds.
//
// Bound: the tensor-core rate at the path's widths (64 .. 512 input
// channels); up4 (32 + 32 -> 32 at 576x768) sits near the ridge, where the
// traffic bounds it.
//
// Two kernels, chosen by dtype (ops/cuda/upconv.py::upconv_variant):
//
// - bfloat16, "mma_bf16" (upconv_mma_kernel): the tensor-core implicit-GEMM
//   stage of igemm_mma.cuh, as K2 (conv3x3.cu) runs it, over a source that
//   walks K in 16-channel steps, first the x2 half, then the x1 half.  A block
//   owns an 8x16 tile of output pixels of one image and a chunk of BN output
//   columns.
//   * x2 steps are K2's steps: a 16-channel chunk of the 10x18 halo, zero
//     outside the image (the conv's padding), and weight rows [0, C2).
//   * x1 steps have a producer step before ldmatrix.  The ring slot holds the
//     16-channel chunk of the low-resolution patch of x1 that the tile's halo
//     needs (at most 7 x 11 pixels, each x1 value read from device memory
//     once per tile and chunk, where the first version's loader read four
//     taps per pixel, channel and conv tap: 36 reads per value).  Every
//     thread then blends (halo pixel, 8 channels) items from the patch into
//     one A grid in shared memory, zero where the halo lies outside the
//     output image (the conv pads the concat, not x1), and the block
//     synchronises before the products.  The blend's arithmetic and rounding
//     are the first version's: the row pass a0*v00 + a1*v10 rounded to bf16,
//     then the column pass, rounded again.  Weight rows are C2 + c.
//   * A channel count off the 16-grid pads each half's last chunk on its own.
//     Pad channels of A are zeros in both halves (the copies' zero fill), so
//     the weight rows they meet (real x1 weights in the x2 half's last chunk,
//     where the TMA box reads past C2) add nothing.
//   Who copies: with every channel count a multiple of 8 and 16-byte aligned
//   tensors the TMA unit brings both halves' chunks (x2 halo box and x1 patch
//   box, dense with the 32-byte swizzle; the blend writes its A grid in the
//   same layout) and the weight boxes; otherwise 16-byte cp.async, or scalar
//   loads off the 16-byte grid.  Where all weights fit beside the rest in half
//   an SM's shared memory (up4: 37 KB of weights) they stay resident and the
//   blocks are persistent, as K2's narrow sites have them.
// - float32, "cuda_cores_f32": common.cuh::igemm3x3_kernel on the CUDA cores,
//   whose loader blends the four taps from device memory per use.  It holds
//   1e-4 relative.
#include "common.cuh"
#include "igemm_mma.cuh"

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

// the tap tables of one upsample axis: output index -> x1 indices and weights
struct Taps {
  const int* lo;
  const int* hi;
  const float* wl;
  const float* wh;
};

int run_f32(const void* x2, const void* x1, const void* w, const float* bias, void* out,
            Taps rows, Taps cols, int B, int h, int wd, int C1, int C2, int Co,
            cudaStream_t stream) {
  using T = float;
  UpConcatLoader<T> ld{static_cast<const T*>(x2), static_cast<const T*>(x1),
                       rows.lo, rows.hi, rows.wl, rows.wh, cols.lo, cols.hi, cols.wl, cols.wh,
                       2 * h, 2 * wd, h, wd, C2, C1};
  return egm::launch_igemm3x3<T>(ld, static_cast<const T*>(w), bias, static_cast<T*>(out), B,
                                 2 * h, 2 * wd, C2 + C1, Co, /*relu=*/1, stream);
}

// ---------------------------------------------------------------- bf16, mma.sync

namespace tc {

using egm::igemm::bf16;
using egm::igemm::CC;
using egm::igemm::NT;
using egm::igemm::WROWS;
using egm::igemm::XP;
using egm::igemm::aligned16;
using egm::igemm::chunk_off;
using egm::igemm::gemm_stage;
using egm::igemm::load_weights;
using egm::igemm::load_x_chunk;
using egm::igemm::map_hwio;
using egm::igemm::map_nhwc;
using egm::igemm::opt_in_smem;
using egm::igemm::persistent_blocks;
using egm::igemm::resident_elems;
using egm::igemm::round_up;
using egm::igemm::Ring;
using egm::igemm::Slots;
using egm::igemm::StageIn;
using egm::mma::smem_addr;

// one output row's (or column's) taps, relative to the tile's x1 patch;
// lo < 0: the halo position lies outside the output image
struct Tap {
  int lo, hi;
  float wl, wh;
};

// The tile's x1 patch: an output window of n pixels along an axis needs at
// most n/2 + 2 x1 pixels (align_corners maps output i to i*(h-1)/(2h-1) <
// i/2, and each output pixel reads its floor and the next);
// tests/test_torch_conv_tiles.py checks it at every tile of many sizes.
__host__ __device__ constexpr int patch_extent(int n) { return n / 2 + 2; }

// The source of the K5 stage: ceil(C2/16) steps of x2's halo chunks, then
// ceil(C1/16) steps whose A grid is blended from a 16-channel chunk of x1's
// patch.  DENSE (TMA): the chunks and the A grid are dense 32-byte rows with
// the 32-byte swizzle; otherwise rows of XP elements.
template <int TH, int TW, bool TMA>
struct SrcUp {
  static constexpr bool LOADS = true, DENSE = TMA;
  static constexpr int PWA = TW + 2, NPX = (TH + 2) * PWA;
  static constexpr int PR = patch_extent(TH + 2), PC = patch_extent(TW + 2), NPATCH = PR * PC;
  static_assert(NPATCH <= NPX, "the patch fits the slot of a halo chunk");
  const bf16* x2b;  // this image of x2 [H][W][C2]
  const bf16* x1b;  // this image of x1 [h][w][C1]
  int H, W, h, w, C2, C1;
  int hy, hx;  // the halo's top-left pixel in the output image
  int r0, q0;  // the patch's top-left pixel in x1
  int b;       // TMA: the image's index
  bool vec2, vec1;
  const CUtensorMap* map2;  // TMA: x2 as [B][H][W][C2]
  const CUtensorMap* map1;  // TMA: x1 as [B][h][w][C1]
  bf16* abuf;               // the blended A grid
  const Tap* rtap;          // [TH + 2] halo rows
  const Tap* ctap;          // [TW + 2] halo columns

  __device__ int chunks2() const { return (C2 + CC - 1) / CC; }
  __device__ int chunks() const { return chunks2() + (C1 + CC - 1) / CC; }
  __device__ int pitch() const { return XP; }
  __device__ void wrow(int cc, int& base, int& lim) const {
    const int k2 = chunks2();
    base = cc < k2 ? cc * CC : C2 + (cc - k2) * CC;
    lim = cc < k2 ? C2 - cc * CC : C1 - (cc - k2) * CC;
  }
  __device__ int tma_elems(int cc) const { return (cc < chunks2() ? NPX : NPATCH) * CC; }
  __device__ void load_tma(bf16* slot, int cc, uint32_t bar) const {
    const int k2 = chunks2();
    if (cc < k2)
      egm::mma::tma_load_4d(smem_addr(slot), map2, cc * CC, hx, hy, b, bar);
    else
      egm::mma::tma_load_4d(smem_addr(slot), map1, (cc - k2) * CC, q0, r0, b, bar);
  }
  __device__ void load(bf16* slot, int cc) const {
    const int k2 = chunks2();
    if (cc < k2)
      load_x_chunk<NPX, PWA>(slot, x2b, H, W, C2, hy, hx, cc, vec2);
    else
      load_x_chunk<NPATCH, PC>(slot, x1b, h, w, C1, r0, q0, cc - k2, vec1);
  }
  // x2 steps multiply the slot; x1 steps blend the slot's patch into abuf
  __device__ uint32_t prepare(bf16* slot, int cc) const {
    if (cc < chunks2()) return smem_addr(slot);
    blend(reinterpret_cast<const unsigned char*>(slot));
    __syncthreads();
    return smem_addr(abuf);
  }
  __device__ void blend(const unsigned char* patch) const {
    unsigned char* a = reinterpret_cast<unsigned char*>(abuf);
    for (int e = threadIdx.x; e < NPX * 2; e += NT) {
      const int p = e >> 1, half = e & 1;
      const Tap rt = rtap[p / PWA], ct = ctap[p % PWA];
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
      if (rt.lo >= 0 && ct.lo >= 0) {
        const uint4 q00 = *reinterpret_cast<const uint4*>(patch + chunk_off<DENSE>(rt.lo * PC + ct.lo, half));
        const uint4 q10 = *reinterpret_cast<const uint4*>(patch + chunk_off<DENSE>(rt.hi * PC + ct.lo, half));
        const uint4 q01 = *reinterpret_cast<const uint4*>(patch + chunk_off<DENSE>(rt.lo * PC + ct.hi, half));
        const uint4 q11 = *reinterpret_cast<const uint4*>(patch + chunk_off<DENSE>(rt.hi * PC + ct.hi, half));
        const __nv_bfloat162* v00 = reinterpret_cast<const __nv_bfloat162*>(&q00);
        const __nv_bfloat162* v10 = reinterpret_cast<const __nv_bfloat162*>(&q10);
        const __nv_bfloat162* v01 = reinterpret_cast<const __nv_bfloat162*>(&q01);
        const __nv_bfloat162* v11 = reinterpret_cast<const __nv_bfloat162*>(&q11);
        uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f00 = __bfloat1622float2(v00[k]), f10 = __bfloat1622float2(v10[k]);
          const float2 f01 = __bfloat1622float2(v01[k]), f11 = __bfloat1622float2(v11[k]);
          // row pass, rounded to bf16, then the column pass
          const float t0x = egm::round_to<bf16>(rt.wl * f00.x + rt.wh * f10.x);
          const float t1x = egm::round_to<bf16>(rt.wl * f01.x + rt.wh * f11.x);
          const float t0y = egm::round_to<bf16>(rt.wl * f00.y + rt.wh * f10.y);
          const float t1y = egm::round_to<bf16>(rt.wl * f01.y + rt.wh * f11.y);
          ov[k] = egm::mma::pack_bf16(ct.wl * t0x + ct.wh * t1x, ct.wl * t0y + ct.wh * t1y);
        }
      }
      *reinterpret_cast<uint4*>(a + chunk_off<DENSE>(p, half)) = o;
    }
  }
};

// Shared memory: R ring slots (a halo or patch chunk and, without resident
// weights, the weight tile), the blended A grid, then WRES: the weight tiles
// of every channel chunk, in step order.  TMA: the ring starts on a multiple
// of 1024 bytes.
template <int TH, int TW, int BN, bool WRES, bool TMA>
struct Layout {
  static constexpr int PW = TW + 2, NPX = (TH + 2) * PW, P = TH * TW;
  using S = Slots<NPX, BN, WRES, TMA>;
  static constexpr int XBUF = S::XBUF, SLOT = S::SLOT, R = S::R;
  static constexpr int ABUF = TMA ? round_up(NPX * CC, 512) : NPX * XP;
  __host__ __device__ static int chunks(int C2, int C1) {
    return (C2 + CC - 1) / CC + (C1 + CC - 1) / CC;
  }
  __host__ static size_t bytes(int C2, int C1, int Co) {
    size_t n = (size_t)R * SLOT + ABUF;
    if (WRES) n += resident_elems(chunks(C2, C1), Co, BN);
    return sizeof(bf16) * n + (TMA ? 1024 : 0);
  }
};

struct Args {
  const bf16* x2;
  const bf16* x1;
  const bf16* w;
  const float* bias;
  bf16* out;
  Taps rows, cols;
  int h, w_, C1, C2, Co;
  int vec2, vec1, vec_w;
};

// One block walks the work items (tile, column chunk) as conv3x3.cu's kernel
// does.  Two blocks share an SM: left to itself the compiler gives most of
// these kernels more than 128 registers a thread, which leaves one block per
// SM, and the narrow sites' loads (up3, up4) then find little work to hide
// behind (PERF.md).
template <int TH, int TW, int BN, int WN, bool WRES, bool TMA>
__global__ void __launch_bounds__(NT, 2)
upconv_mma_kernel(const Args args, int tiles_x, int tiles_y, int nchunks, int work,
                  const __grid_constant__ CUtensorMap map2,
                  const __grid_constant__ CUtensorMap map1,
                  const __grid_constant__ CUtensorMap map_w) {
  using L = Layout<TH, TW, BN, WRES, TMA>;
  using Src = SrcUp<TH, TW, TMA>;
  constexpr int WM = 8 / WN;
  constexpr int PW = L::PW, P = L::P, MB = P / 16;
  constexpr int MW = (MB + WM - 1) / WM, NB = BN / WN / 8;
  static_assert(P % 16 == 0, "whole m-blocks");
  const int h = args.h, wd = args.w_, H = 2 * h, W = 2 * wd;
  const int C1 = args.C1, C2 = args.C2, Ct = C1 + C2, Co = args.Co;
  extern __shared__ __align__(16) unsigned char smem_k5[];
  bf16* slots = reinterpret_cast<bf16*>(smem_k5);
  if constexpr (TMA) slots += ((1024u - (smem_addr(slots) & 1023u)) & 1023u) / 2;
  bf16* abuf = slots + L::R * L::SLOT;
  bf16* wres = abuf + L::ABUF;  // WRES: the weight tiles
  __shared__ __align__(8) unsigned long long bars[L::R];
  __shared__ Tap rtap[TH + 2], ctap[TW + 2];
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
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);  // ldmatrix row of an m-block

  if constexpr (WRES) {  // one cp.async group, older than every step's
    const int k2 = (C2 + CC - 1) / CC, k = L::chunks(C2, C1);
    bf16* dst = wres;
    for (int n0 = 0; n0 < Co; n0 += BN)
      for (int cc = 0; cc < k; ++cc, dst += WROWS * (BN + 8))
        load_weights<BN>(dst, args.w, Ct, Co, n0, cc < k2 ? cc * CC : C2 + (cc - k2) * CC,
                         cc < k2 ? C2 - cc * CC : C1 - (cc - k2) * CC, args.vec_w);
    egm::mma::cp_async_commit();
  }

  int a_row[MW];  // this lane's row of each m-block in the halo grid, tap (0, 0)
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const int m = (wm * MW + i) * 16 + lrow;
    a_row[i] = (m / TW) * PW + m % TW;
  }
  const bool pairs = (Co & 1) == 0;  // 4-byte stores stay aligned

  for (int item = blockIdx.x; item < work; item += gridDim.x) {
    const int tile = item / nchunks, nc = item - tile * nchunks;
    const int b = tile / (tiles_x * tiles_y);
    const int y0 = (tile / tiles_x) % tiles_y * TH, x0 = tile % tiles_x * TW;
    const int hy = y0 - 1, hx = x0 - 1;
    // the patch origin, and the halo's taps relative to it (the previous
    // item's stage ended in a barrier, so nobody reads the old tables)
    const int r0 = args.rows.lo[max(hy, 0)], q0 = args.cols.lo[max(hx, 0)];
    for (int i = threadIdx.x; i < (TH + 2) + (TW + 2); i += NT) {
      const bool is_row = i < TH + 2;
      const int j = is_row ? i : i - (TH + 2);
      const int pos = (is_row ? hy : hx) + j, n = is_row ? H : W, o = is_row ? r0 : q0;
      const Taps& t = is_row ? args.rows : args.cols;
      Tap tap{-1, -1, 0.f, 0.f};
      if (pos >= 0 && pos < n) {
        tap = Tap{t.lo[pos] - o, t.hi[pos] - o, t.wl[pos], t.wh[pos]};
        if (tap.lo < 0 || tap.hi >= (is_row ? Src::PR : Src::PC)) __trap();  // outside the patch
      }
      Tap* dst = is_row ? &rtap[0] : &ctap[0];
      dst[j] = tap;
    }
    __syncthreads();
    // out = relu(conv(concat) + bias) on the tile's pixels inside the image
    auto epi = [&](int nw, float (&acc)[MW][NB][4]) {
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = (wm * MW + i) * 16 + g + 8 * r;
          if (wm * MW + i >= MB) continue;
          const int oy = y0 + m / TW, ox = x0 + m % TW;
          if (oy >= H || ox >= W) continue;
          bf16* row = args.out + (((long long)b * H + oy) * W + ox) * Co;
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            const int n = nw + j * 8 + t2;
            if (n >= Co) continue;
            const float v0 = fmaxf(acc[i][j][2 * r] + args.bias[n], 0.f);
            if (n + 1 < Co) {
              const float v1 = fmaxf(acc[i][j][2 * r + 1] + args.bias[n + 1], 0.f);
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
    const int n_begin = nc * BN;
    const StageIn in{args.w, Ct, Co, n_begin, min(Co, n_begin + BN), (bool)args.vec_w, wres,
                     &map_w};
    const Src src{args.x2 + (long long)b * H * W * C2,
                  args.x1 + (long long)b * h * wd * C1,
                  H, W, h, wd, C2, C1, hy, hx, r0, q0, b, (bool)args.vec2, (bool)args.vec1,
                  &map2, &map1, abuf, rtap, ctap};
    gemm_stage<MB, BN, WN, L::R, WRES, TMA, L::SLOT, L::XBUF>(in, src, ring, a_row, epi);
  }
}

template <int TH, int TW, int BN, int WN, bool WRES, bool TMA>
int launch(const Args& a, int B, cudaStream_t stream) {
  using L = Layout<TH, TW, BN, WRES, TMA>;
  using Src = SrcUp<TH, TW, TMA>;
  const size_t smem = L::bytes(a.C2, a.C1, a.Co);
  auto kernel = upconv_mma_kernel<TH, TW, BN, WN, WRES, TMA>;
  cudaError_t err = opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int H = 2 * a.h, W = 2 * a.w_;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int nchunks = (a.Co + BN - 1) / BN;
  if (WRES && nchunks != 1) return (int)cudaErrorInvalidValue;  // resident: one chunk
  const long long work = (long long)tiles_x * tiles_y * B * nchunks;
  if (work > 2147483647LL) return (int)cudaErrorInvalidValue;
  long long blocks = work;
  if (WRES) {
    err = persistent_blocks(kernel, smem, work, &blocks);
    if (err != cudaSuccess) return (int)err;
  }
  CUtensorMap maps[3] = {};  // x2 [B][H][W][C2]; x1 [B][h][w][C1]; w [9][C2+C1][Co]
  if (TMA && !(map_nhwc(&maps[0], a.x2, B, H, W, a.C2, TW + 2, TH + 2) &&
               map_nhwc(&maps[1], a.x1, B, a.h, a.w_, a.C1, Src::PC, Src::PR) &&
               map_hwio(&maps[2], a.w, a.C2 + a.C1, a.Co)))
    return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, NT, smem, stream>>>(a, tiles_x, tiles_y, nchunks, (int)work,
                                                 maps[0], maps[1], maps[2]);
  return (int)cudaGetLastError();
}

// mode: 0 cp.async / scalar ring, 1 resident weights, 2 TMA
int run(Args a, int B, int th, int tw, int bn, int mode, cudaStream_t s) {
  a.vec2 = a.C2 % 8 == 0 && aligned16(a.x2);
  a.vec1 = a.C1 % 8 == 0 && aligned16(a.x1);
  a.vec_w = a.Co % 8 == 0 && aligned16(a.w);
  const bool all_vec = a.vec2 && a.vec1 && a.vec_w;
#define EGM_UPCONV_TC_CASE(TH_, TW_, BN_, WN_, MODE_)                                    \
  if (th == TH_ && tw == TW_ && bn == BN_ && mode == MODE_ && (MODE_ != 2 || all_vec)) \
    return launch<TH_, TW_, BN_, WN_, MODE_ == 1, MODE_ == 2>(a, B, s);
  EGM_UPCONV_TC_CASE(8, 16, 16, 1, 1)
  EGM_UPCONV_TC_CASE(8, 16, 32, 2, 1)
  EGM_UPCONV_TC_CASE(8, 16, 64, 2, 1)
  EGM_UPCONV_TC_CASE(8, 16, 64, 2, 2)
  EGM_UPCONV_TC_CASE(8, 16, 128, 2, 2)
  EGM_UPCONV_TC_CASE(8, 16, 64, 2, 0)
  EGM_UPCONV_TC_CASE(8, 16, 128, 2, 0)
#undef EGM_UPCONV_TC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// x2 [B,2h,2w,C2], x1 [B,h,w,C1], w [3,3,C2+C1,Co], bias float32 [Co],
// out [B,2h,2w,Co]; row taps (length 2h) and column taps (length 2w) as
// int32 indices and float32 weights.  dtype: 0 float32, 1 bfloat16.
// bfloat16: (th, tw) is the pixel tile, bn the column chunk and mode how the
// ring is filled (0 cp.async, 1 resident weights, 2 TMA), picked by the host
// (ops/cuda/upconv.py::upconv_tile); float32 ignores them.
extern "C" int egm_up_concat_conv(const void* x2, const void* x1, const void* w,
                                  const void* bias, void* out, const void* rlo,
                                  const void* rhi, const void* rwl, const void* rwh,
                                  const void* clo, const void* chi, const void* cwl,
                                  const void* cwh, int B, int h, int wd, int C1, int C2,
                                  int Co, int th, int tw, int bn, int mode, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || h < 1 || wd < 1 || C1 < 1 || C2 < 1 || Co < 1) return (int)cudaErrorInvalidValue;
  const Taps rows{static_cast<const int*>(rlo), static_cast<const int*>(rhi),
                  static_cast<const float*>(rwl), static_cast<const float*>(rwh)};
  const Taps cols{static_cast<const int*>(clo), static_cast<const int*>(chi),
                  static_cast<const float*>(cwl), static_cast<const float*>(cwh)};
  const float* b = static_cast<const float*>(bias);
  if (dtype == egm::kFloat32)
    return run_f32(x2, x1, w, b, out, rows, cols, B, h, wd, C1, C2, Co, s);
  if (dtype == egm::kBFloat16) {
    const tc::Args a{static_cast<const __nv_bfloat16*>(x2), static_cast<const __nv_bfloat16*>(x1),
                     static_cast<const __nv_bfloat16*>(w), b, static_cast<__nv_bfloat16*>(out),
                     rows, cols, h, wd, C1, C2, Co, 0, 0, 0};
    return tc::run(a, B, th, tw, bn, mode, s);
  }
  return (int)cudaErrorInvalidValue;
}
