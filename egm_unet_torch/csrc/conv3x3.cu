// 3x3 / stride 1 / pad 1 convolution + optional bias + optional ReLU, NHWC x
// HWIO, float32 accumulation: the folded ConvBNReLU / BasicConv conv.
//
// Replaces the TPU kernel egm_unet_tpu/ops/pallas/conv3x3.py::conv3x3_gemm
// (body _kernel).  That kernel im2cols the dy taps of a pre-padded row slab
// in VMEM and combines the dx taps after the GEMM with f32 rolls, and pads
// C and Co to 128 lanes; all three are Mosaic workarounds with no use here.
//
// On the H100 this is an implicit GEMM, M = B*H*W pixels, N = Co, K = 9*C.
// Zero padding comes from the loads (what lies outside the image arrives as
// zeros), so no padded copy is written, and any C works (C = 3 for the stem).
//
// Bound: at the path's widths (C, Co >= 32) the work is far above the card's
// bf16 ridge (~295 FLOP/byte), so the tensor-core rate bounds it; the narrow
// sites (576x768 at 3 -> 32 and 32 -> 32, 288x384 at 64 -> 8 and 64 -> 32)
// sit near the ridge, where the traffic (the 3.5 M-pixel outputs, and the
// weights if every tile re-read them) bounds it.
//
// Two kernels, chosen by dtype (ops/cuda/conv3x3.py::conv3x3_variant):
//
// - bfloat16, "mma_bf16" (conv3x3_mma_kernel): the tensor-core implicit-GEMM
//   stage of igemm_mma.cuh, K3's stage 1 with its epilogue writing to device
//   memory.  A block owns a TH x TW tile of output pixels of one image and a
//   chunk of BN output columns; A is gathered by ldmatrix from a 16-channel
//   chunk of the (TH+2)(TW+2) input halo, the weights come as [9*16, BN]
//   tiles of the HWIO tensor viewed as [9*C, Co], and nine 16-deep products
//   run per step with the next steps' tiles in flight.  The epilogue adds the
//   float32 bias, applies the ReLU only when asked, and rounds once to bf16:
//   the profile of conv3x3_plain.  The host picks the tile
//   (ops/cuda/conv3x3.py::conv3x3_tile):
//   * narrow sites (Co <= 64, all weights within half an SM's shared memory):
//     8x16 tiles, the weights loaded once per block and kept resident, as
//     many blocks as the card holds at once, each walking many tiles; the
//     column chunk is the narrowest of 16, 32, 64 that covers Co (Co = 8 and
//     16 take 16 columns, one warp along N);
//   * wide sites, every channel count a multiple of 8 and x, w 16-byte
//     aligned: the TMA unit fills the ring (halo chunk and 64-column weight
//     boxes by tensor-map copies, an mbarrier per slot); 8x16 tiles with 32
//     columns where Co <= 32, 16x16 with 64 where Co <= 64, else 8x16 with
//     128, the chunks of Co on the grid beside the tiles;
//   * anything else (channel counts off the 8-grid, unaligned tensors): 8x16
//     with 64-column chunks by 16-byte cp.async, or scalar loads where a
//     channel count is off the 16-byte grid.
//   The stem's C = 3 runs nine 16-deep products per step where flattening
//   (tap, c) to K = 27 would need two; this kernel does not flatten.
// - float32, "cuda_cores_f32": common.cuh::igemm3x3_kernel on the CUDA cores.
//   It holds 1e-4 relative, which TF32 would not.
#include "common.cuh"
#include "igemm_mma.cuh"

namespace {

template <typename T>
struct Conv3x3Loader {
  const T* __restrict__ x;
  int H, W, C;
  __device__ __forceinline__ float operator()(int b, int y, int xx, int c) const {
    return egm::to_f32(x[(((long long)b * H + y) * W + xx) * C + c]);
  }
};

int run_f32(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
            int C, int Co, int relu, cudaStream_t stream) {
  Conv3x3Loader<float> ld{static_cast<const float*>(x), H, W, C};
  return egm::launch_igemm3x3<float>(ld, static_cast<const float*>(w),
                                     static_cast<const float*>(bias), static_cast<float*>(out),
                                     B, H, W, C, Co, relu, stream);
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
using egm::igemm::Ring;
using egm::igemm::Slots;
using egm::igemm::SrcHalo;
using egm::igemm::StageIn;
using egm::mma::smem_addr;

// Shared memory: R ring slots (the input-halo chunk and, without resident
// weights, the weight tile), then WRES: the weight tiles of every channel
// chunk, in step order.  TMA: the ring starts on a multiple of 1024 bytes.
template <int TH, int TW, int BN, bool WRES, bool TMA>
struct Layout {
  static constexpr int PW = TW + 2, NPX = (TH + 2) * PW, P = TH * TW;
  using S = Slots<NPX, BN, WRES, TMA>;
  static constexpr int XBUF = S::XBUF, SLOT = S::SLOT, R = S::R;
  __host__ static size_t bytes(int C, int Co) {
    size_t n = (size_t)R * SLOT;
    if (WRES) n += resident_elems((C + CC - 1) / CC, Co, BN);
    return sizeof(bf16) * n + (TMA ? 1024 : 0);
  }
};

// One block walks the work items blockIdx.x, blockIdx.x + gridDim.x, ... of
// the tiles * nchunks items (tile, column chunk), chunks fastest and then x,
// so that blocks that run together share their halos in L2.  Without resident
// weights the grid has one block per item; with them (one column chunk) as
// many blocks as the card holds at once.
template <int TH, int TW, int BN, int WN, bool WRES, bool TMA>
__global__ void __launch_bounds__(NT)
conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ bias, bf16* __restrict__ out, int H, int W, int C,
                   int Co, int relu, int tiles_x, int tiles_y, int nchunks, int work,
                   int vec_x, int vec_w, const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w) {
  using L = Layout<TH, TW, BN, WRES, TMA>;
  constexpr int WM = 8 / WN;
  constexpr int PW = L::PW, P = L::P, MB = P / 16;
  constexpr int MW = (MB + WM - 1) / WM, NB = BN / WN / 8;
  static_assert(P % 16 == 0, "whole m-blocks");
  extern __shared__ __align__(16) unsigned char smem_k2[];
  bf16* slots = reinterpret_cast<bf16*>(smem_k2);
  if constexpr (TMA) slots += ((1024u - (smem_addr(slots) & 1023u)) & 1023u) / 2;
  bf16* wres = slots + L::R * L::SLOT;  // WRES: the weight tiles
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
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);  // ldmatrix row of an m-block

  if constexpr (WRES) {  // one cp.async group, older than every step's
    bf16* dst = wres;
    for (int n0 = 0; n0 < Co; n0 += BN)
      for (int cc = 0; cc * CC < C; ++cc, dst += WROWS * (BN + 8))
        load_weights<BN>(dst, w, C, Co, n0, cc * CC, C - cc * CC, vec_w);
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
    // out = act(conv(x) + bias) on the tile's pixels inside the image
    auto epi = [&](int nw, float (&acc)[MW][NB][4]) {
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = (wm * MW + i) * 16 + g + 8 * r;
          if (wm * MW + i >= MB) continue;
          const int oy = y0 + m / TW, ox = x0 + m % TW;
          if (oy >= H || ox >= W) continue;
          bf16* row = out + (((long long)b * H + oy) * W + ox) * Co;
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            const int n = nw + j * 8 + t2;
            if (n >= Co) continue;
            float v0 = acc[i][j][2 * r] + (bias != nullptr ? bias[n] : 0.f);
            if (relu) v0 = fmaxf(v0, 0.f);
            if (n + 1 < Co) {
              float v1 = acc[i][j][2 * r + 1] + (bias != nullptr ? bias[n + 1] : 0.f);
              if (relu) v1 = fmaxf(v1, 0.f);
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
    const StageIn in{w, C, Co, n_begin, min(Co, n_begin + BN), (bool)vec_w, wres, &map_w};
    const SrcHalo<L::NPX, PW, TMA> src{x + (long long)b * H * W * C, H, W, C, y0 - 1, x0 - 1,
                                       b, (bool)vec_x, &map_x};
    gemm_stage<MB, BN, WN, L::R, WRES, TMA, L::SLOT, L::XBUF>(in, src, ring, a_row, epi);
  }
}

template <int TH, int TW, int BN, int WN, bool WRES, bool TMA>
int launch(const void* x, const void* w, const float* bias, void* out, int B, int H, int W,
           int C, int Co, int relu, bool vec_x, bool vec_w, cudaStream_t stream) {
  using L = Layout<TH, TW, BN, WRES, TMA>;
  const size_t smem = L::bytes(C, Co);
  auto kernel = conv3x3_mma_kernel<TH, TW, BN, WN, WRES, TMA>;
  cudaError_t err = opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int nchunks = (Co + BN - 1) / BN;
  if (WRES && nchunks != 1) return (int)cudaErrorInvalidValue;  // resident: one chunk
  const long long work = (long long)tiles_x * tiles_y * B * nchunks;
  if (work > 2147483647LL) return (int)cudaErrorInvalidValue;
  long long blocks = work;
  if (WRES) {
    err = persistent_blocks(kernel, smem, work, &blocks);
    if (err != cudaSuccess) return (int)err;
  }
  CUtensorMap maps[2] = {};  // x [B][H][W][C]; w [9][C][Co]
  if (TMA && !(map_nhwc(&maps[0], x, B, H, W, C, TW + 2, TH + 2) && map_hwio(&maps[1], w, C, Co)))
    return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, static_cast<bf16*>(out), H,
      W, C, Co, relu, tiles_x, tiles_y, nchunks, (int)work, (int)vec_x, (int)vec_w, maps[0],
      maps[1]);
  return (int)cudaGetLastError();
}

// mode: 0 cp.async / scalar ring, 1 resident weights, 2 TMA
int run(const void* x, const void* w, const float* bias, void* out, int B, int H, int W, int C,
        int Co, int relu, int th, int tw, int bn, int mode, cudaStream_t s) {
  const bool vec_x = C % 8 == 0 && aligned16(x), vec_w = Co % 8 == 0 && aligned16(w);
  // the TMA tiles need x and w on the 16-byte grid; the host asks for another
  // tile otherwise
#define EGM_CONV_TC_CASE(TH_, TW_, BN_, WN_, MODE_)                                          \
  if (th == TH_ && tw == TW_ && bn == BN_ && mode == MODE_ && (MODE_ != 2 || (vec_x && vec_w))) \
    return launch<TH_, TW_, BN_, WN_, MODE_ == 1, MODE_ == 2>(x, w, bias, out, B, H, W, C, Co,  \
                                                              relu, vec_x, vec_w, s);
  EGM_CONV_TC_CASE(8, 16, 16, 1, 1)
  EGM_CONV_TC_CASE(8, 16, 32, 2, 1)
  EGM_CONV_TC_CASE(8, 16, 64, 2, 1)
  EGM_CONV_TC_CASE(8, 16, 32, 2, 2)
  EGM_CONV_TC_CASE(16, 16, 64, 2, 2)
  EGM_CONV_TC_CASE(8, 16, 128, 2, 2)
  EGM_CONV_TC_CASE(8, 16, 64, 2, 0)
#undef EGM_CONV_TC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// x [B,H,W,C], w [3,3,C,Co], bias float32 [Co] or null, out [B,H,W,Co];
// x, w and out share the dtype `dtype` (0 float32, 1 bfloat16).  bfloat16:
// (th, tw) is the pixel tile, bn the column chunk and mode how the ring is
// filled (0 cp.async, 1 resident weights, 2 TMA), picked by the host
// (ops/cuda/conv3x3.py::conv3x3_tile); float32 ignores them (the CUDA-core
// kernel picks its tile by Co).
extern "C" int egm_conv3x3(const void* x, const void* w, const void* bias, void* out, int B,
                           int H, int W, int C, int Co, int relu, int th, int tw, int bn,
                           int mode, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || W < 1 || C < 1 || Co < 1) return (int)cudaErrorInvalidValue;
  if (dtype == egm::kFloat32) return run_f32(x, w, bias, out, B, H, W, C, Co, relu, s);
  if (dtype == egm::kBFloat16)
    return tc::run(x, w, static_cast<const float*>(bias), out, B, H, W, C, Co, relu, th, tw, bn,
                   mode, s);
  return (int)cudaErrorInvalidValue;
}
