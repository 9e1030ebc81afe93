// The tensor-core implicit-GEMM stage of the port's bf16 3x3 convolutions,
// shared by conv3x3.cu (K2), conv3x3_pair.cu (K3, both of its stages) and
// up_concat_conv.cu (K5).
//
// One stage computes acc[16*MB rows, columns] = sum over k of A * Wt for a
// 3x3 / stride 1 / pad 1 convolution whose weights are the HWIO tensor
// viewed as row-major [9*Ktap, N]: row tap*Ktap + c, tap = dy*3 + dx.  It
// runs on the tensor cores (mma.sync m16n8k16, bf16 operands, float32
// accumulators; bf16 products are exact in float32, so only the order of the
// sums differs from a float32 conv of the same operands).
//
// - Eight warps, WM along M x WN along N (WM * WN = 8), walk the columns in
//   chunks of BN and K in steps of 16 channels x all nine taps: nine 16-deep
//   products per step.  One pipeline step is one channel chunk.
// - The A operand is never staged as a matrix: ldmatrix takes one row address
//   per lane, so the 3x3 gather is an address offset (dy*PWA + dx) rows into
//   a 16-channel chunk of a halo grid PWA pixels wide.  Where that grid comes
//   from is the source policy's business (SrcHalo: a chunk of the input halo
//   copied from device memory; SrcBuf: a buffer already in shared memory, K3's
//   intermediate; up_concat_conv.cu's source blends its chunk from a staged
//   low-resolution patch).  Row pitches of pitched grids are 16*m + 8
//   elements, never a multiple of 128 bytes, so the eight rows of a fragment
//   fall into distinct banks; dense grids (the TMA unit's) are 32-byte rows
//   with the 32-byte swizzle.
// - The weights come straight from the HWIO tensor into a ring of [9*16, BN]
//   tiles, the next steps' tiles in flight while the tensor cores work on
//   this one; ldmatrix.trans makes the col-major B fragment, so nothing is
//   repacked on the host.  Rows past the channel count and columns past N are
//   zero-filled.  WRES: every weight tile lies in shared memory already
//   (loaded once per block, which then walks many tiles).
// - Who copies.  TMA: thread 0 starts one tensor-map copy for the A chunk (a
//   [B, H, W, C] map, box 16 channels x the grid, 32-byte swizzle; what lies
//   outside the tensor arrives as zeros, which is the conv's zero padding and
//   the channel tail) and one per 64 weight columns (a [9, Ktap, N] map, box
//   64 x 16 x 9, 128-byte swizzle); an mbarrier per ring slot says when they
//   have landed.  Otherwise 16-byte cp.async into padded tiles, or scalar
//   loads where a channel count is off the 16-byte grid.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace egm {
namespace igemm {

using bf16 = __nv_bfloat16;
using egm::mma::smem_addr;

constexpr int NT = 256;           // 8 warps
constexpr int CC = 16;            // channels per pipeline step (all nine taps of them)
constexpr int XP = CC + 8;        // row pitch of a pitched 16-channel chunk
constexpr int WROWS = 9 * CC;     // weight rows per step
constexpr int WBOX = WROWS * 64;  // elements of one 64-column weight box (TMA)

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
// Ring depth by the column chunk: R - 1 steps load while one is multiplied.
// Narrow chunks have short steps and small slots, so they keep more loads in
// flight; at 128 columns two slots are what fits beside the rest.
__host__ __device__ constexpr int ring_depth(int bn) { return bn <= 32 ? 4 : bn <= 64 ? 3 : 2; }

// The ring of a stage whose A chunk is NPX pixels: R slots, each the A chunk
// followed by the weight tile.  By cp.async the chunk is [NPX][XP] and the
// tile [WROWS][BN + 8]; by TMA the chunk is dense [NPX][CC] (swizzled) and
// the tile one box [WROWS][64] per 64 columns (128-byte swizzle), and slots
// are multiples of 1024 bytes, since the swizzles are functions of the
// address.  WRES: the slots hold the A chunk only.
template <int NPX, int BN, bool WRES, bool TMA>
struct Slots {
  static_assert(!(WRES && TMA), "resident weights come by cp.async");
  static constexpr int XBUF = TMA ? round_up(NPX * CC, 512) : NPX * XP;
  static constexpr int WTILE = TMA ? (BN + 63) / 64 * WROWS * 64 : WROWS * (BN + 8);
  static constexpr int SLOT = WRES ? XBUF : XBUF + WTILE;
  static constexpr int R = WRES ? 2 : ring_depth(BN);
};

// elements of the resident weight tiles of `chunks` channel chunks x N
// columns walked in chunks of bn
__host__ __device__ inline int resident_elems(int chunks, int N, int bn) {
  return ((N + bn - 1) / bn) * chunks * WROWS * (bn + 8);
}

// the weight side of one stage
struct StageIn {
  const bf16* wt;            // [9*Ktap, N]
  int Ktap, N;               // rows per tap, columns
  int n_begin, n_end;        // the columns this stage computes, walked in BN chunks
  bool vec_w;                // 16-byte copies are possible for wt
  const bf16* wres;          // WRES: this stage's resident tiles, in step order
  const CUtensorMap* map_w;  // TMA: wt as [9][Ktap][N]
};

struct Ring {
  bf16* base;
  unsigned long long* bars;  // TMA: one mbarrier per slot
  int used;                  // TMA: steps that went through the ring so far
};

// Rows base .. base + CC of each tap of the [9*Ktap, N] matrix wt, columns
// n0 .. n0 + BN, as [9*CC][BN + 8]: row tap*CC + r is row tap*Ktap + base + r;
// zeros where r >= lim or the column is past N.
template <int BN>
__device__ __forceinline__ void load_weights(bf16* tile, const bf16* __restrict__ wt, int Ktap,
                                             int N, int n0, int base, int lim, bool vec) {
  constexpr int WP = BN + 8;
  if (vec) {
    constexpr int PIECES = BN / 8;
    for (int e = threadIdx.x; e < WROWS * PIECES; e += NT) {
      const int r = e / PIECES, col = (e % PIECES) * 8;
      const bool ok = r % CC < lim && n0 + col < N;
      egm::mma::cp_async_16(
          smem_addr(tile + r * WP + col),
          ok ? wt + ((long long)(r / CC) * Ktap + base + r % CC) * N + n0 + col : wt, ok);
    }
  } else {
    for (int e = threadIdx.x; e < WROWS * BN; e += NT) {
      const int r = e / BN, col = e % BN;
      tile[r * WP + col] = (r % CC < lim && n0 + col < N)
                               ? wt[((long long)(r / CC) * Ktap + base + r % CC) * N + n0 + col]
                               : __float2bfloat16_rn(0.f);
    }
  }
}

// Channels cc*CC .. +CC of the (NPX / PWX) x PWX pixel window whose top-left
// pixel is (hy, hx) of the H x W image xb with C channels, as [NPX][XP];
// zeros outside the image and past C.
template <int NPX, int PWX>
__device__ __forceinline__ void load_x_chunk(bf16* buf, const bf16* __restrict__ xb, int H, int W,
                                             int C, int hy, int hx, int cc, bool vec) {
  if (vec) {
    constexpr int PIECES = CC / 8;
    for (int e = threadIdx.x; e < NPX * PIECES; e += NT) {
      const int px = e / PIECES, c = cc * CC + (e % PIECES) * 8;
      const int yy = hy + px / PWX, xx = hx + px % PWX;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W && c < C;
      egm::mma::cp_async_16(smem_addr(buf + px * XP + (e % PIECES) * 8),
                            ok ? xb + ((long long)yy * W + xx) * C + c : xb, ok);
    }
  } else {  // one pixel per thread: CC independent 2-byte loads, two 16-byte stores
    for (int px = threadIdx.x; px < NPX; px += NT) {
      const int yy = hy + px / PWX, xx = hx + px % PWX;
      const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const bf16* src = xb + ((long long)yy * W + xx) * C + cc * CC;
      const int valid = inside ? min(CC, C - cc * CC) : 0;
      __align__(16) bf16 row[CC];
#pragma unroll
      for (int j = 0; j < CC; ++j) row[j] = j < valid ? src[j] : __float2bfloat16_rn(0.f);
#pragma unroll
      for (int j = 0; j < CC / 8; ++j)
        reinterpret_cast<uint4*>(buf + px * XP)[j] = reinterpret_cast<const uint4*>(row)[j];
    }
  }
}

// Byte offset of the 8-channel half `half` of pixel p in a 16-channel chunk:
// dense 32-byte rows with the 32-byte swizzle (the 16-byte half is xored
// with bit 2 of the row, as the TMA unit writes it), or rows of XP elements.
template <bool DENSE>
__device__ __forceinline__ uint32_t chunk_off(int p, int half) {
  if constexpr (DENSE) return (uint32_t)p * 32u + ((((uint32_t)p >> 2) ^ (uint32_t)half) & 1u) * 16u;
  return (uint32_t)(p * XP + half * 8) * 2u;
}

// A source: the 16-channel chunks of the input halo, a PWX-wide window whose
// top-left pixel is (hy, hx), brought in by the TMA unit (dense, swizzled) or
// by cp.async / scalar loads (pitched).
template <int NPX_, int PWX, bool TMA>
struct SrcHalo {
  static constexpr bool LOADS = true, DENSE = TMA;
  static constexpr int PWA = PWX;
  const bf16* xb;  // this image
  int H, W, C;
  int hy, hx;  // the window's top-left pixel, may lie outside the image
  int b;       // TMA: the image's index
  bool vec;
  const CUtensorMap* map;  // TMA: x as [B][H][W][C]

  __device__ int chunks() const { return (C + CC - 1) / CC; }
  __device__ int pitch() const { return XP; }
  __device__ void wrow(int cc, int& base, int& lim) const {
    base = cc * CC;
    lim = C - cc * CC;
  }
  __device__ int tma_elems(int) const { return TMA ? NPX_ * CC : 0; }
  __device__ void load_tma(bf16* slot, int cc, uint32_t bar) const {
    egm::mma::tma_load_4d(smem_addr(slot), map, cc * CC, hx, hy, b, bar);
  }
  __device__ void load(bf16* slot, int cc) const {
    load_x_chunk<NPX_, PWX>(slot, xb, H, W, C, hy, hx, cc, vec);
  }
  __device__ uint32_t prepare(bf16* slot, int) const { return smem_addr(slot); }
};

// A source: a buffer already in shared memory, PWA pixels wide, pitch
// elements a row, Cin channels (K3's intermediate)
template <int PWA_>
struct SrcBuf {
  static constexpr bool LOADS = false, DENSE = false;
  static constexpr int PWA = PWA_;
  const bf16* buf;
  int pitch_, Cin;

  __device__ int chunks() const { return (Cin + CC - 1) / CC; }
  __device__ int pitch() const { return pitch_; }
  __device__ void wrow(int cc, int& base, int& lim) const {
    base = cc * CC;
    lim = Cin - cc * CC;
  }
  __device__ int tma_elems(int) const { return 0; }
  __device__ void load_tma(bf16*, int, uint32_t) const {}
  __device__ void load(bf16*, int) const {}
  __device__ uint32_t prepare(bf16*, int cc) const { return smem_addr(buf + cc * CC); }
};

// One implicit-GEMM stage: for every chunk of BN columns in [n_begin, n_end),
// acc[16*MB rows, BN] = sum over the source's channel chunks and the nine taps
// of A * Wt, then epi(first column of this warp, acc).  The warp at (wm, wn)
// owns m-blocks wm*MW .. wm*MW + MW - 1 (those below MB) and columns
// wn*BN/WN .. + BN/WN of the chunk.  a_row[i] is this lane's row of m-block i
// at tap (0, 0) in the source's grid.  Each step: the source's chunk and the
// weight tile land in a ring slot, the source prepares its A grid
// (src.prepare, which may write shared memory and synchronise the block) and
// nine 16-deep products run.
template <int MB, int BN, int WN, int R, bool WRES, bool TMA, int SLOT, int XBUF, class Src,
          class Epi>
__device__ __forceinline__ void gemm_stage(const StageIn& in, const Src& src, Ring& ring,
                                           const int (&a_row)[(MB + 8 / WN - 1) / (8 / WN)],
                                           const Epi& epi) {
  constexpr int WM = 8 / WN;
  constexpr int MW = (MB + WM - 1) / WM;  // m-blocks per warp
  constexpr int NB = BN / WN / 8;         // n-blocks (8 columns) per warp
  constexpr int WP = BN + 8;
  constexpr int BOXES = (BN + 63) / 64;
  constexpr bool LOADS = Src::LOADS || !WRES;
  static_assert(WM * WN == 8, "eight warps");
  static_assert(NB % 2 == 0, "a warp loads B fragments for 16 columns at a time");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int N = in.N;
  const int chunks = src.chunks();
  const int total = ((in.n_end - in.n_begin + BN - 1) / BN) * chunks;  // pipeline steps
  // This lane's ldmatrix offsets (mma.cuh), in bytes.  In a weight tile: its
  // row, and per 16 columns its 16-byte piece (by TMA: the box, and the piece
  // xor row % 8 = lane % 8).  In a pitched A grid, per m-block: its row at
  // tap (0, 0) and its 8-column half.
  const int w_lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  uint32_t w_col[NB / 2];
#pragma unroll
  for (int j2 = 0; j2 < NB / 2; ++j2) {
    const int col = wn * (BN / WN) + j2 * 16;
    w_col[j2] = TMA ? 2u * (uint32_t)(col / 64 * WBOX) +
                          ((uint32_t)((col % 64 / 8) | (lane >> 4)) ^ (lane & 7)) * 16u
                    : 2u * (uint32_t)(col + 8 * (lane >> 4));
  }
  const uint32_t w_off = 2u * (uint32_t)((WRES ? 0 : XBUF) + w_lrow * (TMA ? 64 : WP));
  const int a_pitch = src.pitch();
  uint32_t a_off[MW];
#pragma unroll
  for (int i = 0; i < MW; ++i) a_off[i] = 2u * (uint32_t)(a_row[i] * a_pitch + 8 * (lane >> 4));

  int in0 = in.n_begin, icc = 0;  // the step being loaded
  auto start_loads = [&](int s) {
    int base, lim;
    src.wrow(icc, base, lim);
    if constexpr (TMA) {
      if (threadIdx.x == 0) {  // the copy unit does the rest
        const int at = (ring.used + s) % R;
        bf16* slot = ring.base + at * SLOT;
        const uint32_t bar = smem_addr(&ring.bars[at]);
        egm::mma::mbarrier_expect(bar, 2 * (src.tma_elems(icc) + BOXES * WBOX));
        if constexpr (Src::LOADS) src.load_tma(slot, icc, bar);
#pragma unroll
        for (int bx = 0; bx < BOXES; ++bx)
          egm::mma::tma_load_3d(smem_addr(slot + XBUF + bx * WBOX), in.map_w, in0 + bx * 64, base,
                                0, bar);
      }
    } else {
      bf16* slot = ring.base + (s % R) * SLOT;
      if constexpr (!WRES)
        load_weights<BN>(slot + XBUF, in.wt, in.Ktap, N, in0, base, lim, in.vec_w);
      if constexpr (Src::LOADS) src.load(slot, icc);
    }
    if (++icc == chunks) {
      icc = 0;
      in0 += BN;
    }
  };

  float acc[MW][NB][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if constexpr (TMA) {
    for (int s = 0; s < R && s < total; ++s) start_loads(s);  // every slot is free
  } else if constexpr (LOADS) {
    for (int s = 0; s < R - 1; ++s) {
      if (s < total) start_loads(s);
      egm::mma::cp_async_commit();
    }
  }
  int n0 = in.n_begin, cc = 0;  // the step being multiplied
  for (int s = 0; s < total; ++s) {
    int at = s % R;
    if constexpr (TMA) {
      at = (ring.used + s) % R;
      egm::mma::mbarrier_wait(smem_addr(&ring.bars[at]), ((ring.used + s) / R) & 1);
    } else if constexpr (LOADS) {
      egm::mma::cp_async_wait<R - 2>();  // step s has landed
      __syncthreads();                   // ... for every thread, and step s - 1 is consumed
      if (s + R - 1 < total) start_loads(s + R - 1);
      egm::mma::cp_async_commit();
    }
    bf16* slot_p = ring.base + at * SLOT;
    const uint32_t a_addr = src.prepare(slot_p, cc);
    const uint32_t w_addr = (WRES ? smem_addr(in.wres + s * (WROWS * WP)) : smem_addr(slot_p)) + w_off;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t bw[NB / 2][4], af[MW][4];
#pragma unroll
      for (int j2 = 0; j2 < NB / 2; ++j2)
        egm::mma::ldmatrix_x4_trans(
            bw[j2], w_addr + 2u * (uint32_t)(tap * CC * (TMA ? 64 : WP)) + w_col[j2]);
      const int tap_row = (tap / 3) * Src::PWA + tap % 3;  // rows between tap (0, 0) and this tap
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        if (wm * MW + i >= MB) continue;  // uniform in the warp
        if constexpr (Src::DENSE) {
          egm::mma::ldmatrix_x4(af[i], a_addr + chunk_off<true>(a_row[i] + tap_row, lane >> 4));
        } else {
          egm::mma::ldmatrix_x4(af[i], a_addr + 2u * (uint32_t)(tap_row * a_pitch) + a_off[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        if (wm * MW + i >= MB) continue;
#pragma unroll
        for (int j2 = 0; j2 < NB / 2; ++j2) {
          egm::mma::mma_bf16(acc[i][2 * j2], af[i], bw[j2][0], bw[j2][1]);
          egm::mma::mma_bf16(acc[i][2 * j2 + 1], af[i], bw[j2][2], bw[j2][3]);
        }
      }
    }
    if (++cc == chunks) {
      epi(n0 + wn * (BN / WN), acc);
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      cc = 0;
      n0 += BN;
    }
    if constexpr (TMA) {
      __syncthreads();  // the slot is consumed: refill it
      if (s + R < total) start_loads(s + R);
    }
  }
  if constexpr (TMA) {
    ring.used += total;
  } else {
    egm::mma::cp_async_wait<0>();
    __syncthreads();  // the ring is free, the epilogues' shared-memory stores visible
  }
}

// ---------------------------------------------------------------- host side

// a [B][H][W][C] bf16 tensor map copied in boxes of 16 channels x box_w x
// box_h pixels of one image, 32-byte swizzle (SrcHalo's dense chunk)
inline bool map_nhwc(CUtensorMap* map, const void* x, int B, int H, int W, int C, int box_w,
                     int box_h) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * C, 2ull * C * W, 2ull * C * W * H};
  const cuuint32_t box[4] = {CC, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  return egm::mma::make_tensor_map(map, x, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
}

// an HWIO bf16 weight tensor as [9][Ktap][N], copied in [9][16][64] boxes
// with the 128-byte swizzle (gemm_stage's TMA weight tiles)
inline bool map_hwio(CUtensorMap* map, const void* w, int Ktap, int N) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)Ktap, 9};
  const cuuint64_t strides[2] = {2ull * N, 2ull * N * Ktap};
  const cuuint32_t box[3] = {64, CC, 9};
  return egm::mma::make_tensor_map(map, w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// lets `kernel` use `smem` bytes of dynamic shared memory
template <class K> inline cudaError_t opt_in_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the grid of a kernel whose blocks walk `work` items: as many blocks as the
// card holds at once, at most `work`
template <class K>
inline cudaError_t persistent_blocks(K kernel, size_t smem, long long work, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  *blocks = work < (long long)sms * per_sm ? work : (long long)sms * per_sm;
  return cudaSuccess;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace igemm
}  // namespace egm
