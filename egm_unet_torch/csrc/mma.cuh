// Tensor-core building blocks of the port's bf16 kernels, as inline PTX:
// ldmatrix (shared memory -> mma fragments), mma.sync m16n8k16 with bf16
// operands and float32 accumulators, 16-byte cp.async copies (device memory
// -> shared memory) with zero fill, and what a kernel needs to have the TMA
// unit copy whole tiles: tensor maps (made on the host), cp.async.bulk.tensor
// and the mbarrier calls that wait for it.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col (g = lane / 4,
// t = lane % 4):
//   A (16 x 16, row-major), four registers of two bf16:
//     a[0] = (row g,     k 2t, 2t+1)      a[1] = (row g + 8, k 2t, 2t+1)
//     a[2] = (row g,     k 2t+8, 2t+9)    a[3] = (row g + 8, k 2t+8, 2t+9)
//   B (16 x 8, "col"), two registers:
//     b0 = (k 2t, 2t+1, col g)            b1 = (k 2t+8, 2t+9, col g)
//   C / D (16 x 8, float32), four registers:
//     c[0], c[1] = (row g, col 2t, 2t+1)  c[2], c[3] = (row g + 8, col 2t, 2t+1)
// Two neighbouring C tiles (columns 0..7 and 8..15 of one 16 x 16 block),
// packed pairwise to bf16, are therefore the A fragment of the next product:
// a[0] = pack(c_lo[0], c_lo[1]), a[1] = pack(c_lo[2], c_lo[3]),
// a[2] = pack(c_hi[0], c_hi[1]), a[3] = pack(c_hi[2], c_hi[3]).
//
// ldmatrix.x4 reads four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the
// addresses of the eight 16-byte rows of matrix i, and register i receives
// matrix i with the thread holding (row g, columns 2t, 2t+1), or, with
// .trans, (rows 2t, 2t+1, column g).  The lane -> address maps for the three
// operand layouts the kernels use:
//   A from a row-major [m][k] tile:       row (lane % 8) + 8 * ((lane / 8) % 2),
//                                         k offset 8 * (lane / 16)
//   B from an [n][k] tile (k contiguous): row n = (lane % 8) + 8 * (lane / 16),
//     no .trans; registers 0, 1 are     k offset 8 * ((lane / 8) % 2)
//     (b0, b1) of columns 0..7, registers 2, 3 of columns 8..15
//   B from a [k][n] tile (n contiguous): row k = (lane % 8) + 8 * ((lane / 8) % 2),
//     .trans; same register meaning      n offset 8 * (lane / 16)
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace egm {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b, one 16 x 8 x 16 tile
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device memory to shared memory; zeros when !valid (src must
// still be a mapped address: pass the tensor's base).  Both addresses must be
// 16-byte aligned.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(N) : "memory");
}

// ---- mbarriers, for copies that the TMA unit makes (cp.async.bulk.tensor)

__device__ __forceinline__ void mbarrier_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" : : "r"(bar), "r"(arrivals) : "memory");
}

// makes freshly initialised barriers, and plain shared-memory stores made so
// far, visible to the copy unit
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void mbarrier_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(bar), "r"(bytes)
               : "memory");
}

// wait for the barrier's phase `parity` to complete; a barrier that never
// completes (a miscounted copy) traps instead of hanging the card
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, int parity) {
  for (int spin = 0; spin < (1 << 22); ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// One tile of a tensor map's box shape, its first element at the coordinates
// c0, c1, ... (innermost first; a coordinate may lie outside the tensor, what
// is out of bounds arrives as zeros), to shared memory at dst; the barrier
// counts the box's bytes off when they have landed.  map points at a
// __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :
      : "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :
      : "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
      : "memory");
}

// Host side: a tensor map over a bf16 tensor of `rank` dimensions (innermost
// first: dims in elements, strides of dimensions 1.. in bytes, multiples of
// 16), copied in boxes of `box` elements with the given shared-memory swizzle
// and zeros out of bounds.  cuTensorMapEncodeTiled is looked up through the
// runtime, so the library needs no link against libcuda.  False on failure.
inline bool make_tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                            const cuuint64_t* strides, const cuuint32_t* box,
                            CUtensorMapSwizzle swizzle) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
    return reinterpret_cast<Encode>(p);
  }();
  if (encode == nullptr) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// two float32 values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace mma
}  // namespace egm
