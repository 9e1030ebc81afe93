// The EAFE's edge map (kernel K8), NHWC: edge = x - avg3x3(x), where avg3x3
// is the mean of a 3x3 window at stride 1 with zero padding 1 that counts in
// the mean (count_include_pad: the divisor is always 9), as the
// EdgeAwareFeatureEnhancer (nn/layers.py) computes it before its 1x1 conv.
//
// Replaces no TPU kernel: the JAX package computes the edge in plain jnp
// (egm_unet_tpu/nn/layers.py, EdgeAwareFeatureEnhancer), as the port did in
// two PyTorch launches a call (avg_pool2d on the NCHW view of the map, whose
// channels-last output needs no copy back, and the subtraction).
//
// Arithmetic, per element, in the order the library composite
// x - avg_pool2d(x, 3, 1, 1) rounds it:
//   s    = 0 + x[y-1, x-1] + x[y-1, x] + ... + x[y+1, x+1]   float32, row by
//                                                            row, left to right
//   avg  = round_T(s / 9)                                    avg_pool2d's output
//   edge = round_T(x[y, x] - avg)
// A window position in the padding adds +0, which leaves the sum as the
// library's (it skips those positions): a sum that starts at +0 is never -0.
// Every step is rounded as IEEE rounds it (__fadd_rn, div9, __fsub_rn), so
// the kernel gives the composite's bits.
//
// Bound: one read of x and one write of the edge, about 20 float32
// operations an element; device-memory bytes bound it.  The design:
// - A block owns a band of R rows by a tile of TW pixels (all channels) of
//   one image: grid (tiles, bands, B), R and TW from the host
//   (ops/cuda/edge.py::eafe_edge_tile, eafe_edge_bands).  The bits do not
//   depend on the split, so an image's edge is the same in any batch.
// - The block walks its band's rows.  It stages each input row's TW + 2
//   pixels (the tile and its two halo columns) in a ring of SLOTS shared-memory
//   rows, PF rows ahead of the window it computes: by 16-byte cp.async with
//   zero fill where C fills whole 16-byte units and x and out lie on the
//   16-byte grid ("vec16": 8 bf16 or 4 float32 channels a unit), else element
//   by element ("scalar").  Rows and columns outside the image are
//   zero-filled, so no padded copy is made.  One barrier a row.
// - A thread owns units of the tile's row (unit i: pixel x0 + i / CV, channel
//   group i % CV): in the staged row its left, centre and right neighbours are
//   units i, i + CV and i + 2 CV, so the window needs no division.  It reads
//   the 9 units from the ring and writes its edge unit with one 16-byte store;
//   neighbouring threads own neighbouring units of the contiguous row.
// - Indices 32-bit inside an image (the host checks H W C < 2^31); one 64-bit
//   image base.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NT = 256;
constexpr int PF = 2;           // staged rows in flight past the computed window
constexpr int SLOTS = PF + 3;   // the window's three rows, PF in flight, one being freed

// UC consecutive channels (one unit) as float32
template <typename T, int UC>
__device__ __forceinline__ void load_unit(const T* p, float (&v)[UC]) {
  if constexpr (UC == 1) {
    v[0] = egm::to_f32(p[0]);
  } else if constexpr (sizeof(T) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  }
}

template <typename T, int UC>
__device__ __forceinline__ void store_unit(T* p, const float (&v)[UC]) {
  if constexpr (UC == 1) {
    p[0] = egm::from_f32<T>(v[0]);
  } else if constexpr (sizeof(T) == 2) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <typename T, int UC>
__device__ __forceinline__ void add_unit(float (&s)[UC], const T* p) {
  float v[UC];
  load_unit<T, UC>(p, v);
#pragma unroll
  for (int c = 0; c < UC; ++c) s[c] = __fadd_rn(s[c], v[c]);
}

// s / 9 rounded to nearest, the bits of __fdiv_rn(s, 9.f), without IEEE
// division's slow path, which a zero or tiny dividend takes (a map after a
// ReLU sums to zero often): one product by RN(1/9) and one FMA correction.
// probe/div9.cu holds it against __fdiv_rn on every float32.  A dividend
// outside [2^-120, 2^127] (subnormal quotients, infinities, NaN) takes
// __fdiv_rn itself; a zero keeps its sign.
__device__ __forceinline__ float div9(float s) {
  constexpr float z = 1.f / 9.f;
  const float q = __fmul_rn(s, z);
  const float a = fabsf(s);
  if (!(a >= 0x1p-120f && a <= 0x1p127f)) return a == 0.f ? q : __fdiv_rn(s, 9.f);
  return __fmaf_rn(__fmaf_rn(-q, 9.f, s), z, q);
}

struct Args {
  const void* x;
  void* out;
  int H, W, C;
  int CV;  // units a pixel
  int TW;  // pixels of a tile
  int R;   // rows of a band
};

// UC channels a unit: 16 / sizeof(T) (vec16) or 1 (scalar)
template <typename T, int UC>
__global__ void __launch_bounds__(NT) eafe_edge_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int CV = a.CV, W = a.W, H = a.H;
  const int slot = (a.TW + 2) * CV * UC;  // elements of a staged row
  const int x0 = blockIdx.x * a.TW;
  const int tw = min(a.TW, W - x0);
  const int y0 = blockIdx.y * a.R;
  const int rows = min(a.R, H - y0);
  const int row_elems = W * a.C;
  const long long img = (long long)blockIdx.z * H * row_elems;
  const T* x = static_cast<const T*>(a.x) + img;
  T* out = static_cast<T*>(a.out) + img;
  const int tid = threadIdx.x;
  const int ns = (tw + 2) * CV;  // units staged a row
  const int first = (x0 - 1) * CV;  // unit index in the image row of staged unit 0
  const int limit = W * CV;

  // staged row j holds input row y0 - 1 + j in ring slot j % SLOTS
  auto stage = [&](int j) {
    const int y = y0 - 1 + j;
    T* dst = ring + (j % SLOTS) * slot;
    const bool row_in = y >= 0 && y < H;
    const T* src_row = x + (row_in ? y : 0) * row_elems;
    for (int u = tid; u < ns; u += NT) {
      const int g = first + u;  // staged pixel in the image iff 0 <= g < W CV
      const bool ok = row_in && g >= 0 && g < limit;
      const T* src = ok ? src_row + g * UC : x;
      if constexpr (UC > 1) {
        egm::mma::cp_async_16(egm::mma::smem_addr(dst + u * UC), src, ok);
      } else {
        dst[u] = ok ? *src : egm::from_f32<T>(0.f);
      }
    }
  };

  const int nst = rows + 2;
#pragma unroll
  for (int j = 0; j < PF + 2; ++j) {
    if (j < nst) stage(j);
    egm::mma::cp_async_commit();
  }
  const int ni = tw * CV;  // edge units a row
  T* orow = out + y0 * row_elems + x0 * a.C;
  for (int r = 0; r < rows; ++r, orow += row_elems) {
    // groups committed: PF + 2 + r; rows r .. r + 2 (the first r + 3) landed
    egm::mma::cp_async_wait<PF - 1>();
    __syncthreads();
    // slot (r + PF + 2) % SLOTS held row r - 1, which no thread reads past
    // the barrier
    if (r + PF + 2 < nst) stage(r + PF + 2);
    egm::mma::cp_async_commit();
    const T* top = ring + (r % SLOTS) * slot;
    const T* mid = ring + ((r + 1) % SLOTS) * slot;
    const T* bot = ring + ((r + 2) % SLOTS) * slot;
    for (int i = tid; i < ni; i += NT) {
      float s[UC], ctr[UC];
#pragma unroll
      for (int c = 0; c < UC; ++c) s[c] = 0.f;
      add_unit<T, UC>(s, top + i * UC);
      add_unit<T, UC>(s, top + (i + CV) * UC);
      add_unit<T, UC>(s, top + (i + 2 * CV) * UC);
      add_unit<T, UC>(s, mid + i * UC);
      load_unit<T, UC>(mid + (i + CV) * UC, ctr);
#pragma unroll
      for (int c = 0; c < UC; ++c) s[c] = __fadd_rn(s[c], ctr[c]);
      add_unit<T, UC>(s, mid + (i + 2 * CV) * UC);
      add_unit<T, UC>(s, bot + i * UC);
      add_unit<T, UC>(s, bot + (i + CV) * UC);
      add_unit<T, UC>(s, bot + (i + 2 * CV) * UC);
      float e[UC];
#pragma unroll
      for (int c = 0; c < UC; ++c)
        e[c] = __fsub_rn(ctr[c], egm::round_to<T>(div9(s[c])));
      store_unit<T, UC>(orow + i * UC, e);
    }
  }
  egm::mma::cp_async_wait<0>();
}

template <typename T, int UC>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto kern = eafe_edge_kernel<T, UC>;
  const int smem = SLOTS * (a.TW + 2) * a.CV * UC * (int)sizeof(T);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.W + a.TW - 1) / a.TW, (a.H + a.R - 1) / a.R, B);
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const Args& a, int B, int vec, cudaStream_t stream) {
  constexpr int UC = 16 / sizeof(T);
  if (vec == 16) {
    if (a.C % UC != 0 || reinterpret_cast<uintptr_t>(a.x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(a.out) % 16 != 0 || a.CV != a.C / UC)
      return (int)cudaErrorInvalidValue;
    return launch<T, UC>(a, B, stream);
  }
  if (vec != 1 || a.CV != a.C) return (int)cudaErrorInvalidValue;
  return launch<T, 1>(a, B, stream);
}

}  // namespace

// x, out [B,H,W,C] (dtype 0 float32, 1 bfloat16), out = x - avg3x3(x).  vec
// 16 (16-byte units of 16 / itemsize channels; C a multiple of it, x and out
// 16-byte aligned) or 1 (one channel a unit); TW pixels a tile and R rows a
// band as ops/cuda/edge.py::eafe_edge_tile and eafe_edge_bands give them.
// Returns a cudaError_t.
extern "C" int egm_eafe_edge(const void* x, void* out, int B, int H, int W, int C, int vec,
                             int TW, int R, int dtype, void* stream) {
  if ((long long)B * H * W * C == 0) return (int)cudaSuccess;
  if (TW < 1 || R < 1 || B > 65535 || (H + R - 1) / R > 65535 ||
      (long long)H * W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int uc = vec == 16 ? 16 / (dtype == egm::kFloat32 ? 4 : 2) : 1;
  const Args a{x, out, H, W, C, C / uc, TW, R};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egm::kFloat32) return run<float>(a, B, vec, s);
  if (dtype == egm::kBFloat16) return run<__nv_bfloat16>(a, B, vec, s);
  return (int)cudaErrorInvalidValue;
}
