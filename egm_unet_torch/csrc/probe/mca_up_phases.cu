// Where K1 (mca_fused) and K4 (upsample2x_fused) spend their time: clock64
// around each phase, for the first CUDA-core versions (copied here as they
// were before their redesign, with the clocks written in) and for the
// kernels of csrc/mca_fused.cu and csrc/upsample2x.cu (included, with their
// EGM_PHASE marks defined to read the clock), at the four shapes of the EGM-UNet
// forward's path (bf16, batch 8).  There is no ncu on the card this targets.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o mca_up_phases egm_unet_torch/csrc/probe/mca_up_phases.cu
//   ./mca_up_phases
//
// Prints one JSON line per kernel and shape: the instrumented kernel's time
// (CUDA events, mean of 20 launches, clocks included) and each phase's share
// of the clocked cycles.  Block-level phases (separated by __syncthreads) are
// clocked by thread 0 of every block; the old K4 has no barriers, so lane 0 of
// every warp clocks its own phases, each ended by an instruction that needs the
// phase's loads.  Not built by ops/cuda/build.py and not used by the package.
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <vector>

#include "../common.cuh"
#include "../mma.cuh"

__device__ unsigned long long g_phase[8];

#define EGM_PHASE_BEGIN                        \
  long long ph_t = clock64();                  \
  unsigned long long ph_acc[4] = {0, 0, 0, 0};
#define EGM_PHASE(i)                           \
  if (threadIdx.x == 0) {                      \
    const long long ph_n = clock64();          \
    ph_acc[i] += ph_n - ph_t;                  \
    ph_t = ph_n;                               \
  }
#define EGM_PHASE_END                                                    \
  if (threadIdx.x == 0)                                                  \
    for (int ph_i = 0; ph_i < 4; ++ph_i) atomicAdd(&g_phase[ph_i], ph_acc[ph_i]);

namespace k1 {
#include "../mca_fused.cu"
}
namespace k4 {
#include "../upsample2x.cu"
}

namespace old {

// ---- K1's first CUDA version (csrc/mca_fused.cu before the redesign)
constexpr int TH = 8, TW = 8, CC = 32, NT = 256;
constexpr int HH = TH + 4, HW = TW + 4;
constexpr int DH = TH + 2, DW = TW + 2;

template <typename T>
__device__ __forceinline__ float gated(const T* __restrict__ x, const float* __restrict__ gh,
                                       const float* __restrict__ gw,
                                       const float* __restrict__ gc, int b, int y, int xx,
                                       int c, int H, int W, int C) {
  const float g = (gh[b * H + y] + gw[b * W + xx] + gc[b * C + c]) / 3.0f;
  const float v = egm::to_f32(x[(((long long)b * H + y) * W + xx) * C + c]);
  return egm::round_to<T>(__fmul_rn(v, g));
}

template <typename T>
__global__ void __launch_bounds__(NT)
mca_fused_kernel(const T* __restrict__ x, const float* __restrict__ gh,
                 const float* __restrict__ gw, const float* __restrict__ gc,
                 T* __restrict__ out, int H, int W, int C, int groups, int cchunks) {
  __shared__ float xo[HH * HW][CC];
  __shared__ float d2[DH * DW][CC];
  EGM_PHASE_BEGIN
  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int b = blockIdx.z / cchunks;
  const int c0 = (blockIdx.z % cchunks) * CC;
  for (int e = tid; e < HH * HW * CC; e += NT) {
    const int cl = e % CC, p = e / CC;
    const int y = h0 + p / HW - 2, xx = w0 + p % HW - 2, c = c0 + cl;
    float v = 0.f;
    if (y >= 0 && y < H && xx >= 0 && xx < W && c < C)
      v = gated(x, gh, gw, gc, b, y, xx, c, H, W, C);
    xo[p][cl] = v;
  }
  __syncthreads();
  EGM_PHASE(0)
  for (int e = tid; e < DH * DW * CC; e += NT) {
    const int cl = e % CC, q = e / CC;
    const int qy = q / DW, qx = q % DW;
    const int y = h0 + qy - 1, xx = w0 + qx - 1;
    float v = 0.f;
    if (y >= 0 && y < H && xx >= 0 && xx < W) {
      float s = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) s = __fadd_rn(s, xo[(qy + di) * HW + qx + dj][cl]);
      const float d = __fsub_rn(xo[(qy + 1) * HW + qx + 1][cl], s / 9.0f);
      v = __fmul_rn(d, d);
    }
    d2[q][cl] = v;
  }
  __syncthreads();
  EGM_PHASE(1)
  const int cg = C / groups;
  for (int e = tid; e < TH * TW * CC; e += NT) {
    const int cl = e % CC, p = e / CC;
    const int py = p / TW, px = p % TW;
    const int y = h0 + py, xx = w0 + px, c = c0 + cl;
    if (y >= H || xx >= W || c >= C) continue;
    const float xi = xo[(py + 2) * HW + px + 2][cl];
    float mx = xi, mn = xi, var = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        var = __fadd_rn(var, d2[(py + di) * DW + px + dj][cl]);
        const int yy = y + di - 1, xq = xx + dj - 1;
        if (yy >= 0 && yy < H && xq >= 0 && xq < W) {
          const float v = xo[(py + 1 + di) * HW + px + 1 + dj][cl];
          mx = fmaxf(mx, v);
          mn = fminf(mn, v);
        }
      }
    }
    var = var / 9.0f;
    const int src = (c % groups) * cg + c / groups;
    const float sh = gated(x, gh, gw, gc, b, y, xx, src, H, W, C);
    float o = __fmul_rn(0.4f, xi);
    o = __fadd_rn(o, __fmul_rn(0.2f, __fsub_rn(mx, mn)));
    o = __fadd_rn(o, __fmul_rn(0.2f, var));
    o = __fadd_rn(o, __fmul_rn(0.1f, __fmul_rn(1.1f, xi)));
    o = __fadd_rn(o, __fmul_rn(0.1f, sh));
    out[(((long long)b * H + y) * W + xx) * C + c] = egm::from_f32<T>(o);
  }
  __syncthreads();
  EGM_PHASE(2)
  EGM_PHASE_END
}

// ---- K4's first CUDA version (csrc/upsample2x.cu before the redesign), bf16
// 16-byte path, lane 0 of each warp clocking: 0 index math, 1 tap loads,
// 2 the four 16-byte loads, 3 blend, 4 store

__device__ __forceinline__ float blend2(float w_lo, float v_lo, float w_hi, float v_hi) {
  const float s = __fmul_rn(w_lo, v_lo);
  return w_hi != 0.f ? __fadd_rn(s, __fmul_rn(w_hi, v_hi)) : s;
}

struct alignas(16) P8 {
  __nv_bfloat16 v[8];
};

__device__ __forceinline__ long long clk() { return clock64(); }
// an instruction that needs v, so the clock after it waits for v's load
__device__ __forceinline__ void need(uint32_t v) {
  uint32_t sink;
  asm volatile("mov.b32 %0, %1;" : "=r"(sink) : "r"(v));
}

__global__ void __launch_bounds__(256)
upsample2x_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ rlo, const int* __restrict__ rhi,
                  const float* __restrict__ rwl, const float* __restrict__ rwh,
                  const int* __restrict__ clo, const int* __restrict__ chi,
                  const float* __restrict__ cwl, const float* __restrict__ cwh, int B, int h,
                  int w, int C) {
  const int CV = C / 8;
  const int H2 = 2 * h, W2 = 2 * w;
  const long long total = (long long)B * H2 * W2 * CV;
  const long long step = (long long)gridDim.x * 256;
  const bool clocker = (threadIdx.x & 31) == 0;
  unsigned long long acc[5] = {0, 0, 0, 0, 0};
  for (long long idx = (long long)blockIdx.x * 256 + threadIdx.x; idx < total; idx += step) {
    long long t0 = clk();
    const int cv = (int)(idx % CV);
    long long r = idx / CV;
    const int q = (int)(r % W2);
    r /= W2;
    const int p = (int)(r % H2);
    const int b = (int)(r / H2);
    need(cv + q + p + b);
    long long t1 = clk();
    const int r0 = rlo[p], r1 = rhi[p], q0 = clo[q], q1 = chi[q];
    const float a0 = rwl[p], a1 = rwh[p], c0 = cwl[q], c1 = cwh[q];
    need(r0 ^ r1 ^ q0 ^ q1 ^ __float_as_uint(a0) ^ __float_as_uint(a1) ^ __float_as_uint(c0) ^
         __float_as_uint(c1));
    long long t2 = clk();
    const __nv_bfloat16* base = x + (long long)b * h * w * C + (long long)cv * 8;
    const P8 v00 = *reinterpret_cast<const P8*>(base + ((long long)r0 * w + q0) * C);
    const P8 v01 = *reinterpret_cast<const P8*>(base + ((long long)r0 * w + q1) * C);
    const P8 v10 = *reinterpret_cast<const P8*>(base + ((long long)r1 * w + q0) * C);
    const P8 v11 = *reinterpret_cast<const P8*>(base + ((long long)r1 * w + q1) * C);
    need(*reinterpret_cast<const uint32_t*>(&v00) ^ *reinterpret_cast<const uint32_t*>(&v01) ^
         *reinterpret_cast<const uint32_t*>(&v10) ^ *reinterpret_cast<const uint32_t*>(&v11));
    long long t3 = clk();
    P8 res;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float u0 = egm::round_to<__nv_bfloat16>(
          blend2(c0, egm::to_f32(v00.v[i]), c1, egm::to_f32(v01.v[i])));
      if (a1 != 0.f) {
        const float u1 = egm::round_to<__nv_bfloat16>(
            blend2(c0, egm::to_f32(v10.v[i]), c1, egm::to_f32(v11.v[i])));
        res.v[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(a0, u0), __fmul_rn(a1, u1)));
      } else {
        res.v[i] = __float2bfloat16_rn(__fmul_rn(a0, u0));
      }
    }
    need(*reinterpret_cast<const uint32_t*>(&res));
    long long t4 = clk();
    *reinterpret_cast<P8*>(out + (((long long)b * H2 + p) * W2 + q) * C + (long long)cv * 8) =
        res;
    long long t5 = clk();
    acc[0] += t1 - t0;
    acc[1] += t2 - t1;
    acc[2] += t3 - t2;
    acc[3] += t4 - t3;
    acc[4] += t5 - t4;
  }
  if (clocker)
    for (int i = 0; i < 5; ++i) atomicAdd(&g_phase[i], acc[i]);
}

}  // namespace old

// ---------------------------------------------------------------- host

__global__ void fill(__nv_bfloat16* p, long long n, uint32_t seed, float scale) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += (long long)gridDim.x * 256) {
    uint32_t s = (uint32_t)i * 2654435761u ^ seed;
    s ^= s >> 13;
    s *= 0x5bd1e995u;
    s ^= s >> 15;
    p[i] = __float2bfloat16_rn(((s & 0xffffff) / 16777216.0f - 0.5f) * scale);
  }
}
__global__ void fillf(float* p, long long n, uint32_t seed) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += (long long)gridDim.x * 256) {
    uint32_t s = (uint32_t)i * 2246822519u ^ seed;
    s ^= s >> 13;
    s *= 0x5bd1e995u;
    s ^= s >> 15;
    p[i] = (s & 0xffffff) / 16777216.0f;  // gates after a sigmoid: (0, 1)
  }
}

static void reset_phases() {
  unsigned long long z[8] = {0};
  cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}

static void report(const char* name, const char* shape, float ms, const char* const* phases,
                   int n) {
  unsigned long long v[8];
  cudaMemcpyFromSymbol(v, g_phase, sizeof(v));
  double tot = 0;
  for (int i = 0; i < n; ++i) tot += (double)v[i];
  printf("{\"kernel\": \"%s\", \"shape\": \"%s\", \"instrumented_ms\": %.5f, \"phase_share\": {",
         name, shape, ms);
  for (int i = 0; i < n; ++i)
    printf("%s\"%s\": %.4f", i ? ", " : "", phases[i], tot > 0 ? v[i] / tot : 0.0);
  printf("}}\n");
  fflush(stdout);
}

template <class F>
static float time_ms(F f, int reps = 20) {
  f();
  cudaDeviceSynchronize();
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  reset_phases();
  cudaEventRecord(e0);
  for (int i = 0; i < reps; ++i) f();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return ms / reps;
}

// linear_taps(n, 2n, align_corners=True) of ops/resize.py; weights rounded
// to bf16 when `round`
static void taps(int n, bool round, std::vector<int>& lo, std::vector<int>& hi,
                 std::vector<float>& wl, std::vector<float>& wh) {
  const int m = 2 * n;
  lo.resize(m);
  hi.resize(m);
  wl.resize(m);
  wh.resize(m);
  for (int i = 0; i < m; ++i) {
    const double src = m == 1 ? 0.0 : (double)i * (n - 1) / (m - 1);
    const int l = (int)std::floor(src);
    const int hh = l + 1 < n ? l + 1 : n - 1;
    const float frac = (float)(src - l);
    float a = 1.0f - frac, b = hh != l ? frac : 0.0f;
    if (round) {
      a = __bfloat162float(__float2bfloat16_rn(a));
      b = __bfloat162float(__float2bfloat16_rn(b));
    }
    lo[i] = l;
    hi[i] = hh;
    wl[i] = a;
    wh[i] = b;
  }
}

template <class T>
static T* upload(const std::vector<T>& v) {
  T* d;
  cudaMalloc(&d, v.size() * sizeof(T));
  cudaMemcpy(d, v.data(), v.size() * sizeof(T), cudaMemcpyHostToDevice);
  return d;
}

int main() {
  const int B = 8;
  const int k1_shapes[4][3] = {{288, 384, 64}, {144, 192, 128}, {72, 96, 256}, {36, 48, 256}};
  const int k4_shapes[4][3] = {{288, 384, 32}, {144, 192, 64}, {72, 96, 128}, {36, 48, 256}};
  const char* k1_old[] = {"gated_halo_load", "squared_deviations", "combine_and_shuffle"};
  const char* k1_new[] = {"wait_for_tile_load", "gate_in_shared_memory", "squared_deviations",
                          "combine_and_shuffle"};
  const char* k4_old[] = {"index_math", "tap_loads", "four_16B_loads", "blend", "store"};
  const char* k4_new[] = {"stage_taps_and_patch", "blend_and_store"};
  char shape[64];
  for (auto& s : k1_shapes) {
    const int H = s[0], W = s[1], C = s[2];
    const long long n = (long long)B * H * W * C;
    __nv_bfloat16 *x, *out;
    float *gh, *gw, *gc;
    cudaMalloc(&x, n * 2);
    cudaMalloc(&out, n * 2);
    cudaMalloc(&gh, B * H * 4);
    cudaMalloc(&gw, B * W * 4);
    cudaMalloc(&gc, B * C * 4);
    fill<<<1024, 256>>>(x, n, 1u, 4.0f);
    fillf<<<64, 256>>>(gh, B * H, 2u);
    fillf<<<64, 256>>>(gw, B * W, 3u);
    fillf<<<64, 256>>>(gc, B * C, 4u);
    snprintf(shape, sizeof(shape), "%dx%dx%dx%d", B, H, W, C);
    const int cchunks = (C + 31) / 32;
    dim3 grid((W + 7) / 8, (H + 7) / 8, B * cchunks);
    float ms = time_ms([&] {
      old::mca_fused_kernel<__nv_bfloat16><<<grid, 256>>>(x, gh, gw, gc, out, H, W, C, 4,
                                                          cchunks);
    });
    report("mca_fused/first", shape, ms, k1_old, 3);
    ms = time_ms([&] {
      if (k1::egm_mca_fused(x, gh, gw, gc, out, B, H, W, C, 4, 1, egm::kBFloat16, nullptr))
        std::abort();
    });
    report("mca_fused/tile_tma", shape, ms, k1_new, 4);
    cudaFree(x);
    cudaFree(out);
    cudaFree(gh);
    cudaFree(gw);
    cudaFree(gc);
  }
  for (auto& s : k4_shapes) {
    const int h = s[0], w = s[1], C = s[2];
    const long long n = (long long)B * h * w * C;
    __nv_bfloat16 *x, *out;
    cudaMalloc(&x, n * 2);
    cudaMalloc(&out, 4 * n * 2);
    fill<<<1024, 256>>>(x, n, 5u, 4.0f);
    std::vector<int> rl, rh, cl, ch;
    std::vector<float> rwl, rwh, cwl, cwh;
    taps(h, true, rl, rh, rwl, rwh);
    taps(w, false, cl, ch, cwl, cwh);
    int *d_rl = upload(rl), *d_rh = upload(rh), *d_cl = upload(cl), *d_ch = upload(ch);
    float *d_rwl = upload(rwl), *d_rwh = upload(rwh), *d_cwl = upload(cwl),
          *d_cwh = upload(cwh);
    snprintf(shape, sizeof(shape), "%dx%dx%dx%d", B, h, w, C);
    const long long total = 4 * n / 8;
    long long blocks = (total + 255) / 256;
    if (blocks > (1 << 20)) blocks = 1 << 20;
    float ms = time_ms([&] {
      old::upsample2x_kernel<<<(unsigned)blocks, 256>>>(x, out, d_rl, d_rh, d_rwl, d_rwh, d_cl,
                                                        d_ch, d_cwl, d_cwh, B, h, w, C);
    });
    report("upsample2x_fused/first", shape, ms, k4_old, 5);
    const int bq = 256 / (C / 8) > 0 ? 256 / (C / 8) : 1;
    ms = time_ms([&] {
      if (k4::egm_upsample2x(x, out, d_rl, d_rh, d_rwl, d_rwh, d_cl, d_ch, d_cwl, d_cwh, B, h, w,
                         C, bq, 1, egm::kBFloat16, nullptr))
        std::abort();
    });
    report("upsample2x_fused/band_cp_async", shape, ms, k4_new, 2);
    cudaFree(x);
    cudaFree(out);
    for (void* p : {(void*)d_rl, (void*)d_rh, (void*)d_cl, (void*)d_ch, (void*)d_rwl,
                    (void*)d_rwh, (void*)d_cwl, (void*)d_cwh})
      cudaFree(p);
  }
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    fprintf(stderr, "CUDA error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
