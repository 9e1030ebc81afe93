// The MCALayer's three gate vectors (kernel K7), NHWC, before K1 applies
// them.  For each image and each axis a of H, W, C:
//
//   avg_a = mean of x over the other two axes
//   std_a = sqrt(mean((x - avg_a)^2) * n / (n - 1))      centred, two passes
//   b_a   = 0.5 (avg_a + std_a) + sigmoid(w0) avg_a + sigmoid(w1) std_a
//   g_a   = sigmoid(conv1d(b_a, k_a, zero padding (k - 1) / 2))
//
// in float32, x read in its own dtype; sigmoid(w) is rounded to the
// parameters' dtype, as torch.sigmoid on them rounds it.
//
// Replaces no TPU kernel: the JAX package computes the gates in plain jnp
// (egm_unet_tpu/nn/attention.py, MCAGate), as the port did in about 45
// PyTorch launches a layer (three float32 copies of x, a broadcast
// subtraction, pow and two means a gate, then the vector tails).
//
// Bound: two reads of x (the centred variance needs the means first), about
// 11 flops an element; device-memory bytes bound it.  The design:
// - Each image's rows are cut into P bands, P from H, W and C alone (about
//   64K elements a band; ops/cuda/gates.py::mca_gates_bands), and
//   every sum is taken in a fixed order inside a band and then over the
//   bands: an image's gates are the same bits whatever batch it is in and
//   wherever it sits there, and no float atomics are used.
// - Three launches.  mca_gate_sums_kernel (pass 1) and mca_gate_devs_kernel
//   (pass 2) split the batch's B * P bands evenly over G blocks, three of 256
//   threads an SM (at the four serving shapes, batch 32, bf16, 0.70 ms
//   against 0.79 at four an SM, whose 64 registers spill in pass 2, and 0.81
//   at two; one H100, 700 W).  Each band leaves its column sums (over H, C)
//   and channel sums (over H, W) in scratch; a row's sum over (W, C) is whole
//   in one band.  In pass 1 the block that finishes an image's last band (an
//   integer counter an image, reset by that block for the next call) reduces
//   the image's band sums into its means, so pass 2 reads W + C means and
//   no block repeats that reduction.  mca_gate_finish_kernel, one block an
//   image and axis, reduces pass 2's band sums and computes the vector.
// - A thread owns 8 channels (one 16-byte load in bf16, two in float32) of
//   one pixel in L lanes a pixel, 256 / L pixels a step: its per-channel
//   sums stay in registers across a band's pixels; a pixel's sum over C is a
//   shuffle over its L lanes, added to the block's per-column sums in shared
//   memory by the one lane that owns that column (no two threads add to one
//   address).  C off the 8-grid or x off the 16-byte grid takes the scalar
//   variant: one channel a chunk, up to 8 chunks a lane.
// - Pass 2 walks each block's bands backwards, so it first reads what pass 1
//   read last, which the 50 MB L2 still holds.
// - Indices inside an image are 32-bit where they fit; row bases 64-bit.
#include "common.cuh"

namespace {

constexpr int NT = 256;     // threads of a pass block
constexpr int NW = NT / 32;
constexpr int RING = 16;    // rows of per-warp row sums held between flushes
constexpr int MAX_CH = 2048;  // channels a block covers (256 lanes x 8)

struct Args {
  const void* x;
  float* scratch;
  int* count;  // [B], zero between calls
  int B, H, W, C;
  int vec;     // 8 channels a chunk (16-byte loads) or 1
  int L, K;    // lanes a pixel (power of two), chunks a lane
  int P;       // bands an image: band p holds rows [p H / P, (p + 1) H / P)
  int G;       // blocks of a pass
};

// Scratch, in floats: row sums and row deviations [B*H], the means [B][W+C],
// then the column and channel sums of pass 1 and pass 2, [B][P][W] and
// [B][P][C].
struct Scratch {
  float *sum_h, *dev_h, *mean, *sum_w, *dev_w, *sum_c, *dev_c;
  __host__ __device__ Scratch(float* p, const Args& a) {
    const long long n = (long long)a.B * a.H;
    const long long nw = (long long)a.B * a.P * a.W, nc = (long long)a.B * a.P * a.C;
    sum_h = p;
    dev_h = sum_h + n;
    mean = dev_h + n;
    sum_w = mean + (long long)a.B * (a.W + a.C);
    dev_w = sum_w + nw;
    sum_c = dev_w + nw;
    dev_c = sum_c + nc;
  }
};

__device__ __forceinline__ float warp_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VEC consecutive channels as float32
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = egm::to_f32(p[0]);
  } else if constexpr (sizeof(T) == 2) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  }
}

// Shared memory of a pass block, in floats: column sums [W][WS], the
// per-channel sums of the pixel lanes [PL][C], the ring of warp row sums
// [RING][NW], its rows (int), and in pass 2 the means of the block's current
// image, [W] and [C].
__host__ __device__ __forceinline__ int lane_slots(int L) { return L > 32 ? L / 32 : 1; }
__host__ __device__ __forceinline__ int pass_smem_floats(int W, int C, int L, int dev) {
  return W * lane_slots(L) + (NT / L) * C + RING * NW + RING + (dev ? W + C : 0);
}

// One pass over the bands of block blockIdx.x.  DEV false: sums of x (pass
// 1); true: sums of squared deviations from the pass-1 means (pass 2), bands
// and rows walked backwards.
template <typename T, int VEC, int KMAX, bool DEV>
__device__ __forceinline__ void gate_pass(const Args& a) {
  // pixel steps whose loads are in flight together: 64 bytes a thread in the
  // 16-byte variant
  constexpr int U = VEC == 1 ? 1 : sizeof(T) == 2 ? 4 : 2;
  constexpr int KV = KMAX * VEC;
  extern __shared__ float smem[];
  __shared__ int last;
  const int L = a.L, PL = NT / L, WS = lane_slots(L);
  const int W = a.W, C = a.C, CH = C / VEC;
  float* wsum = smem;
  float* cbuf = wsum + W * WS;
  float* ring = cbuf + PL * C;
  int* ring_row = reinterpret_cast<int*>(ring + RING * NW);
  float* mean_w = reinterpret_cast<float*>(ring_row + RING);
  float* mean_c = mean_w + W;

  const Scratch s(a.scratch, a);
  float* out_h = DEV ? s.dev_h : s.sum_h;
  float* out_w = DEV ? s.dev_w : s.sum_w;
  float* out_c = DEV ? s.dev_c : s.sum_c;
  const T* x = static_cast<const T*>(a.x);

  const int t = threadIdx.x, cl = t & (L - 1), pl = t / L, warp = t >> 5;
  const long long nb = (long long)a.B * a.P;
  const long long q0 = blockIdx.x * nb / a.G, q1 = (blockIdx.x + 1) * nb / a.G;
  const float nh = (float)((long long)W * C), nw = (float)((long long)a.H * C),
              nc = (float)((long long)a.H * W);
  const int steps = (W + PL - 1) / PL;

  for (int i = t; i < W * WS; i += NT) wsum[i] = 0.f;
  __syncthreads();
  float acc_c[KV], mc[KV];
#pragma unroll
  for (int i = 0; i < KV; ++i) acc_c[i] = 0.f, mc[i] = 0.f;

  // writes the block's column and channel sums of band p of image b, then
  // clears them
  auto flush_band = [&](int b, int p) {
    __syncthreads();
    float* ow = out_w + ((long long)b * a.P + p) * W;
    for (int w = t; w < W; w += NT) {
      float v = 0.f;
      for (int k = 0; k < WS; ++k) v += wsum[w * WS + k], wsum[w * WS + k] = 0.f;
      ow[w] = v;
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int ch = cl + k * L;
      if (k < a.K && ch < CH) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) cbuf[pl * C + ch * VEC + i] = acc_c[k * VEC + i];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc_c[k * VEC + i] = 0.f;
    }
    __syncthreads();
    float* oc = out_c + ((long long)b * a.P + p) * C;
    for (int c = t; c < C; c += NT) {
      float v = 0.f;
      for (int k = 0; k < PL; ++k) v += cbuf[k * C + c];
      oc[c] = v;
    }
    __syncthreads();
  };
  // pass 1: the block that wrote image b's last band sums its P bands, in
  // order, into the image's means
  auto count_band = [&](int b) {
    __threadfence();
    __syncthreads();
    if (t == 0) {
      last = atomicAdd(a.count + b, 1) == a.P - 1;
      if (last) a.count[b] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    float* m = s.mean + (long long)b * (W + C);
    for (int o = t; o < W + C; o += NT) {
      const bool col = o < W;
      const int stride = col ? W : C;
      const float* src = (col ? s.sum_w + (long long)b * a.P * W + o
                              : s.sum_c + (long long)b * a.P * C + (o - W));
      float v = 0.f;
#pragma unroll 8
      for (int k = 0; k < a.P; ++k) v += __ldcg(src + (long long)k * stride);
      m[o] = __fdiv_rn(v, col ? nw : nc);
    }
  };
  // writes the ring's complete row sums (warps in order)
  auto flush_ring = [&](int rows) {
    __syncthreads();
    if (t < rows) {
      float v = 0.f;
      for (int k = 0; k < NW; ++k) v += ring[t * NW + k];
      out_h[ring_row[t]] = v;
    }
    __syncthreads();
  };
  // pass 2: image b's means into shared memory (columns, channels) and
  // registers (this thread's channels)
  auto load_means = [&](int b) {
    const float* m = s.mean + (long long)b * (W + C);
    __syncthreads();
    for (int o = t; o < W + C; o += NT) (o < W ? mean_w[o] : mean_c[o - W]) = m[o];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int ch = cl + k * L;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        mc[k * VEC + i] = (k < a.K && ch < CH) ? mean_c[ch * VEC + i] : 0.f;
    }
  };

  int cur = -1, held = 0;
  for (long long i = 0; i < q1 - q0; ++i) {
    const long long q = DEV ? q1 - 1 - i : q0 + i;
    const int b = (int)(q / a.P), p = (int)(q % a.P);
    if (DEV && b != cur) load_means(b);
    cur = b;
    const int h0 = (int)((long long)p * a.H / a.P);
    const int h1 = (int)((long long)(p + 1) * a.H / a.P);
    for (int hh = 0; hh < h1 - h0; ++hh) {
      const long long r = (long long)b * a.H + (DEV ? h1 - 1 - hh : h0 + hh);
      const T* xr = x + r * W * (long long)C;
      const float mh = DEV ? __fdiv_rn(__ldg(s.sum_h + r), nh) : 0.f;
      float acc_h = 0.f;
      for (int s0 = 0; s0 < steps; s0 += U) {
        float v[U][KV];
        bool ok[U][KMAX];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int w = pl + (s0 + u) * PL;
#pragma unroll
          for (int k = 0; k < KMAX; ++k) {
            const int ch = cl + k * L;
            ok[u][k] = w < W && k < a.K && ch < CH;
            if (ok[u][k]) {
              load_chunk<T, VEC>(xr + w * C + ch * VEC, &v[u][k * VEC]);
            } else {
#pragma unroll
              for (int j = 0; j < VEC; ++j) v[u][k * VEC + j] = 0.f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int w = pl + (s0 + u) * PL;
          float pix = 0.f;
          if constexpr (DEV) {
            const float mw = w < W ? mean_w[w] : 0.f;
#pragma unroll
            for (int k = 0; k < KMAX; ++k) {
              if (!ok[u][k]) continue;
#pragma unroll
              for (int j = 0; j < VEC; ++j) {
                const float xv = v[u][k * VEC + j];
                const float dh = xv - mh, dw = xv - mw, dc = xv - mc[k * VEC + j];
                acc_h = fmaf(dh, dh, acc_h);
                pix = fmaf(dw, dw, pix);
                acc_c[k * VEC + j] = fmaf(dc, dc, acc_c[k * VEC + j]);
              }
            }
          } else {
#pragma unroll
            for (int k = 0; k < KMAX; ++k) {
#pragma unroll
              for (int j = 0; j < VEC; ++j) {
                acc_c[k * VEC + j] += v[u][k * VEC + j];
                pix += v[u][k * VEC + j];
              }
            }
            acc_h += pix;
          }
          pix = warp_sum(pix, L < 32 ? L : 32);
          if (w < W && (cl & 31) == 0) wsum[w * WS + (cl >> 5)] += pix;
        }
      }
      acc_h = warp_sum(acc_h, 32);
      if ((t & 31) == 0) ring[held * NW + warp] = acc_h;
      if (t == 0) ring_row[held] = (int)r;
      if (++held == RING) flush_ring(held), held = 0;
    }
    flush_band(b, p);
    if constexpr (!DEV) count_band(b);
  }
  if (held) flush_ring(held);
}

template <typename T, int VEC, int KMAX>
__global__ void __launch_bounds__(NT, 3) mca_gate_sums_kernel(const Args a) {
  gate_pass<T, VEC, KMAX, false>(a);
}

template <typename T, int VEC, int KMAX>
__global__ void __launch_bounds__(NT, 3) mca_gate_devs_kernel(const Args a) {
  gate_pass<T, VEC, KMAX, true>(a);
}

struct Gate {
  const void* weight;  // [2], the blend's two logits
  const void* conv;    // [k], k odd
  int k;
};

struct FinishArgs {
  Gate gate[3];  // H, W, C
  float* out[3];
  float* stats;  // [B][2][H + W + C] (avg, std), or null
  int pbf16;     // the parameters are bfloat16 (else float32)
};

__device__ __forceinline__ float param(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

// One block an image (blockIdx.x) and axis (blockIdx.y: H, W, C): the means
// and the standard deviations from pass 2's band sums, the blend, the 1-D
// conv and the sigmoid of one vector.
__global__ void __launch_bounds__(NT) mca_gate_finish_kernel(const Args a, const FinishArgs f) {
  extern __shared__ float blend[];  // [the axis's length]
  const int b = blockIdx.x, ax = blockIdx.y, t = threadIdx.x;
  const int m = ax == 0 ? a.H : ax == 1 ? a.W : a.C;
  const long long cnt_n = (long long)a.H * a.W * a.C / m;  // elements a mean takes
  const Scratch s(a.scratch, a);
  const float* pd = ax == 0 ? s.dev_h + (long long)b * a.H
                            : (ax == 1 ? s.dev_w : s.dev_c) + (long long)b * a.P * m;
  const int bands = ax == 0 ? 1 : a.P;  // a row's sums are whole
  const Gate g = f.gate[ax];
  float s0 = sigmoid(param(g.weight, 0, f.pbf16)), s1 = sigmoid(param(g.weight, 1, f.pbf16));
  if (f.pbf16) s0 = egm::round_to<__nv_bfloat16>(s0), s1 = egm::round_to<__nv_bfloat16>(s1);
  const float nf = (float)cnt_n;
  const float bessel = (float)((double)cnt_n / (double)(cnt_n > 1 ? cnt_n - 1 : 1));
  const int off = ax == 0 ? 0 : ax == 1 ? a.H : a.H + a.W;
  const int total = a.H + a.W + a.C;
  for (int p = t; p < m; p += NT) {
    float dev = 0.f;
#pragma unroll 8
    for (int k = 0; k < bands; ++k) dev += pd[(long long)k * m + p];
    const float avg = ax == 0 ? __fdiv_rn(s.sum_h[(long long)b * a.H + p], nf)
                              : s.mean[(long long)b * (a.W + a.C) + (ax == 1 ? p : a.W + p)];
    const float sd = __fsqrt_rn(__fmul_rn(__fdiv_rn(dev, nf), bessel));
    blend[p] = __fadd_rn(__fadd_rn(__fmul_rn(0.5f, __fadd_rn(avg, sd)), __fmul_rn(s0, avg)),
                         __fmul_rn(s1, sd));
    if (f.stats != nullptr) {
      f.stats[(long long)b * 2 * total + off + p] = avg;
      f.stats[(long long)b * 2 * total + total + off + p] = sd;
    }
  }
  __syncthreads();
  const int pad = (g.k - 1) / 2;
  for (int p = t; p < m; p += NT) {
    float v = 0.f;
    for (int q = 0; q < g.k; ++q) {
      const int pos = p + q - pad;
      if (pos >= 0 && pos < m) v = fmaf(param(g.conv, q, f.pbf16), blend[pos], v);
    }
    f.out[ax][(long long)b * m + p] = sigmoid(v);
  }
}

template <typename K>
int prepare(K kern, int smem) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

template <typename T, int VEC, int KMAX>
int launch(const Args& a, const FinishArgs& f, cudaStream_t stream) {
  auto sums = mca_gate_sums_kernel<T, VEC, KMAX>;
  auto devs = mca_gate_devs_kernel<T, VEC, KMAX>;
  const int s1 = 4 * pass_smem_floats(a.W, a.C, a.L, 0);
  const int s2 = 4 * pass_smem_floats(a.W, a.C, a.L, 1);
  const int s3 = 4 * (a.H > a.W ? (a.H > a.C ? a.H : a.C) : (a.W > a.C ? a.W : a.C));
  int err = prepare(sums, s1);
  if (!err) err = prepare(devs, s2);
  if (!err) err = prepare(mca_gate_finish_kernel, s3);
  if (err) return err;
  sums<<<a.G, NT, s1, stream>>>(a);
  devs<<<a.G, NT, s2, stream>>>(a);
  mca_gate_finish_kernel<<<dim3(a.B, 3), NT, s3, stream>>>(a, f);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const Args& a, const FinishArgs& f, cudaStream_t stream) {
  if (a.vec == 8) {
    if (a.C % 8 != 0 || reinterpret_cast<uintptr_t>(a.x) % 16 != 0 || a.K != 1)
      return (int)cudaErrorInvalidValue;
    return launch<T, 8, 1>(a, f, stream);
  }
  if (a.vec != 1 || a.K > 8) return (int)cudaErrorInvalidValue;
  return launch<T, 1, 8>(a, f, stream);
}

}  // namespace

// x [B,H,W,C] (dtype 0 float32, 1 bfloat16); the H, W and C gates'
// parameters (blend logits [2], conv kernels [kh], [kw], [kc], odd; pdtype
// 0 float32, 1 bfloat16); out float32 [B,H], [B,W], [B,C]; stats null or
// float32 [B][2][H+W+C]; scratch float32 of the size
// ops/cuda/gates.py::mca_gates_scratch_floats gives; count int32 [B], zero,
// left zero.  vec 8 or 1, lanes L and chunks K as gates.py::mca_gates_lanes,
// P bands an image as gates.py::mca_gates_bands, G blocks as
// gates.py::mca_gates_schedule.  Returns a cudaError_t.
extern "C" int egm_mca_gates(const void* x, const void* wh, const void* kh, const void* ww,
                             const void* kw, const void* wc, const void* kc, void* gh,
                             void* gw, void* gc, void* stats, void* scratch, void* count,
                             int B, int H, int W, int C, int nkh, int nkw, int nkc, int vec,
                             int L, int K, int P, int G, int dtype, int pdtype,
                             void* stream) {
  if ((long long)B * H * W * C == 0) return (int)cudaSuccess;
  if (C > MAX_CH || L < 1 || L > NT || (L & (L - 1)) != 0 || P < 1 || P > H ||
      G < 1 || (long long)G > (long long)B * P || (long long)B * H >= (1LL << 31) ||
      (long long)W * C >= (1LL << 31) || nkh % 2 == 0 || nkw % 2 == 0 || nkc % 2 == 0 ||
      (pdtype != egm::kFloat32 && pdtype != egm::kBFloat16))
    return (int)cudaErrorInvalidValue;
  const Args a{x, static_cast<float*>(scratch), static_cast<int*>(count), B, H, W, C, vec, L,
               K, P, G};
  const FinishArgs f{{{wh, kh, nkh}, {ww, kw, nkw}, {wc, kc, nkc}},
                     {static_cast<float*>(gh), static_cast<float*>(gw), static_cast<float*>(gc)},
                     static_cast<float*>(stats), pdtype == egm::kBFloat16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egm::kFloat32) return run<float>(a, f, s);
  if (dtype == egm::kBFloat16) return run<__nv_bfloat16>(a, f, s);
  return (int)cudaErrorInvalidValue;
}
