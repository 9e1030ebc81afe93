// Fused MCALayer enhancement (module "C"), NHWC, in one pass after the gate
// vectors:
//
//   x_out = x * (g_h + g_w + g_c) / 3            rounded to the working dtype
//   out   = 0.4 x_out + 0.2 (max3 - min3)(x_out) + 0.2 avg3((x_out - avg3 x_out)^2)
//         + 0.1 (1.1 x_out) + 0.1 shuffle_g(x_out)
//
// 3x3 windows, stride 1.  max/min ignore positions outside the image (the
// +-inf padding of the pools), avg divides by 9 with zeros outside
// (count_include_pad), and the variance chain only sums positions inside
// the image, as egm_unet_tpu/ops/pallas/mca.py:93-101 masks them.  Window
// sums are taken as the sum of three row sums, where the plain version adds
// the nine terms in (di, dj) order: the float32 sums differ in the last bits,
// so a bf16 output may round one step the other way, which
// chip_smoke.py::compare's one-step tolerance allows (its records give
// err/tol at every path and edge shape).
//
// Replaces the TPU kernel egm_unet_tpu/ops/pallas/mca.py::mca_fused (body
// _mca_kernel).  That kernel streams (tile_h+4)-row slabs of a gated,
// pre-padded copy of x through VMEM with double-buffered DMAs and does the
// shuffle as a permutation matmul.
//
// Bound: ~40 flops per element against 2 bytes read and 2 written (bf16), so
// device-memory bytes bound the function; what keeps a kernel from that bound
// is the work per element, above all its shared-memory traffic.  The design:
// - Persistent blocks walk tiles of 16 x 14 pixels x 32 channels, three
//   blocks of 256 threads an SM in bf16 (two in float32), so that one block's
//   copies and barriers overlap the others' work.  A tile's raw 20 x 18 halo
//   and its four shuffle runs arrive as five boxes of the TMA unit (zeros
//   outside the image, counted by an mbarrier), its gate rows, columns and
//   channels by 4-byte cp.async.  x is read 1.61 times, mostly from L2.
//   (Two stages and one 512-thread block an SM, with 32 x 14 tiles, ran 15%
//   slower; 768 threads slower still.)
// - Each halo element is gated once, in place in shared memory, exactly as
//   the plain version gates it (((g_h + g_w) + g_c) / 3 correctly rounded in
//   float32, times x, rounded to T), 16 bytes at a time.
// - The window passes run down columns: a thread owns one channel pair of one
//   column and walks 16 or 18 rows, keeping the row sums (and row maxima and
//   minima) of its 3x3 window in registers, so each step reads one new row of
//   three pixels where a flat pass reads nine, and adds four times, not nine.
//   The squared deviations of the 18 x 16 positions the variance needs go to
//   shared memory in float32; the combine walks the 16 x 14 outputs, with the
//   row maxima and minima of its window in registers, taken on the stored
//   bf16 pairs (max and min are exact in T).  The tile's origin is decoded
//   once, by the copy threads, and read by the passes from the stage.
// - With groups = 4 and C % 32 == 0, the shuffle sources of output channels
//   [c0, c0+32) are four runs of eight consecutive channels,
//   k*C/4 + c0/4 .. +7 (k = 0..3): four TMA boxes of 8 channels x the tile's
//   pixels, gated in place with the g_c of the source channel; output channel
//   c0 + 4i + k reads run k's element i.  Any other C or groups, or x or out off the
//   16-byte grid, takes the scalar variant: element loads by all threads, and
//   the shuffle source gathered from device memory and gated where it is used.
// - Divisions by 3 and 9 are a product with the rounded reciprocal and one
//   fused correction, which gives the correctly rounded quotient for every
//   normal float32 (tests/test_torch_mca_up_tiles.py checks every
//   significand), three instructions where an IEEE division takes a dozen.
// - Indices inside a tile are 32-bit; one 64-bit image base per tile.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int TH = 16, TW = 14, CC = 32, NT = 256;
constexpr int HH = TH + 4, HW = TW + 4;  // x_out halo tile, 20 x 18
constexpr int DH = TH + 2, DW = TW + 2;  // squared-deviation tile, 18 x 16
constexpr int CP = CC / 2;               // channel pairs: one thread, one pair
constexpr int NGATE = 2 * CC + HH + HW;  // g_c, g_c of the runs, g_h rows, g_w columns
// the column walks: one per (column, pair)
static_assert(DW * CP == NT, "one squared-deviation walk per thread");
static_assert(TW * CP <= NT, "one output walk per thread");

struct Tile {
  int b, y0, x0, c0;
};

// Shared memory of one block: the stage (x_out halo in T, gated in place;
// the four shuffle runs in T, run-major; gates; the tile's origin), 128-byte
// aligned for the TMA unit, then the float32 squared deviations.
template <typename T>
struct Layout {
  static constexpr int kRaw = HH * HW * CC * (int)sizeof(T);
  static constexpr int kSh = TH * TW * CC * (int)sizeof(T);
  static constexpr int kStage = (kRaw + kSh + NGATE * 4 + (int)sizeof(Tile) + 127) / 128 * 128;
  static constexpr int kD2 = DH * DW * CC * 4;
  static constexpr int kBytes = kStage + kD2;
};

template <typename T>
struct Args {
  const T* x;
  const float* gh;
  const float* gw;
  const float* gc;
  T* out;
  int H, W, C, groups;
  int nty, ntx, ncc, tiles;
};

template <typename T>
__device__ __forceinline__ Tile decode(const Args<T>& a, int t) {
  Tile r;
  r.c0 = (t % a.ncc) * CC;
  t /= a.ncc;
  r.x0 = (t % a.ntx) * TW;
  t /= a.ntx;
  r.y0 = (t % a.nty) * TH;
  r.b = t / a.nty;
  return r;
}

// x / y for y = 3 or 9: q = x * (1/y) is within one ulp, the residual
// x - q*y is exact in one FMA, and one more FMA rounds q + r/y correctly
__device__ __forceinline__ float div_const(float x, float y, float inv) {
  const float q = __fmul_rn(x, inv);
  const float r = __fmaf_rn(-q, y, x);
  return __fmaf_rn(r, inv, q);
}
__device__ __forceinline__ float div3(float x) { return div_const(x, 3.0f, 1.0f / 3.0f); }
__device__ __forceinline__ float div9(float x) { return div_const(x, 9.0f, 1.0f / 9.0f); }

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

template <typename T>
struct alignas(16) Pack16 {
  T v[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Two channels of x_out as stored (bf16 pairs or float2), for the range:
// max and min are exact in T, so they run on the stored pairs (two bf16
// lanes per instruction) and only the results are widened.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using V = float2;
  static __device__ __forceinline__ V load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ V max(V a, V b) {
    return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
  }
  static __device__ __forceinline__ V min(V a, V b) {
    return make_float2(fminf(a.x, b.x), fminf(a.y, b.y));
  }
  static __device__ __forceinline__ V fill(float v) { return make_float2(v, v); }
  static __device__ __forceinline__ float2 widen(V a) { return a; }
};
template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ V load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  static __device__ __forceinline__ V max(V a, V b) { return __hmax2(a, b); }
  static __device__ __forceinline__ V min(V a, V b) { return __hmin2(a, b); }
  static __device__ __forceinline__ V fill(float v) { return __float2bfloat162_rn(v); }
  static __device__ __forceinline__ float2 widen(V a) { return __bfloat1622float2(a); }
};

// two channels of x_out, widened to float32
template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  return Pair<T>::widen(Pair<T>::load(p));
}

__device__ __forceinline__ float2 add2(float2 s, float2 u) {
  return make_float2(__fadd_rn(s.x, u.x), __fadd_rn(s.y, u.y));
}

// Issue the copies of tile t into the stage: the raw halo (zeros outside the
// image) and, VEC, the four shuffle runs as boxes of the TMA unit, counted by
// the mbarrier; the gates (zeros outside) by 4-byte cp.async; the
// tile's origin, decoded once here, after the gates.  The scalar variant
// copies x by plain loads.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(const Args<T>& a, const CUtensorMap* map_x,
                                          const CUtensorMap* map_r, int t, T* raw, T* sh,
                                          float* gates, uint32_t bar) {
  const int tid = threadIdx.x;
  if (VEC && tid >= NGATE) return;  // the copies need a few threads only
  const Tile tl = decode(a, t);
  if (tid == 0) *reinterpret_cast<Tile*>(gates + NGATE) = tl;  // for the passes
  if constexpr (VEC) {
    if (tid == 0) {
      // the stage's last reads and writes (the barrier before) come first
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      egm::mma::mbarrier_expect(bar, Layout<T>::kRaw + Layout<T>::kSh);
      egm::mma::tma_load_4d(egm::mma::smem_addr(raw), map_x, tl.c0, tl.x0 - 2, tl.y0 - 2,
                            tl.b, bar);
      for (int r = 0; r < 4; ++r)
        egm::mma::tma_load_4d(egm::mma::smem_addr(sh + r * TH * TW * 8), map_r,
                              r * (a.C / 4) + tl.c0 / 4, tl.x0, tl.y0, tl.b, bar);
    }
  } else {
    const T* xb = a.x + (size_t)tl.b * a.H * a.W * a.C;
    for (int e = tid; e < HH * HW * CC; e += NT) {
      const int p = e / CC, cl = e % CC;
      const int py = p / HW, px = p - py * HW;
      const int y = tl.y0 + py - 2, xx = tl.x0 + px - 2, c = tl.c0 + cl;
      const bool ok = y >= 0 && y < a.H && xx >= 0 && xx < a.W && c < a.C;
      raw[e] = ok ? xb[(y * a.W + xx) * a.C + c] : egm::from_f32<T>(0.f);
    }
  }
  for (int e = tid; e < NGATE; e += NT) {
    const float* src = a.gh;
    bool ok;
    if (e < CC) {
      const int c = tl.c0 + e;
      ok = c < a.C;
      src = a.gc + tl.b * a.C + c;
    } else if (e < 2 * CC) {  // run-major: entry r*8 + i is channel r*C/4 + c0/4 + i
      const int l = e - CC;
      ok = VEC;
      src = a.gc + tl.b * a.C + (l / 8) * (a.C / 4) + tl.c0 / 4 + l % 8;
    } else if (e < 2 * CC + HH) {
      const int y = tl.y0 + e - 2 * CC - 2;
      ok = y >= 0 && y < a.H;
      src = a.gh + tl.b * a.H + y;
    } else {
      const int xx = tl.x0 + e - 2 * CC - HH - 2;
      ok = xx >= 0 && xx < a.W;
      src = a.gw + tl.b * a.W + xx;
    }
    cp_async_4(egm::mma::smem_addr(gates + e), ok ? src : a.gh, ok);
  }
}

__device__ __forceinline__ float combine(float xi, float mx, float mn, float var, float sh) {
  float o = __fmul_rn(0.4f, xi);
  o = __fadd_rn(o, __fmul_rn(0.2f, __fsub_rn(mx, mn)));
  o = __fadd_rn(o, __fmul_rn(0.2f, var));
  o = __fadd_rn(o, __fmul_rn(0.1f, __fmul_rn(1.1f, xi)));
  return __fadd_rn(o, __fmul_rn(0.1f, sh));
}

// The three passes over a tile whose stage has landed; the kernel puts a
// barrier after each.  gc points at the stage's gates: g_c, g_c of the runs,
// g_h rows, g_w columns.

// the E float32 values o rounded to T into a 16-byte piece (bf16 two at a time)
__device__ __forceinline__ void pack(Pack16<float>& v, const float (&o)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v.v[i] = o[i];
}
__device__ __forceinline__ void pack(Pack16<__nv_bfloat16>& v, const float (&o)[8]) {
  __nv_bfloat162* w = reinterpret_cast<__nv_bfloat162*>(v.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
}

// x_out of the E elements of one 16-byte piece, in place: g points at their E
// gates (16-byte aligned in shared memory)
template <typename T>
__device__ __forceinline__ void gate16(T* piece, float ghw, const float* g) {
  constexpr int E = 16 / (int)sizeof(T);
  Pack16<T>* q = reinterpret_cast<Pack16<T>*>(piece);
  Pack16<T> v = *q;
  float gv[E];
#pragma unroll
  for (int j = 0; j < E / 4; ++j) {
    const float4 t = reinterpret_cast<const float4*>(g)[j];
    gv[4 * j] = t.x, gv[4 * j + 1] = t.y, gv[4 * j + 2] = t.z, gv[4 * j + 3] = t.w;
  }
  float o[E];
#pragma unroll
  for (int i = 0; i < E; ++i)
    o[i] = __fmul_rn(egm::to_f32(v.v[i]), div3(__fadd_rn(ghw, gv[i])));
  pack(v, o);
  *q = v;
}

// 1. gate the halo and, VEC, the shuffle runs, in place, 16 bytes at a time
template <typename T, bool VEC>
__device__ __forceinline__ void gate_pass(T* __restrict__ xo, T* __restrict__ sh,
                                          const float* __restrict__ gc) {
  constexpr int E = 16 / (int)sizeof(T);
  const float* gs = gc + CC;
  const float* gh = gs + CC;
  const float* gw = gh + HH;
  const int tid = threadIdx.x;
  for (int e = tid; e < HH * HW * (CC / E); e += NT) {
    const int p = e / (CC / E), k = e % (CC / E);
    const int py = p / HW, px = p - py * HW;
    gate16(xo + p * CC + k * E, __fadd_rn(gh[py], gw[px]), gc + k * E);
  }
  if constexpr (VEC) {
    // run r of pixel p at sh[(r*TH*TW + p)*8]; unit e: run e / (TH*TW*8/E)
    for (int e = tid; e < TH * TW * (CC / E); e += NT) {
      const int k = e / (TH * TW * 8 / E), u = e % (TH * TW * 8 / E);
      const int p = u / (8 / E);
      const int py = p / TW, px = p - py * TW;
      // run-major gates: the unit's first element is run k's element (u % (8/E)) * E
      gate16(sh + e * E, __fadd_rn(gh[py + 2], gw[px + 2]), gs + k * 8 + (u % (8 / E)) * E);
    }
  }
}

// 2. squared deviation from the 3x3 mean at the DH x DW positions, zero
//    outside the image: thread (column qx, pair) walks the DH rows
template <typename T>
__device__ __forceinline__ void deviation_pass(const Args<T>& a, const Tile& tl,
                                               const T* __restrict__ xo,
                                               float* __restrict__ d2) {
  const int qx = threadIdx.x / CP, cp = threadIdx.x % CP;
  const int xx = tl.x0 + qx - 1;
  const bool col_ok = xx >= 0 && xx < a.W;
  const T* col = xo + qx * CC + 2 * cp;
  // row sums of the window's three rows, and the middle row's centre
  float2 rs[3], mid = make_float2(0.f, 0.f);
  auto row = [&](int r, float2& sum, float2& m) {
    const float2 l = load2(col + (r * HW) * CC), c = load2(col + (r * HW + 1) * CC);
    sum = add2(add2(l, c), load2(col + (r * HW + 2) * CC));
    m = c;
  };
  float2 unused;
  row(0, rs[0], unused);
  row(1, rs[1], mid);
#pragma unroll
  for (int qy = 0; qy < DH; ++qy) {
    float2 next_mid;
    row(qy + 2, rs[2], next_mid);
    const float2 sum = add2(add2(rs[0], rs[1]), rs[2]);
    const int y = tl.y0 + qy - 1;
    float2 v = make_float2(0.f, 0.f);
    if (col_ok && y >= 0 && y < a.H) {
      const float dx = __fsub_rn(mid.x, div9(sum.x));
      const float dy = __fsub_rn(mid.y, div9(sum.y));
      v = make_float2(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    }
    *reinterpret_cast<float2*>(d2 + (qy * DW + qx) * CC + 2 * cp) = v;
    rs[0] = rs[1], rs[1] = rs[2], mid = next_mid;
  }
}

// 3. combine: thread (column px, pair) walks the TH output rows with the
//    variance window's row sums and the range window's row maxima / minima
template <typename T, bool VEC>
__device__ __forceinline__ void combine_pass(const Args<T>& a, const Tile& tl,
                                             const T* __restrict__ xo,
                                             const T* __restrict__ sh,
                                             const float* __restrict__ gc,
                                             const float* __restrict__ d2) {
  const float* gh = gc + 2 * CC;
  const float* gw = gh + HH;
  const int tid = threadIdx.x;
  if (tid < TW * CP) {
    const int px = tid / CP, cp = tid % CP;
    const int xx = tl.x0 + px, c = tl.c0 + 2 * cp;
    if (xx < a.W && c < a.C) {
      using P = Pair<T>;
      using V = typename P::V;
      const bool lft = xx >= 1, rgt = xx + 1 < a.W;
      const V ninf = P::fill(-INFINITY), pinf = P::fill(INFINITY);
      const float* dcol = d2 + px * CC + 2 * cp;
      const T* xcol = xo + (px + 1) * CC + 2 * cp;
      float2 dsum[3];
      V hmax[3], hmin[3], mid[3];
      // the row maxima and minima of halo row r over columns px+1..px+3,
      // positions outside the image left out (a row outside: -inf / +inf)
      auto range_row = [&](int r, V& hx, V& hn, V& m) {
        const V l = P::load(xcol + (r * HW) * CC);
        m = P::load(xcol + (r * HW + 1) * CC);
        const V rr = P::load(xcol + (r * HW + 2) * CC);
        const V l2 = lft ? l : m, r2 = rgt ? rr : m;
        hx = P::max(P::max(l2, m), r2);
        hn = P::min(P::min(l2, m), r2);
        const int y = tl.y0 + r - 2;
        if (y < 0 || y >= a.H) {
          hx = ninf;
          hn = pinf;
        }
      };
      // the row sums of the variance window's squared deviations
      auto dev_row = [&](int r) {
        const float2* q = reinterpret_cast<const float2*>(dcol + (r * DW) * CC);
        return add2(add2(q[0], q[CC / 2]), q[CC]);
      };
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dsum[i] = dev_row(i);
        range_row(1 + i, hmax[i], hmin[i], mid[i]);
      }
      const T* xb = a.x + (size_t)tl.b * a.H * a.W * a.C;
      T* ob = a.out + (size_t)tl.b * a.H * a.W * a.C;
      const int cg = a.C / a.groups;
#pragma unroll
      for (int py = 0; py < TH; ++py) {
        dsum[2] = dev_row(py + 2);
        range_row(py + 3, hmax[2], hmin[2], mid[2]);
        const int y = tl.y0 + py;
        if (y < a.H) {
          const float2 var = add2(add2(dsum[0], dsum[1]), dsum[2]);
          const float2 mx = P::widen(P::max(P::max(hmax[0], hmax[1]), hmax[2]));
          const float2 mn = P::widen(P::min(P::min(hmin[0], hmin[1]), hmin[2]));
          const float2 xi = P::widen(mid[1]);
          const int p = py * TW + px;
          const int off = (y * a.W + xx) * a.C + c;
          if constexpr (VEC) {
            // output channels 2cp, 2cp+1 of the chunk: runs (2cp)%4 and +1,
            // element cp/2
            const int i = cp >> 1, r = (2 * cp) & 3;
            const float s0 = egm::to_f32(sh[(r * TH * TW + p) * 8 + i]);
            const float s1 = egm::to_f32(sh[((r + 1) * TH * TW + p) * 8 + i]);
            store2(ob + off, combine(xi.x, mx.x, mn.x, div9(var.x), s0),
                   combine(xi.y, mx.y, mn.y, div9(var.y), s1));
          } else {
            const float ghw = __fadd_rn(gh[py + 2], gw[px + 2]);
            const float* gcb = a.gc + tl.b * a.C;
            const float xs[2] = {xi.x, xi.y}, mxs[2] = {mx.x, mx.y}, mns[2] = {mn.x, mn.y},
                        vs[2] = {var.x, var.y};
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int ck = c + k;
              if (ck >= a.C) break;
              const int src = (ck % a.groups) * cg + ck / a.groups;
              const float g = div3(__fadd_rn(ghw, gcb[src]));
              const float sv =
                  egm::round_to<T>(__fmul_rn(egm::to_f32(xb[(y * a.W + xx) * a.C + src]), g));
              ob[off + k] = egm::from_f32<T>(combine(xs[k], mxs[k], mns[k], div9(vs[k]), sv));
            }
          }
        }
        dsum[0] = dsum[1], dsum[1] = dsum[2];
        hmax[0] = hmax[1], hmax[1] = hmax[2];
        hmin[0] = hmin[1], hmin[1] = hmin[2];
        mid[0] = mid[1], mid[1] = mid[2];
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 3 : 2)
mca_tile_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_r, const Args<T> a) {
  using L = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bar;
  T* raw = reinterpret_cast<T*>(smem);
  T* sh = reinterpret_cast<T*>(smem + L::kRaw);
  float* gates = reinterpret_cast<float*>(smem + L::kRaw + L::kSh);
  float* d2 = reinterpret_cast<float*>(smem + L::kStage);
  const uint32_t bar_addr = egm::mma::smem_addr(&bar);
  if (VEC && threadIdx.x == 0) {
    egm::mma::mbarrier_init(bar_addr, 1);
    egm::mma::fence_async_proxy();
  }
  __syncthreads();

  int t = blockIdx.x;
  if (t < a.tiles) load_tile<T, VEC>(a, &map_x, &map_r, t, raw, sh, gates, bar_addr);
  egm::mma::cp_async_commit();
  for (int it = 0; t < a.tiles; t += gridDim.x, ++it) {
    egm::mma::cp_async_wait<0>();
    if constexpr (VEC) egm::mma::mbarrier_wait(bar_addr, it & 1);
    __syncthreads();
    const Tile tl = *reinterpret_cast<const Tile*>(gates + NGATE);
    gate_pass<T, VEC>(raw, sh, gates);
    __syncthreads();
    deviation_pass<T>(a, tl, raw, d2);
    __syncthreads();
    combine_pass<T, VEC>(a, tl, raw, sh, gates, d2);
    __syncthreads();  // the stage is refilled next
    if (t + (int)gridDim.x < a.tiles)
      load_tile<T, VEC>(a, &map_x, &map_r, t + gridDim.x, raw, sh, gates, bar_addr);
    egm::mma::cp_async_commit();
  }
  egm::mma::cp_async_wait<0>();
}

// A tensor map over x as [C, W, H, B] (innermost first) with boxes of
// bc x bw x bh x 1 elements, no swizzle, zeros out of bounds.
// cuTensorMapEncodeTiled is looked up through the runtime.
template <typename T>
bool make_map(CUtensorMap* map, const T* x, int B, int H, int W, int C, int bc, int bw, int bh) {
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
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {C * e, (cuuint64_t)W * C * e, (cuuint64_t)H * W * C * e};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapDataType dt =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return encode(map, dt, 4, const_cast<T*>(x), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool VEC>
int launch(const Args<T>& a, int B, cudaStream_t stream) {
  CUtensorMap map_x{}, map_r{};
  if (VEC && !(make_map<T>(&map_x, a.x, B, a.H, a.W, a.C, CC, HW, HH) &&
               make_map<T>(&map_r, a.x, B, a.H, a.W, a.C, 8, TW, TH)))
    return (int)cudaErrorInvalidValue;
  auto kern = mca_tile_kernel<T, VEC>;
  const int smem = Layout<T>::kBytes;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  kern<<<a.tiles < slots ? a.tiles : slots, NT, smem, stream>>>(map_x, map_r, a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, const float* gh, const float* gw, const float* gc, void* out, int B,
        int H, int W, int C, int groups, int vec, cudaStream_t stream) {
  Args<T> a{static_cast<const T*>(x), gh, gw, gc, static_cast<T*>(out), H, W, C, groups,
            (H + TH - 1) / TH, (W + TW - 1) / TW, (C + CC - 1) / CC, 0};
  const long long tiles = (long long)B * a.nty * a.ntx * a.ncc;
  if (tiles == 0) return (int)cudaSuccess;
  if (tiles >= (1LL << 31) || (long long)H * W * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  if (!vec) return launch<T, false>(a, B, stream);
  const bool fits = groups == 4 && C % CC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return fits ? launch<T, true>(a, B, stream) : (int)cudaErrorInvalidValue;
}

}  // namespace

// x [B,H,W,C] (dtype 0 float32, 1 bfloat16); gates float32 [B,H], [B,W],
// [B,C] after the sigmoid; out like x.  C % groups == 0.  vec 1 takes the
// cp.async variant (groups 4, C % 32 == 0, x and out 16-byte aligned; else
// cudaErrorInvalidValue), 0 the scalar one.
extern "C" int egm_mca_fused(const void* x, const void* gh, const void* gw, const void* gc,
                             void* out, int B, int H, int W, int C, int groups, int vec,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(gh);
  const float* w = static_cast<const float*>(gw);
  const float* c = static_cast<const float*>(gc);
  if (dtype == egm::kFloat32) return run<float>(x, h, w, c, out, B, H, W, C, groups, vec, s);
  if (dtype == egm::kBFloat16)
    return run<__nv_bfloat16>(x, h, w, c, out, B, H, W, C, groups, vec, s);
  return (int)cudaErrorInvalidValue;
}
