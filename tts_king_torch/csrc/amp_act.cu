// The anti-aliased SnakeBeta activation of BigVGAN's AMP blocks, fused:
// the input's sum (a conv's raw output, its bias, the residual), 2x up-
// sampling, SnakeBeta and 2x down-sampling of a tile in one pass. Two
// kernels, one for each layout that BigVGAN holds its signals in, which
// its dtype picks: bf16 signals lie in (B, T, C) memory (amp_act_kernel,
// tiles of time x channels), f32 signals in (B, C, T) (amp_rows_kernel,
// runs along one channel's row).
//
// Replaces no kernel of the JAX package, which has no BigVGAN. Added for
// BigVGAN-v2 (arXiv:2206.04658; NVIDIA/BigVGAN activations.py and
// alias_free_activation/torch/{act,filter,resample}.py), whose generator
// calls this activation 109 times (6 per AMP block, 18 blocks, and one
// before conv_post). Per channel, along time, f32 inside:
//
//   in     x = a + bias[c] + r, summed in f32 (bias and r optional); with
//          r, x is also stored, rounded once (the AMP block's next
//          residual), and the activation reads the f32 sum;
//   up     u[n] = 2 sum_k f[k] xp[p], n + 15 = 2p + k, xp = x replicate-
//          padded by 5 (conv_transpose1d, stride 2, cropped 15 a side):
//          u[2i+1] = 2 (f0 x[i+3] + f2 x[i+2] + ... + f10 x[i-2]),
//          u[2i+2] = 2 (f1 x[i+3] + f3 x[i+2] + ... + f11 x[i-2]),
//          x's index clamped to [0, T);
//   snake  s = u + sin^2(u e^alpha) / (e^beta + 1e-9);
//   down   y[t] = sum_k f[k] s[clamp(2t + k - 5, 0, 2T - 1)] (conv1d,
//          stride 2, s replicate-padded by 5 and 6).
//
// What bounds it on an H100: device memory and the CUDA cores about
// equally. It reads a (and r) and writes y (and the sum) once, 4 bytes an
// element in bf16 (8 with a residual), and does 24 multiply-adds and two
// sines an element; the unfused PyTorch chain (bias add, residual add, pad,
// transposed conv, scale, crop, the snake's elementwise ops, pad, conv)
// moves the 2x signal through device memory seven or more times.
//
// The tile kernel, for the (B, T, C) layout, where a channel's samples lie
// C apart. A block of 256 threads owns a tile of Tt time steps x cc
// channels of one item (cc = 128, 64 or 32 where C is a multiple, else C
// up to 128; Tt = 32 x the 256 / cc segments). Phase 1 loads the tile's
// rows with the +-5-sample halo (rows clamped to [0, T): x's replicate
// padding), 8 channels a thread in 16-byte vectors, adds the bias and the
// residual in f32 and keeps the sums in shared memory as f32; the sums of
// the tile's own rows go to device memory too. Phase 2: thread (segment s,
// channel j) runs down its channel's 32 rows of the tile: a window of 6
// sums in registers makes each pair (s[2m+1], s[2m+2]) of the 2x signal,
// and a window of 6 pairs each output, so each pair is made once (5 more a
// segment, for its edges); nothing at 2x leaves registers. Each output
// goes from registers straight to device memory: threads of a warp hold
// consecutive channels, so a warp's stores of a row are contiguous (64
// bytes) and its reads of a row from shared memory hit distinct banks.
// A tile takes at most 38 KiB of shared memory. Tiles at the
// signal's ends take phase 2's edge path: the pairs whose samples lie
// outside [0, 2T) are replaced by s[0] (pairs m <= -1) or s[2T-1] (m >= T -
// 1), the replicate padding at 2x. Where C is no multiple of 8, or a
// pointer or a batch stride not on 16 bytes, phase 1 loads one element at
// a time.
//
// The row kernel, for the (B, C, T) layout (this activation's first
// design, with the same input sum). A block of 128 threads owns 1024
// outputs of one (b, c) row.
// Phase 1: each thread makes 8 pairs from 13 sums held in registers (its
// own 16-byte chunks of a and r and the tails of the chunks before them),
// stores its own 8 sums where r is given, and five threads make the 5
// pairs past the tile; the pairs go to shared memory, one slot of padding
// every 8 so that threads 8 pairs apart hit distinct banks. Phase 2: each
// thread sums its 8 outputs from 13 pairs, each pair feeding up to 6 of
// them, and stores them with 16-byte stores. Blocks at a row's edges, and
// rows whose length is no multiple of 8, take the general path: scalar
// loads with the index clamped, the pairs outside [0, 2T) replaced as
// above, masked scalar stores.
//
// Both: the 12 taps (the up taps times 2, exact) are kernel parameters,
// e^alpha and 1 / (e^beta + 1e-9) in registers. bf16 takes the sine
// through the special-function unit (__sinf: an absolute error near 1e-6,
// far below bf16's rounding); f32 takes sinf.
//
// Layout: bf16: a, r (B, T, C) with channels contiguous and rows C apart,
// any batch stride; y and the sum contiguous (B, T, C). f32: a, r, y and
// the sum contiguous (B, C, T). bias, alpha and beta (C,), all in the one
// dtype (alpha and beta log-scale).
//
// Beside them, amp_mean_kernel: an upsampling stage's mean over its AMP
// blocks, sum_j (a_j + bias_j + x_j) / n from each block's last conv's raw
// output, that conv's bias and the block's running residual, in one pass
// (the n blocks' last sums and their mean would otherwise take 3 n
// PyTorch passes, n of them broadcasting the bias), in either layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tk_amp {

constexpr int kThreads = 256;
constexpr int kRun = 32;    // outputs a thread makes along time
constexpr int kHalo = 5;    // the filters' one-sided reach at the base rate
constexpr int kMaxDevices = 64;
constexpr int kRowThreads = 128;                 // the row kernel's block
constexpr int kRowRun = 8;                       // its outputs a thread
constexpr int kRowTile = kRowThreads * kRowRun;  // its outputs a block
constexpr int kRowPairs = kRowTile + 5;          // its pairs a block
constexpr int kRowSlots = kRowPairs + kRowPairs / 8 + 1;

struct Taps {
  float up[12];    // 2 x the filter
  float down[12];  // the filter
};

struct Args {
  const void* a;
  const void* bias;   // or null
  const void* res;    // or null
  void* sum;          // written iff res
  void* y;
  const void* alpha;
  const void* beta;
  long long a_bstride, r_bstride;   // elements
  int C, Tlen;
  int cc, segs;                     // channels and segments a tile
  int tiles_c, tiles_t;             // tiles a row: tiles_t (row kernel)
  int vec;                          // 16-byte path
};

constexpr int kMaxParts = 4;   // AMP blocks a stage (BigVGAN-v2: 3)

struct MeanArgs {
  const void* a[kMaxParts];
  const void* bias[kMaxParts];
  const void* x[kMaxParts];
  void* out;
  long long total;   // elements
  long long inner;   // elements a channel's run: 1 (B, T, C) or T (B, C, T)
  int n, C, vec;
};

__device__ __forceinline__ int clampi(int i, int hi) {
  return i < 0 ? 0 : (i > hi ? hi : i);
}

__device__ __forceinline__ int slot(int p) { return p + (p >> 3); }

template <typename T>
struct IO;

template <>
struct IO<float> {
  static constexpr bool kFastSine = false;
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float cvt(float v) { return v; }
  __device__ static void load8(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static void store8(float* p, const float* v) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct IO<__nv_bfloat16> {
  static constexpr bool kFastSine = true;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(p[0]);
  }
  __device__ static __nv_bfloat16 cvt(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ static void load8(const __nv_bfloat16* p, float* v) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    p[0] = __float2bfloat16_rn(v);
  }
  __device__ static void store8(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <bool kFast>
__device__ __forceinline__ float snake(float u, float a, float ib) {
  const float s = kFast ? __sinf(u * a) : sinf(u * a);
  return fmaf(ib, s * s, u);
}

// The pair (s[2m+1], s[2m+2]) from w = x[m-2 .. m+3].
template <bool kFast>
__device__ __forceinline__ float2 make_pair(const float* w, float a, float ib,
                                            const Taps& f) {
  float odd = 0.f, even = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    odd = fmaf(f.up[10 - 2 * j], w[j], odd);
    even = fmaf(f.up[11 - 2 * j], w[j], even);
  }
  return make_float2(snake<kFast>(odd, a, ib), snake<kFast>(even, a, ib));
}

// Phase 2 for one thread: kRun outputs of one channel. col: the channel's
// sums in shared memory, rows cc apart, row 0 holding x[m0 - 2]; pair k
// (m = m0 + k) reads rows k .. k + 5, output i pairs i .. i + 5 and goes
// to ycol, rows C apart (on the edge path only its first rows_left).
template <typename T, bool kEdge>
__device__ __forceinline__ void column(const float* __restrict__ col, int cc,
                                       T* __restrict__ ycol, int C,
                                       int rows_left, float a, float ib,
                                       const Taps& f, int m0, int Tlen,
                                       float s0, float sl) {
  constexpr bool kFast = IO<T>::kFastSine;
  float w[6];
  float2 P[6];
#pragma unroll
  for (int q = 0; q < 5; ++q) w[q] = col[q * cc];
#pragma unroll
  for (int k = 0; k < kRun + 5; ++k) {
    w[5] = col[(k + 5) * cc];
    float2 p = make_pair<kFast>(w, a, ib, f);
    if (kEdge) {
      const int m = m0 + k;
      if (m < 0)
        p = make_float2(s0, s0);
      else if (m >= Tlen - 1)
        p = make_float2(sl, sl);
    }
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      w[q] = w[q + 1];
      P[q] = P[q + 1];
    }
    P[5] = p;
    if (k >= 5) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        acc = fmaf(f.down[2 * q], P[q].x, acc);
        acc = fmaf(f.down[2 * q + 1], P[q].y, acc);
      }
      if (!kEdge || k - 5 < rows_left)
        ycol[(long long)(k - 5) * C] = IO<T>::cvt(acc);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    amp_act_kernel(const Args p, const Taps taps) {
  constexpr bool kFast = IO<T>::kFastSine;
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, Tlen = p.Tlen, cc = p.cc;
  const int ct = blockIdx.x % p.tiles_c;
  const int rest = blockIdx.x / p.tiles_c;
  const int b = rest / p.tiles_t;
  const int Tt = p.segs * kRun;
  const int t0 = (rest - b * p.tiles_t) * Tt;
  const int c0 = ct * cc;
  const int rows = Tt + 2 * kHalo;
  float* xs = smem;                                   // [rows][cc] sums
  const T* a = static_cast<const T*>(p.a) + b * p.a_bstride;
  const T* bias = static_cast<const T*>(p.bias);
  const T* r = p.res ? static_cast<const T*>(p.res) + b * p.r_bstride
                     : nullptr;
  T* sum = p.res ? static_cast<T*>(p.sum) + (long long)b * Tlen * C : nullptr;
  T* y = static_cast<T*>(p.y) + (long long)b * Tlen * C;
  const int tid = threadIdx.x;

  // Phase 1: the sums of rows t0 - 5 .. t0 + Tt + 4 (clamped).
  if (p.vec) {
    const int vpr = cc / 8;
    for (int v = tid; v < rows * vpr; v += kThreads) {
      const int row = v / vpr;
      const int j = (v - row * vpr) * 8;
      const int c = c0 + j;
      if (c >= C) continue;
      const int t = t0 - kHalo + row;
      const int tc = clampi(t, Tlen - 1);
      float s[8];
      IO<T>::load8(a + (long long)tc * C + c, s);
      if (bias) {
        float w[8];
        IO<T>::load8(bias + c, w);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] += w[i];
      }
      if (r) {
        float w[8];
        IO<T>::load8(r + (long long)tc * C + c, w);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] += w[i];
        if (t == tc && row >= kHalo && row < kHalo + Tt)
          IO<T>::store8(sum + (long long)t * C + c, s);
      }
      float4* d = reinterpret_cast<float4*>(xs + row * cc + j);
      d[0] = make_float4(s[0], s[1], s[2], s[3]);
      d[1] = make_float4(s[4], s[5], s[6], s[7]);
    }
  } else {
    for (int v = tid; v < rows * cc; v += kThreads) {
      const int row = v / cc;
      const int j = v - row * cc;
      const int c = c0 + j;
      if (c >= C) continue;
      const int t = t0 - kHalo + row;
      const int tc = clampi(t, Tlen - 1);
      float s = IO<T>::load(a + (long long)tc * C + c);
      if (bias) s += IO<T>::load(bias + c);
      if (r) {
        s += IO<T>::load(r + (long long)tc * C + c);
        if (t == tc && row >= kHalo && row < kHalo + Tt)
          IO<T>::store(sum + (long long)t * C + c, s);
      }
      xs[row * cc + j] = s;
    }
  }
  __syncthreads();

  // Phase 2: thread (segment sg, channel j) makes rows sg kRun .. + kRun - 1.
  if (tid < p.segs * cc) {
    const int sg = tid / cc;
    const int j = tid - sg * cc;
    const int c = c0 + j;
    if (c < C) {
      const float ea = expf(IO<T>::load(static_cast<const T*>(p.alpha) + c));
      const float ib =
          1.0f / (expf(IO<T>::load(static_cast<const T*>(p.beta) + c)) + 1e-9f);
      const float* col = xs + sg * kRun * cc + j;
      T* ycol = y + (long long)(t0 + sg * kRun) * C + c;
      const int rows_left = Tlen - (t0 + sg * kRun);
      const int m0 = t0 + sg * kRun - 3;
      if (t0 >= kHalo && t0 + Tt + kHalo <= Tlen) {
        column<T, false>(col, cc, ycol, C, rows_left, ea, ib, taps, m0, Tlen,
                         0.f, 0.f);
      } else {
        // s[0] = pair -1's second sample (rows 2 .. 7 of the first tile),
        // s[2T-1] = pair T-1's first (rows T - t0 + 2 .. + 7), where the
        // tile reaches them
        float w[6];
        float s0 = 0.f, sl = 0.f;
        if (t0 == 0) {
#pragma unroll
          for (int i = 0; i < 6; ++i) w[i] = xs[(2 + i) * cc + j];
          s0 = make_pair<kFast>(w, ea, ib, taps).y;
        }
        if (Tlen - t0 <= Tt + 2) {
#pragma unroll
          for (int i = 0; i < 6; ++i) w[i] = xs[(Tlen - t0 + 2 + i) * cc + j];
          sl = make_pair<kFast>(w, ea, ib, taps).x;
        }
        column<T, true>(col, cc, ycol, C, rows_left, ea, ib, taps, m0, Tlen,
                        s0, sl);
      }
    }
  }
}

// The row kernel's input sums a[i] + bias (+ r[i]), in f32: one, and the
// 8 from i on (16-byte loads).
template <typename T>
__device__ __forceinline__ float sum1(const T* a, const T* r, float bias,
                                      int i) {
  const float s = IO<T>::load(a + i) + bias;
  return r ? s + IO<T>::load(r + i) : s;
}

template <typename T>
__device__ __forceinline__ void sum8(const T* a, const T* r, float bias,
                                     int i, float* v) {
  IO<T>::load8(a + i, v);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] += bias;
  if (r) {
    float w[8];
    IO<T>::load8(r + i, w);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += w[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    amp_rows_kernel(const Args p, const Taps taps) {
  constexpr bool kFast = IO<T>::kFastSine;
  __shared__ float2 pairs[kRowSlots];
  const int Tlen = p.Tlen;
  const long long row = blockIdx.x / p.tiles_t;
  const int t0 = (int)(blockIdx.x - row * p.tiles_t) * kRowTile;
  const int c = (int)(row % p.C);
  const T* ar = static_cast<const T*>(p.a) + row * Tlen;
  const T* rr =
      p.res ? static_cast<const T*>(p.res) + row * Tlen : nullptr;
  T* sr = p.res ? static_cast<T*>(p.sum) + row * Tlen : nullptr;
  T* yr = static_cast<T*>(p.y) + row * Tlen;
  const float bc =
      p.bias ? IO<T>::load(static_cast<const T*>(p.bias) + c) : 0.f;
  const float a = expf(IO<T>::load(static_cast<const T*>(p.alpha) + c));
  const float ib =
      1.0f / (expf(IO<T>::load(static_cast<const T*>(p.beta) + c)) + 1e-9f);
  const int k = threadIdx.x;
  const int g = t0 + kRowRun * k;   // this thread's chunk of x, and of y
  // no clamping, no replicate padding at 2x and whole 16-byte chunks
  const bool interior =
      p.vec && t0 >= kRowRun && t0 + kRowTile + kRowRun <= Tlen;

  // Phase 1: pairs m = t0 - 3 + 8k + j from xs[j .. j + 5], xs[i] =
  // x[g - 5 + i]; the sums x[g .. g + 7] stored where r is given.
  float xs[13];
  if (interior) {
    float prev[8];
    sum8(ar, rr, bc, g - kRowRun, prev);
    sum8(ar, rr, bc, g, xs + 5);
#pragma unroll
    for (int i = 0; i < 5; ++i) xs[i] = prev[3 + i];
    if (sr) IO<T>::store8(sr + g, xs + 5);
  } else {
#pragma unroll
    for (int i = 0; i < 13; ++i)
      xs[i] = sum1(ar, rr, bc, clampi(g - 5 + i, Tlen - 1));
    if (sr) {
#pragma unroll
      for (int i = 0; i < kRowRun; ++i)
        if (g + i < Tlen) IO<T>::store(sr + g + i, xs[5 + i]);
    }
  }
  float2* mine = pairs + 9 * k;   // slot(8k + j) = 9k + j for j < 8
#pragma unroll
  for (int j = 0; j < kRowRun; ++j)
    mine[j] = make_pair<kFast>(xs + j, a, ib, taps);
  if (k < 5) {   // pairs m = t0 + 1021 + k, past the threads' runs
    float w[6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      w[i] = sum1(ar, rr, bc, clampi(t0 + kRowTile - 5 + k + i, Tlen - 1));
    pairs[slot(kRowTile + k)] = make_pair<kFast>(w, a, ib, taps);
  }
  __syncthreads();

  if (!interior) {
    // s outside [0, 2T) is s[0] (pairs m <= -1) or s[2T - 1] (m >= T - 1)
    const int base = t0 - 3;
    const int pl = -1 - base;        // pair m = -1: (s[-1], s[0])
    const int pr = Tlen - 1 - base;  // pair m = T - 1: (s[2T - 1], s[2T])
    const float s0 = pl >= 0 ? pairs[slot(pl)].y : 0.f;
    const float sl = pr < kRowPairs ? pairs[slot(pr)].x : 0.f;
    __syncthreads();
    for (int q = k; q < kRowPairs; q += kRowThreads) {
      if (q <= pl)
        pairs[slot(q)] = make_float2(s0, s0);
      else if (q >= pr)
        pairs[slot(q)] = make_float2(sl, sl);
    }
    __syncthreads();
  }

  // Phase 2: y[g + r] = sum_q f[2q] P[8k + r + q].x + f[2q + 1] P[..].y.
  float acc[kRowRun];
#pragma unroll
  for (int r = 0; r < kRowRun; ++r) acc[r] = 0.f;
#pragma unroll
  for (int q = 0; q < kRowRun + 5; ++q) {
    const float2 P = mine[q + (q >> 3)];
#pragma unroll
    for (int r = 0; r < kRowRun; ++r) {
      const int d = q - r;
      if (d >= 0 && d <= 5) {
        acc[r] = fmaf(taps.down[2 * d], P.x, acc[r]);
        acc[r] = fmaf(taps.down[2 * d + 1], P.y, acc[r]);
      }
    }
  }
  if (interior) {
    IO<T>::store8(yr + g, acc);
  } else {
#pragma unroll
    for (int r = 0; r < kRowRun; ++r)
      if (g + r < Tlen) IO<T>::store(yr + g + r, acc[r]);
  }
}

// The mean of an upsampling stage's AMP blocks, each block's output left as
// its parts: y = sum_j (a_j + bias_j[c] + x_j) / n, summed in f32 in that
// order and rounded once. a_j: the block's last conv's raw output, x_j its
// running residual, both contiguous like y, (B, T, C) (inner 1) or (B, C,
// T) (inner T). 8 elements a thread in 16-byte vectors (vec: 8 elements
// in a row of C or of T), else one.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    amp_mean_kernel(const MeanArgs p) {
  const long long step = (long long)gridDim.x * kThreads;
  if (p.vec) {
    for (long long i = 8 * ((long long)blockIdx.x * kThreads + threadIdx.x);
         i < p.total; i += 8 * step) {
      const int c = (int)((i / p.inner) % p.C);
      float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < p.n; ++j) {
        float a[8], b[8], x[8];
        const T* bias = static_cast<const T*>(p.bias[j]);
        IO<T>::load8(static_cast<const T*>(p.a[j]) + i, a);
        if (p.inner == 1) {
          IO<T>::load8(bias + c, b);
        } else {
          const float v = IO<T>::load(bias + c);
#pragma unroll
          for (int e = 0; e < 8; ++e) b[e] = v;
        }
        IO<T>::load8(static_cast<const T*>(p.x[j]) + i, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[e] += (a[e] + b[e]) + x[e];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] /= (float)p.n;
      IO<T>::store8(static_cast<T*>(p.out) + i, s);
    }
  } else {
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < p.total; i += step) {
      const int c = (int)((i / p.inner) % p.C);
      float s = 0.f;
      for (int j = 0; j < p.n; ++j)
        s += (IO<T>::load(static_cast<const T*>(p.a[j]) + i) +
              IO<T>::load(static_cast<const T*>(p.bias[j]) + c)) +
             IO<T>::load(static_cast<const T*>(p.x[j]) + i);
      IO<T>::store(static_cast<T*>(p.out) + i, s / (float)p.n);
    }
  }
}

// Channels a tile: a multiple of C where one of 128, 64, 32 is, else C
// itself up to 128, else 32 (the last tile masked).
inline int tile_channels(int C) {
  if (C % 128 == 0) return 128;
  if (C % 64 == 0) return 64;
  if (C % 32 == 0) return 32;
  return C <= 128 ? C : 32;
}

template <typename T>
cudaError_t launch_tiles(Args p, int B, const Taps& taps,
                         cudaStream_t stream) {
  p.cc = tile_channels(p.C);
  p.segs = kThreads / p.cc;
  const int Tt = p.segs * kRun;
  p.tiles_c = (p.C + p.cc - 1) / p.cc;
  p.tiles_t = (p.Tlen + Tt - 1) / Tt;
  const long long blocks = (long long)B * p.tiles_t * p.tiles_c;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // (32 x 256 / cc + 10) cc floats: at most 32 KiB + 40 cc bytes
  const size_t smem = (size_t)(Tt + 2 * kHalo) * p.cc * sizeof(float);
  // as much shared memory an SM as the carveout gives, once a device
  static bool carved[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || !carved[dev]) {
    e = cudaFuncSetAttribute(amp_act_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) carved[dev] = true;
  }
  amp_act_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(p, taps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(Args p, int B, const Taps& taps,
                        cudaStream_t stream) {
  p.tiles_t = (p.Tlen + kRowTile - 1) / kRowTile;
  const long long blocks = (long long)B * p.C * p.tiles_t;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  amp_rows_kernel<T><<<(unsigned)blocks, kRowThreads, 0, stream>>>(p, taps);
  return cudaGetLastError();
}

}  // namespace tk_amp

// bf16 (is_bf16), the tile kernel: a: (B, T, C) rows C apart, batch
// stride a_bstride elements; res: (B, T, C) like a (stride r_bstride) or
// null; sum and y contiguous (B, T, C). vec: C a multiple of 8, every
// pointer on 16 bytes and both batch strides multiples of 8. f32, the row
// kernel: a, res, sum and y contiguous (B, C, T), both batch strides T C;
// vec: T a multiple of 8 and every pointer on 16 bytes. Both: bias (C,) or
// null; sum written with a + bias + res where res is given; alpha, beta:
// (C,) log-scale; filter: the 12 taps. Returns a cudaError_t value: 0 on a
// successful launch.
extern "C" int tk_amp_act(const void* a, const void* bias, const void* res,
                          void* sum, void* y, const void* alpha,
                          const void* beta, int is_bf16, int B, int C,
                          int Tlen, long long a_bstride, long long r_bstride,
                          int vec, const float* filter, void* stream) {
  using namespace tk_amp;
  const long long tc = (long long)Tlen * C;
  if (B < 1 || C < 1 || Tlen < 1 || a_bstride < tc ||
      (res && (r_bstride < tc || !sum)) ||
      (!is_bf16 && (a_bstride != tc || (res && r_bstride != tc))))
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < 12; ++i) {
    taps.up[i] = 2.0f * filter[i];
    taps.down[i] = filter[i];
  }
  Args p{a, bias, res, sum, y, alpha, beta, a_bstride, r_bstride, C, Tlen,
         0, 0, 0, 0, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_tiles<__nv_bfloat16>(p, B, taps, s)
                       : launch_rows<float>(p, B, taps, s));
}

// y = sum_j (a[j] + bias[j] + x[j]) / n over n <= 4 parts, a[j], x[j] and
// y contiguous, of ``total`` elements, (B, T, C) (inner 1) or (B, C, T)
// (inner T), bias[j] (C,); bf16 (is_bf16) or f32. vec: 8 elements of a
// row (C a multiple of 8, or T) and every pointer on 16 bytes.
extern "C" int tk_amp_mean(const void* const* a, const void* const* bias,
                           const void* const* x, int n, void* out,
                           int is_bf16, long long total, int C,
                           long long inner, int vec, void* stream) {
  using namespace tk_amp;
  if (n < 1 || n > kMaxParts || C < 1 || inner < 1 || total < 1 ||
      total % (C * inner))
    return (int)cudaErrorInvalidValue;
  MeanArgs p{};
  for (int j = 0; j < n; ++j) {
    p.a[j] = a[j];
    p.bias[j] = bias[j];
    p.x[j] = x[j];
  }
  p.out = out;
  p.total = total;
  p.inner = inner;
  p.n = n;
  p.C = C;
  p.vec = vec;
  const long long per = vec ? 8 : 1;
  long long blocks = (total / per + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // a grid-stride loop past it
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    amp_mean_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(p);
  else
    amp_mean_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
