// The anti-aliased SnakeBeta activation of BigVGAN's AMP blocks, fused:
// 2x up-sampling, SnakeBeta and 2x down-sampling of a tile in one pass.
//
// Replaces no kernel of the JAX package, which has no BigVGAN. Added for
// BigVGAN-v2 (arXiv:2206.04658; NVIDIA/BigVGAN activations.py and
// alias_free_activation/torch/{act,filter,resample}.py), whose generator
// calls this activation 109 times (6 per AMP block, 18 blocks, and one
// before conv_post). Per channel of a (B, C, T) tensor, f32 inside:
//
//   up     u[n] = 2 sum_k f[k] xp[p], n + 15 = 2p + k, xp = x replicate-
//          padded by 5 (conv_transpose1d, stride 2, cropped 15 a side):
//          u[2i+1] = 2 (f0 x[i+3] + f2 x[i+2] + ... + f10 x[i-2]),
//          u[2i+2] = 2 (f1 x[i+3] + f3 x[i+2] + ... + f11 x[i-2]),
//          x's index clamped to [0, T);
//   snake  s = u + sin^2(u e^alpha) / (e^beta + 1e-9);
//   down   y[t] = sum_k f[k] s[clamp(2t + k - 5, 0, 2T - 1)] (conv1d,
//          stride 2, s replicate-padded by 5 and 6).
//
// What bounds it on an H100: device memory. It reads x and writes y once
// (4 bytes an element in bf16) and does 24 multiply-adds and two sines an
// element; the unfused PyTorch chain (pad, transposed conv, scale, crop,
// the snake's elementwise ops, pad, conv) moves the 2x signal through
// device memory seven or more times.
//
// Design. A block of 128 threads owns 1024 outputs of one (b, c) row. The
// samples at 2x come in pairs (s[2m+1], s[2m+2]), both made from the six
// inputs x[m-2 .. m+3]. Phase 1: each thread makes 8 pairs from 13 inputs
// held in registers (its own 16-byte chunk of x and the tail of the chunk
// before it, two vector loads), and five threads make the 5 pairs past the
// tile; the pairs go to shared memory, one slot of padding every 8 so that
// threads 8 pairs apart hit distinct banks. Phase 2: each thread sums its
// 8 outputs from 13 pairs, each pair feeding up to 6 of them, and stores
// them with one 16-byte store (bf16). Nothing at 2x reaches device memory.
// The 12 taps (the up taps times 2, exact) are kernel parameters, e^alpha
// and 1 / (e^beta + 1e-9) per block in registers. bf16 takes the sine
// through the special-function unit (__sinf: an absolute error near 1e-6,
// far below bf16's rounding); f32 takes sinf.
//
// Blocks at a row's edges, and rows whose length is no multiple of 8, take
// the general path: scalar loads with the index clamped (x's replicate
// padding), the pairs whose samples lie outside [0, 2T) replaced by s[0] or
// s[2T-1] (the replicate padding at 2x), masked scalar stores.
//
// Layout: x and y contiguous (B, C, T); alpha and beta (C,) in x's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tk_amp {

constexpr int kThreads = 128;
constexpr int kRun = 8;                        // outputs (and pairs) a thread
constexpr int kTile = kThreads * kRun;         // outputs a block
constexpr int kPairs = kTile + 5;              // pairs a block makes
constexpr int kSlots = kPairs + kPairs / 8 + 1;

struct Taps {
  float up[12];    // 2 x the filter
  float down[12];  // the filter
};

__device__ __forceinline__ int slot(int p) { return p + (p >> 3); }

__device__ __forceinline__ int clampi(int i, int hi) {
  return i < 0 ? 0 : (i > hi ? hi : i);
}

template <typename T>
struct IO;

template <>
struct IO<float> {
  static constexpr bool kFastSine = false;
  __device__ static float load(const float* p) { return __ldg(p); }
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    amp_act_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const T* __restrict__ alpha, const T* __restrict__ beta,
                   int C, int Tlen, long long tiles, int aligned,
                   const Taps taps) {
  constexpr bool kFast = IO<T>::kFastSine;
  __shared__ float2 pairs[kSlots];
  const long long row = blockIdx.x / tiles;
  const int t0 = (int)(blockIdx.x - row * tiles) * kTile;
  const int c = (int)(row % C);
  const T* xr = x + row * (long long)Tlen;
  T* yr = y + row * (long long)Tlen;
  const float a = expf(IO<T>::load(alpha + c));
  const float ib = 1.0f / (expf(IO<T>::load(beta + c)) + 1e-9f);
  const int k = threadIdx.x;
  const int g = t0 + kRun * k;   // this thread's chunk of x, and of y
  // no clamping, no replicate padding at 2x and whole 16-byte chunks
  const bool interior = aligned && t0 >= kRun && t0 + kTile + kRun <= Tlen;

  // Phase 1: pairs m = t0 - 3 + 8k + j from xs[j .. j + 5], xs[i] =
  // x[g - 5 + i].
  float xs[13];
  if (interior) {
    float prev[8];
    IO<T>::load8(xr + g - kRun, prev);
    IO<T>::load8(xr + g, xs + 5);
#pragma unroll
    for (int i = 0; i < 5; ++i) xs[i] = prev[3 + i];
  } else {
#pragma unroll
    for (int i = 0; i < 13; ++i)
      xs[i] = IO<T>::load(xr + clampi(g - 5 + i, Tlen - 1));
  }
  float2* mine = pairs + 9 * k;   // slot(8k + j) = 9k + j for j < 8
#pragma unroll
  for (int j = 0; j < kRun; ++j)
    mine[j] = make_pair<kFast>(xs + j, a, ib, taps);
  if (k < 5) {   // pairs m = t0 + 1021 + k, past the threads' runs
    float w[6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      w[i] = IO<T>::load(xr + clampi(t0 + kTile - 5 + k + i, Tlen - 1));
    pairs[slot(kTile + k)] = make_pair<kFast>(w, a, ib, taps);
  }
  __syncthreads();

  if (!interior) {
    // s outside [0, 2T) is s[0] (pairs m <= -1) or s[2T - 1] (m >= T - 1)
    const int base = t0 - 3;
    const int pl = -1 - base;       // pair m = -1: (s[-1], s[0])
    const int pr = Tlen - 1 - base; // pair m = T - 1: (s[2T - 1], s[2T])
    const float s0 = pl >= 0 ? pairs[slot(pl)].y : 0.f;
    const float sl = pr < kPairs ? pairs[slot(pr)].x : 0.f;
    __syncthreads();
    for (int p = k; p < kPairs; p += kThreads) {
      if (p <= pl)
        pairs[slot(p)] = make_float2(s0, s0);
      else if (p >= pr)
        pairs[slot(p)] = make_float2(sl, sl);
    }
    __syncthreads();
  }

  // Phase 2: y[g + r] = sum_q f[2q] P[8k + r + q].x + f[2q + 1] P[..].y.
  float acc[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) acc[r] = 0.f;
#pragma unroll
  for (int q = 0; q < kRun + 5; ++q) {
    const float2 P = mine[q + (q >> 3)];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
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
    for (int r = 0; r < kRun; ++r)
      if (g + r < Tlen) IO<T>::store(yr + g + r, acc[r]);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, const void* alpha,
                   const void* beta, long long rows, int C, int Tlen,
                   int aligned, const Taps& taps, cudaStream_t stream) {
  const long long tiles = (Tlen + kTile - 1) / kTile;
  const long long blocks = rows * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  amp_act_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const T*>(alpha), static_cast<const T*>(beta), C, Tlen,
      tiles, aligned, taps);
  return cudaGetLastError();
}

}  // namespace tk_amp

// x, y: contiguous (rows / C, C, T) in bf16 (is_bf16) or f32; alpha, beta:
// (C,) log-scale parameters in the same dtype; filter: the 12 taps.
// aligned: T is a multiple of 8 and x and y start on 16 bytes (the
// vector path). Returns a cudaError_t value: 0 on a successful launch.
extern "C" int tk_amp_act(const void* x, void* y, const void* alpha,
                          const void* beta, int is_bf16, long long rows,
                          int C, int Tlen, int aligned, const float* filter,
                          void* stream) {
  using namespace tk_amp;
  if (rows < 1 || C < 1 || Tlen < 1 || rows % C)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < 12; ++i) {
    taps.up[i] = 2.0f * filter[i];
    taps.down[i] = filter[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(x, y, alpha, beta, rows, C,
                                                Tlen, aligned, taps, s)
                       : launch<float>(x, y, alpha, beta, rows, C, Tlen,
                                       aligned, taps, s));
}

extern "C" const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
