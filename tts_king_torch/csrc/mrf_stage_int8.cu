// One HiFi-GAN MRF stage with int8 weights and activations, fused: the mean
// over ResBlock1 branches of
//     3 x [lrelu 0.1 -> conv(k, dilation d) -> lrelu 0.1 -> conv(k, 1) -> + residual]
// for inputs of C <= 128 channels, f32 or bf16, inference only.
//
// Replaces: tts_king_tpu/ops/pallas/mrf_packed.py, fused_mrf_packed in int8
// mode (taps.dtype == int8; kernel body `kernel`, _quant at :215, the
// dequantization at :261). Weights arrive quantized per output channel (the
// wrapper's quantize_mrf_stage); before every conv the activations lrelu(h)
// are quantized with one scale sx = max(max |lrelu(h)|, 1e-6) / 127 over the
// conv's whole window, rounded half up and clipped to [-127, 127]; products
// are s8 x s8 -> s32 on the tensor cores (mma.sync m16n8k32); the sum is
// dequantized in f32 as (acc -> f32) * (sx * wscale[c]) + bias, rounded to
// the stage dtype, and rows outside [0, T) are zeroed.
//
// The windows are the TPU kernel's: one block per (batch item, TPU tile of
// TS = r * tile time steps); branch b's first conv covers the tile widened
// by ext[b] steps a side, and each conv shrinks the window by its packed
// halo r * ceil(c d / r) a side (the wrapper passes these). A conv computes
// exactly the next conv's window, so its epilogue also reduces
// max |lrelu(output)| over it, which is the next conv's sx: no extra pass.
// A branch's first conv takes its max in the pass that loads x.
//
// What bounds it on an H100: 2 * 21 * 6 * C^2 int8 operations per time step
// of a stage against a few bytes in and out, so arithmetic (1,979 dense int8
// TOP/s). Why the design is not the bf16 kernel's (csrc/mrf_stage.cu): a
// scale is a max over a window of ~136-146 k values at the shipped width,
// far more than one block's 227 KB of shared memory holds beside the
// residual. So the window's activations (h and the conv-1 output, in the
// stage dtype; exact, since every conv output is rounded to it) live in a
// per-block scratch in device memory that the wrapper allocates, and each
// conv sweeps its window in passes of 128 (C = 128) or 256 output rows:
// load the rows plus the conv's reach (16-byte loads, several in flight a
// thread), quantize them into shared memory, multiply against the conv's
// taps (all k taps resident in shared memory, loaded once per conv),
// dequantize with sx * wscale and the bias staged in shared memory, add the
// bias, mask, add the residual (read for a whole row before any write),
// write back. The phases of a pass run one after another in a block, and
// at C = 128 one block fills an SM's shared memory, so nothing overlaps
// them there: the kernel is bound by that latency and by the instructions
// of the quantization and the epilogue, not by the tensor cores. No
// cp.async, TMA or wgmma, and the window is not kept in a cluster's
// distributed shared memory: simple and right first.
//
// Rounding follows the plain version (ops/kernels/mrf_int8.py) operation by
// operation: IEEE division for the scales and the quantization, and
// __fmul_rn / __fadd_rn in the dequantization so that nvcc does not
// contract it into an FMA. The branch mean divides by the branch count.
//
// Layout: x and y are (B, T, C) views given by element strides (a (B, C, T)
// tensor is read in place). Taps: for each conv, branch-major and in chain
// order [convs1_0, convs2_0, ...], a (k, Cp, Cp) int8 block
// [tap][c_out][c_in]; scales and biases (n_convs, Cp) f32; zero past C.
// Cp is 32, 64 or 128. The scratch holds 2 * (TS + 2 * lmax) * Cp elements
// per block, rows of Cp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBranch = 4;
constexpr int kMaxDil = 4;
constexpr int kMaxConv = 2 * kMaxDil;
constexpr int kPad = 16;                    // bytes after each int8 row
constexpr int kWarps = 16;                  // a block's warps
constexpr int kThreads = 32 * kWarps;
// shared header: one float per warp for the block max, then sx * wscale
// and the bias per channel
constexpr int kHeader = 4 * (kWarps + 2 * 128);
constexpr int kUnroll = 4;                  // 16-byte loads in flight a thread
constexpr float kSlope = 0.1f;

#ifdef TK_PROFILE_PHASES
// Phase marks, for scripts/probe_mrf_int8.py: thread 0 of each block adds
// the cycles since its previous mark to the counter of the phase that the
// mark closes. A mark with sync waits for the whole block first, so the
// profiled kernel is a little slower than the plain build.
__device__ unsigned long long g_phase_cycles[7];
__shared__ long long s_mark;
#define TK_MARK_START() \
  do { if (threadIdx.x == 0) s_mark = clock64(); } while (0)
#define TK_MARK(i, sync)                                                  \
  do {                                                                    \
    if (sync) __syncthreads();                                            \
    if (threadIdx.x == 0) {                                               \
      const long long now = clock64();                                    \
      atomicAdd(&g_phase_cycles[i], (unsigned long long)(now - s_mark)); \
      s_mark = now;                                                       \
    }                                                                     \
  } while (0)
#else
#define TK_MARK_START() do { } while (0)
#define TK_MARK(i, sync) do { } while (0)
#endif

struct Plan {
  int nb;                                   // branches
  int nd;                                   // dilation pairs per branch
  int ks[kMaxBranch];
  int dil[kMaxDil];
  int halo[kMaxBranch][kMaxConv];           // steps each conv trims a side
  int ext[kMaxBranch];                      // first window's half-extension
  int lmax;                                 // max ext: scratch row 0 offset
  int kmax;
  long long toff[kMaxBranch][kMaxConv];     // byte offset of a conv's taps
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T> __device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : round_to<T>(v * kSlope);
}

// How many warps share a 16-row m-tile, each taking a slice of the output
// channels: a pass covers 16 * kWarps / split rows.
__host__ __device__ constexpr int split_for(int Cp) {
  return Cp >= 128 ? 2 : 1;
}
// Blocks resident on an SM: C = 128 fills its shared memory with one; at
// C = 32 two blocks (registers capped at 64, a few spilled) overlap their
// phases, which C = 64 loses again to its spills.
__host__ __device__ constexpr int blocks_for(int Cp) {
  return Cp <= 32 ? 2 : 1;
}

// 8 consecutive values of T at a 16-byte-aligned address, as f32, and back.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// v holds values of T (exactly representable).
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (__float_as_uint(v[2 * i]) >> 16) |
           (__float_as_uint(v[2 * i + 1]) & 0xffff0000u);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Two adjacent values of T, as f32 (load) or from f32 (store, rounding).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

// q = clip(floor(a / sx + 0.5), -127, 127), as the plain version rounds.
__device__ __forceinline__ uint32_t quant(float a, float sx) {
  float q = floorf(__fadd_rn(__fdiv_rn(a, sx), 0.5f));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ float act_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
}

__host__ __device__ inline long long smem_bytes(int kmax, int cdmax, int Cp) {
  return kHeader + (long long)kmax * Cp * (Cp + kPad) +
         (long long)(16 * kWarps / split_for(Cp) + 2 * cdmax) *
             (Cp + kPad);
}

// Max of m over the block; every thread gets it.
__device__ float block_max(float m, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __syncthreads();   // the previous call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One conv over output rows [olo, ohi) of the scratch (row 0 is time step
// g0; rows of Cp elements). CONV1: out = mask(dequant(conv(q(lrelu(in))))).
// Otherwise (conv 2): out = mask(out + mask(dequant(...))), in place: each
// element of out is read and then written by one thread. Returns the block
// max of |lrelu(out)| over the rows written: the next conv's window.
//
// Each pass quantizes input rows [p0 - c d, p1 + c d) into shared memory
// (act, rows of Cp + 16 bytes: a fragment load's 8 rows fall in distinct
// banks), 8 channels a thread with kUnroll 16-byte loads in flight, and
// each warp multiplies one 16-row m-tile by its NT / WN n-tiles of 8 output
// channels (WN warps share an m-tile), over the k taps and Cp / 32
// k-steps. Fragment layouts are those
// of the PTX ISA for mma.m16n8k32 .s8 (.row A, .col B, s32 C): lane = 4 * g
// + t; A bytes 4t..4t+3 of rows g and g + 8, then the same at +16; B bytes
// 4t..4t+3 and 16+4t.. of column g. The epilogue reads a row's residuals
// for all n-tiles before it writes any, so their loads are in flight
// together.
template <typename T, bool CONV1, int NT, int WN>
__device__ float conv_int8(const T* __restrict__ in, T* __restrict__ out,
                           const int8_t* __restrict__ tg,
                           const float* __restrict__ sc,
                           const float* __restrict__ bi, int8_t* wsm,
                           int8_t* act, float* red, int k, int d, int olo,
                           int ohi, float sx, int g0, int Tlen) {
  constexpr int Cp = NT * 8;
  constexpr int WS = Cp + kPad;
  constexpr int kRows = 16 * kWarps / WN;
  constexpr int kOct = Cp / 8;
  constexpr int NTW = NT / WN;   // n-tiles a warp computes
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % (kWarps / WN), wn = warp / (kWarps / WN);
  const int g = lane >> 2, t = lane & 3;
  const int cd = (k - 1) / 2 * d;

  // this conv's k taps into shared memory, [tap][c_out] rows of WS bytes
  __syncthreads();
  {
    constexpr int kVec = Cp / 16;
    const uint4* src = reinterpret_cast<const uint4*>(tg);
    for (int e = tid; e < k * Cp * kVec; e += kThreads)
      *reinterpret_cast<uint4*>(wsm + (e / kVec) * WS + (e % kVec) * 16) =
          src[e];
  }
  float* ssc = red + kWarps;   // sx * wscale[c], then the bias, per channel
  float* sbi = ssc + Cp;
  for (int c = tid; c < Cp; c += kThreads) {
    ssc[c] = __fmul_rn(sx, sc[c]);
    sbi[c] = bi[c];
  }
  TK_MARK(1, true);   // taps and scales staged

  float m = 0.f;
  for (int p0 = olo; p0 < ohi; p0 += kRows) {
    const int p1 = min(p0 + kRows, ohi);
    const T* a_src = in + (size_t)(p0 - cd) * Cp;
    const int total = (p1 - p0 + 2 * cd) * kOct;
    __syncthreads();   // the previous pass is done with act; taps are in
    for (int e0 = tid; e0 < total; e0 += kThreads * kUnroll) {
      float v[kUnroll][8];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total) load8(a_src + (size_t)e * 8, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= total) continue;
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo |= quant(lrelu<T>(v[u][j]), sx) << (8 * j);
          hi |= quant(lrelu<T>(v[u][4 + j]), sx) << (8 * j);
        }
        *reinterpret_cast<uint2*>(act + (e / kOct) * WS + (e % kOct) * 8) =
            make_uint2(lo, hi);
      }
    }
    __syncthreads();
    TK_MARK(2, false);   // quantized (and the previous pass done)

    const int r0 = p0 + wm * 16;
    if (r0 < p1) {
      // rows past p1 repeat the last row; their results are dropped
      const int la = min(r0 + g, p1 - 1) - p0;
      const int lb = min(r0 + g + 8, p1 - 1) - p0;
      int acc[NTW][4];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
      for (int j = 0; j < k; ++j) {
        // act row of output row o at tap j: (o - p0) + j d
        const int8_t* pa = act + (la + j * d) * WS + 4 * t;
        const int8_t* pb = act + (lb + j * d) * WS + 4 * t;
        const int8_t* pw =
            wsm + (size_t)(j * Cp + wn * NTW * 8 + g) * WS + 4 * t;
#pragma unroll
        for (int kk = 0; kk < Cp; kk += 32) {
          const uint32_t a0 = ld32(pa + kk), a1 = ld32(pb + kk);
          const uint32_t a2 = ld32(pa + kk + 16), a3 = ld32(pb + kk + 16);
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
            const int8_t* w = pw + nt * 8 * WS + kk;
            mma_s8(acc[nt], a0, a1, a2, a3, ld32(w), ld32(w + 16));
          }
        }
      }
      TK_MARK(3, false);   // warp 0's products

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + g + 8 * h;
        if (row >= p1) continue;
        const int gt = g0 + row;
        const bool valid = gt >= 0 && gt < Tlen;
        T* o = out + (size_t)row * Cp + wn * NTW * 8 + 2 * t;
        float2 res[NTW];
        if (!CONV1 && valid) {
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) res[nt] = load2(o + nt * 8);
        }
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const int co = (wn * NTW + nt) * 8 + 2 * t;
          float v0 = 0.f, v1 = 0.f;
          if (valid) {
            const float2 s = *reinterpret_cast<const float2*>(ssc + co);
            const float2 bb = *reinterpret_cast<const float2*>(sbi + co);
            v0 = round_to<T>(__fadd_rn(
                __fmul_rn(__int2float_rn(acc[nt][2 * h]), s.x), bb.x));
            v1 = round_to<T>(__fadd_rn(
                __fmul_rn(__int2float_rn(acc[nt][2 * h + 1]), s.y), bb.y));
            if (!CONV1) {
              v0 = round_to<T>(res[nt].x + v0);
              v1 = round_to<T>(res[nt].y + v1);
            }
          }
          store2(o + nt * 8, v0, v1);
          m = fmaxf(m, fmaxf(fabsf(lrelu<T>(v0)), fabsf(lrelu<T>(v1))));
        }
      }
      TK_MARK(4, false);   // warp 0's epilogue
    }
  }
  const float amax = block_max(m, red);
  TK_MARK(5, false);   // the last pass's wait and the block max
  return amax;
}

template <typename T, int NT, int WN>
__global__ void __launch_bounds__(kThreads, blocks_for(NT * 8))
mrf_int8_kernel(const T* __restrict__ x, T* __restrict__ y,
                T* __restrict__ scratch, const int8_t* __restrict__ taps,
                const float* __restrict__ scales,
                const float* __restrict__ biases, Plan plan, int Tlen, int C,
                int TS, int n_tiles, long long xsb, long long xst,
                long long xsc, long long ysb, long long yst, long long ysc) {
  constexpr int Cp = NT * 8;
  constexpr int kOct = Cp / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);
  int8_t* wsm = reinterpret_cast<int8_t*>(smem_raw + kHeader);
  int8_t* act = wsm + (size_t)plan.kmax * Cp * (Cp + kPad);

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int R = TS + 2 * plan.lmax;
  T* A = scratch + (size_t)(b * n_tiles + tile) * 2 * R * Cp;   // h
  T* Bf = A + (size_t)R * Cp;                                    // conv 1 out
  const int t0 = tile * TS;
  const int g0 = t0 - plan.lmax;   // time step of scratch row 0
  const T* xb = x + b * xsb;
  T* yb = y + b * ysb;
  const int tid = threadIdx.x;
  const int nconv = 2 * plan.nd;
  const int noct = (C + 7) / 8;   // octets of channels holding data
  TK_MARK_START();

  for (int br = 0; br < plan.nb; ++br) {
    const int k = plan.ks[br];
    int lo = plan.lmax - plan.ext[br];
    int hi = plan.lmax + TS + plan.ext[br];

    // x rows [lo, hi) into A, 8 channels a thread, zeros outside [0, T)
    // and past C; the first conv's max. Neighbouring threads take
    // neighbouring time steps when x is (B, C, T) in memory.
    __syncthreads();
    float m = 0.f;
    const int nrows = hi - lo;
    for (int e = tid; e < nrows * kOct; e += kThreads) {
      int r, oc;
      if (xst == 1) { r = e % nrows; oc = e / nrows; }
      else { r = e / kOct; oc = e % kOct; }
      const int gt = g0 + lo + r;
      const bool in_t = gt >= 0 && gt < Tlen;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = oc * 8 + j;
        v[j] = in_t && ch < C ? to_f<T>(xb[(long long)gt * xst + ch * xsc])
                              : 0.f;
        m = fmaxf(m, fabsf(lrelu<T>(v[j])));
      }
      store8(A + (size_t)(lo + r) * Cp + oc * 8, v);
    }
    float sx = act_scale(block_max(m, red));
    TK_MARK(0, false);   // x loaded, its max taken

    for (int i = 0; i < nconv; ++i) {
      const int n = br * nconv + i;
      const int d = (i % 2 == 0) ? plan.dil[i / 2] : 1;
      const int h = plan.halo[br][i];
      const int8_t* tg = taps + plan.toff[br][i];
      const float* sc = scales + (size_t)n * Cp;
      const float* bi = biases + (size_t)n * Cp;
      float amax;
      if (i % 2 == 0)
        amax = conv_int8<T, true, NT, WN>(A, Bf, tg, sc, bi, wsm, act, red,
                                          k, d, lo + h, hi - h, sx, g0, Tlen);
      else
        amax = conv_int8<T, false, NT, WN>(Bf, A, tg, sc, bi, wsm, act, red,
                                           k, d, lo + h, hi - h, sx, g0, Tlen);
      sx = act_scale(amax);
      lo += h;
      hi -= h;
    }
    // A rows [lmax, lmax + TS) hold the branch output (block_max synced)

    // branch mean, accumulated in y: y = h0; y = y + h1; ...; y = (y + hn) / n
    const bool first = br == 0, last = br == plan.nb - 1;
    const int tt = min(TS, Tlen - t0);
    for (int e = tid; e < tt * noct; e += kThreads) {
      int r, oc;
      if (yst == 1) { r = e % tt; oc = e / tt; }
      else { r = e / noct; oc = e % noct; }
      T* dst = yb + (long long)(t0 + r) * yst;
      float v[8], prev[8];
      load8(A + (size_t)(plan.lmax + r) * Cp + oc * 8, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = oc * 8 + j;
        prev[j] = !first && ch < C ? to_f<T>(dst[ch * ysc]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = oc * 8 + j;
        if (ch >= C) continue;
        float w = v[j];
        if (!first) w = round_to<T>(prev[j] + w);
        if (last) w = w / (float)plan.nb;
        dst[ch * ysc] = from_f<T>(w);
      }
    }
    TK_MARK(6, true);   // branch mean
  }
}

template <typename T, int NT>
cudaError_t launch(const void* x, void* y, void* scratch, const void* taps,
                   const void* scales, const void* biases, const Plan& plan,
                   int cdmax, int B, int Tlen, int C, int TS, int n_tiles,
                   long long xsb, long long xst, long long xsc, long long ysb,
                   long long yst, long long ysc, cudaStream_t stream) {
  constexpr int WN = split_for(NT * 8);
  const size_t smem = (size_t)smem_bytes(plan.kmax, cdmax, NT * 8);
  cudaError_t err = cudaFuncSetAttribute(
      mrf_int8_kernel<T, NT, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles, B);
  mrf_int8_kernel<T, NT, WN><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<T*>(scratch),
      static_cast<const int8_t*>(taps), static_cast<const float*>(scales),
      static_cast<const float*>(biases), plan, Tlen, C, TS, n_tiles, xsb, xst,
      xsc, ysb, yst, ysc);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs for taps of up to kmax
// and a conv reach of up to cdmax steps a side; the wrapper checks it.
extern "C" long long tk_mrf_int8_smem_bytes(int kmax, int cdmax, int Cp) {
  return smem_bytes(kmax, cdmax, Cp);
}

// halos: nb x (2 nd) steps each conv trims from its window a side, branch-
// major, chain order. Returns a cudaError_t value: 0 on a successful launch.
extern "C" int tk_mrf_stage_int8(const void* x, void* y, void* scratch,
                                 const void* taps, const void* scales,
                                 const void* biases, int is_bf16, int B,
                                 int Tlen, int C, int Cp, int TS, int n_tiles,
                                 int nb, const int* ks, int nd,
                                 const int* dil, const int* halos,
                                 long long xsb, long long xst, long long xsc,
                                 long long ysb, long long yst, long long ysc,
                                 void* stream) {
  if (nb < 1 || nb > kMaxBranch || nd < 1 || nd > kMaxDil || C < 1 ||
      C > Cp || !(Cp == 32 || Cp == 64 || Cp == 128) || TS < 1 || Tlen < 1 ||
      B < 1 || n_tiles < 1 || (long long)n_tiles * TS < Tlen)
    return (int)cudaErrorInvalidValue;
  Plan plan = {};
  plan.nb = nb;
  plan.nd = nd;
  for (int p = 0; p < nd; ++p) {
    if (dil[p] < 1) return (int)cudaErrorInvalidValue;
    plan.dil[p] = dil[p];
  }
  long long off = 0;
  int cdmax = 0;
  for (int br = 0; br < nb; ++br) {
    const int k = ks[br];
    if (k < 1 || k % 2 == 0) return (int)cudaErrorInvalidValue;
    plan.ks[br] = k;
    plan.kmax = k > plan.kmax ? k : plan.kmax;
    int ext = 0;
    for (int i = 0; i < 2 * nd; ++i) {
      const int d = (i % 2 == 0) ? dil[i / 2] : 1;
      const int cd = (k - 1) / 2 * d;
      const int h = halos[br * 2 * nd + i];
      if (h < cd) return (int)cudaErrorInvalidValue;   // reads past the window
      cdmax = cd > cdmax ? cd : cdmax;
      plan.halo[br][i] = h;
      ext += h;
      plan.toff[br][i] = off;
      off += (long long)k * Cp * Cp;
    }
    plan.ext[br] = ext;
    plan.lmax = ext > plan.lmax ? ext : plan.lmax;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
#define TK_LAUNCH(TYPE, NT)                                                   \
  launch<TYPE, NT>(x, y, scratch, taps, scales, biases, plan, cdmax, B, Tlen, \
                   C, TS, n_tiles, xsb, xst, xsc, ysb, yst, ysc, s)
  cudaError_t err;
  if (is_bf16)
    err = Cp == 32 ? TK_LAUNCH(BF, 4) : Cp == 64 ? TK_LAUNCH(BF, 8)
                                                 : TK_LAUNCH(BF, 16);
  else
    err = Cp == 32 ? TK_LAUNCH(float, 4) : Cp == 64 ? TK_LAUNCH(float, 8)
                                                    : TK_LAUNCH(float, 16);
#undef TK_LAUNCH
  return (int)err;
}

#ifdef TK_PROFILE_PHASES
// Copies the 7 phase counters to out (host memory) and zeroes them.
extern "C" int tk_mrf_int8_phase_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[7] = {};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif

extern "C" const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
