// The tensor-core tile engine shared by attention.cu (inference) and
// flash_attention.cu (training): PTX wrappers for cp.async, ldmatrix and
// mma.sync, the 3xTF32 split, the tile loaders and the FlashAttention-2
// style forward kernel.
//
// Products. bf16 operands go through one mma.sync.m16n8k16 (bf16 x bf16,
// f32 accumulate). f32 operands go through 3xTF32 on mma.sync.m16n8k8.tf32:
// each operand x is split into hi, x rounded to TF32, and lo = x - hi (the
// tensor core reads its TF32 bits), and a product accumulates lo*hi + hi*lo
// + hi*hi in f32 (CUTLASS's OpMultiplyAddFastF32, which SDPA's f32 path
// uses too). The dropped lo*lo term and lo's truncation leave about 2^-21
// of each product, so an f32 product keeps f32's accuracy to within a few
// ulps while running on the tensor cores (TF32's own 10-bit rounding never
// reaches a result). ops/kernels/tf32.py emulates it for the CPU tests.
//
// Fragments (g = lane / 4, t = lane % 4). An S tile accumulator of 16 rows
// by 8 columns holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1). In bf16 two
// such tiles are the A operand of the next product as they stand. In tf32
// the A operand wants columns t and t+4 of an 8-wide k-step, so the next
// product's k index is permuted: k = t stands for column 2t and k = t + 4
// for column 2t + 1. The B operand of that product (V, K, Q or dO rows) is
// then read with the same permutation, two scalar shared loads a lane, and
// no accumulator leaves the registers.
//
// Shared memory. Tiles are stored row-major with D padded to DP, a power of
// two (16 <= DP <= 128), plus 16 bytes a row: every row starts on 16 bytes
// for cp.async, the 8 rows an ldmatrix reads fall on distinct banks, and in
// f32 (row stride = 4 mod 16 words) the permuted scalar loads of a warp hit
// 32 distinct banks. Columns D..DP-1 and rows past T are zero-filled by the
// copy itself (cp.async with a source size of 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage throughout (an unnamed namespace): each library that
// includes this header keeps its own kernels, so two libraries built from
// these sources (with different flags, say) never bind to each other's.
namespace tk_attn {
namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 64;       // query rows per forward block, 16 per warp
constexpr int kKeys = 32;       // keys per K/V tile in the forward
constexpr float kMasked = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// Per operand type: elements in 16 bytes, the depth of one mma k-step.
template <typename T> struct Op;
template <> struct Op<float> {
  static constexpr int kVec = 4;
  static constexpr int kK = 8;
};
template <> struct Op<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kK = 16;
};

// Row stride of a shared tile, in elements.
template <typename T, int DP> __host__ __device__ constexpr int ld() {
  return DP + Op<T>::kVec;
}

// The smallest DP that holds a head dim D (D <= 128).
inline int padded_dim(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
}

// Shapes the kernels take: rows of D elements copied in 16-byte chunks, so
// D a multiple of 16 bytes (8 in bf16, 4 in f32), at most 128.
inline bool bad_shape(int B, int H, int T_, int D, int elem_bytes) {
  return D < 1 || D > 128 || (D * elem_bytes) % 16 != 0 || T_ < 1 || B < 1 ||
         H < 1 || (long long)B * H > 65535;
}

// Phase marks, for scripts/probe_attention.py --phases (built with
// -DTK_PROFILE_PHASES): each thread adds the cycles since its previous mark
// to the phase that the mark closes; lane 0 of each warp adds its totals to
// g_phase_cycles when the kernel ends (slots 16-31: attention_round.cuh's
// producer warpgroups). Without the flag they compile away.
constexpr int kPhaseSlots = 32;
#ifdef TK_PROFILE_PHASES
__device__ unsigned long long g_phase_cycles[kPhaseSlots];
#define TK_PHASES long long tk_prev = clock64(), tk_ph[kPhaseSlots] = {};
#define TK_MARK(i)                        \
  do {                                    \
    const long long tk_now = clock64();   \
    tk_ph[i] += tk_now - tk_prev;         \
    tk_prev = tk_now;                     \
  } while (0)
#define TK_PHASES_END()                                                   \
  do {                                                                    \
    if (threadIdx.x % 32 == 0)                                            \
      for (int tk_i = 0; tk_i < kPhaseSlots; ++tk_i)                      \
        atomicAdd(&g_phase_cycles[tk_i], (unsigned long long)tk_ph[tk_i]); \
  } while (0)
#else
#define TK_PHASES
#define TK_MARK(i) \
  do {             \
  } while (0)
#define TK_PHASES_END() \
  do {                  \
  } while (0)
#endif

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (results below 2^-126 flush to 0: such probabilities are
// 0 in the softmax's sums too).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ 3xTF32

// x = hi + lo + O(2^-21 x), hi and lo both read as TF32 values: hi is x
// rounded to TF32, half away from zero (cvt.rna.tf32.f32's rounding, in two
// integer operations: cvt.rna itself took twice the time in the f32
// kernels); lo = x - hi exactly, whose low 13 bits the tensor core drops (a
// truncation of a term below 2^-11 |x|).
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}
__device__ __forceinline__ Split split(uint32_t bits) {
  return split(__uint_as_float(bits));
}

// A fragment (16 x 8) of 4 f32 values, split.
struct FragA {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  const float a[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(a[i]);
    f.hi[i] = s.hi;
    f.lo[i] = s.lo;
  }
  return f;
}

// A B operand (8 x 8) of 2 f32 values a lane, split.
struct FragB {
  Split b0, b1;
};

// One of the three TF32 products of c += a * b (pass 0 and 1 the small
// terms, pass 2 the large one, so the small ones are added first). TR
// exchanges the roles of a and b in the small terms: a transposed tile
// (S^T = K Q^T) then adds each element's terms in the order the
// untransposed one (S = Q K^T) does. A product loop runs each pass over all
// its independent accumulators before the next pass, so no mma waits on the
// one just issued.
template <bool TR = false>
__device__ __forceinline__ void mma_pass(int pass, float c[4], const FragA& a,
                                         const FragB& b) {
  if (pass == 2) mma_tf32(c, a.hi, b.b0.hi, b.b1.hi);
  else if ((pass == 0) != TR) mma_tf32(c, a.lo, b.b0.hi, b.b1.hi);
  else mma_tf32(c, a.hi, b.b0.lo, b.b1.lo);
}

// Two B operands (two 8-row n-tiles) by one ldmatrix.x4 at p (b_off).
__device__ __forceinline__ void ldsm_b2(FragB& x, FragB& y, const float* p) {
  uint32_t r[4];
  ldsm_x4(r, p);
  x = {split(r[0]), split(r[1])};
  y = {split(r[2]), split(r[3])};
}

// The permuted B operand of a product whose k index is a tile's columns
// (k = t is row 2t, k = t + 4 row 2t + 1 of an 8-row step): p points at
// row 2t, column g of the step.
__device__ __forceinline__ FragB lds_b(const float* p, int LD) {
  return {split(p[0]), split(p[LD])};
}

// ------------------------------------------------------------- loading

// Rows [t0, t0 + ROWS) of a strided (T, D) matrix into a shared tile (row
// stride LD, DP columns), by 16-byte cp.async; rows past T and columns past
// D are zero-filled. Thread i copies column chunk i % (DP / kVec) of every
// (kThreads / (DP / kVec))-th row, so its addresses step by a constant. The
// caller commits the group.
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long st,
                                          int t0, int T_, int D) {
  constexpr int kVec = Op<T>::kVec;
  constexpr int kPerRow = DP / kVec;           // chunks of a row
  constexpr int kStep = kThreads / kPerRow;    // rows a pass covers
  constexpr int kPasses = (ROWS + kStep - 1) / kStep;
  constexpr int LD = ld<T, DP>();
  const int r0 = threadIdx.x / kPerRow, c = (threadIdx.x % kPerRow) * kVec;
  const bool col_in = c < D;
  const T* g = src + (long long)(t0 + r0) * st + c;
  T* d = dst + r0 * LD + c;
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    if (ROWS % kStep != 0 && r0 + i * kStep >= ROWS) break;
    const bool ok = col_in && t0 + r0 + i * kStep < T_;
    cp_async16(d + i * kStep * LD, ok ? g : src, ok);
    g += kStep * st;
  }
}

// n f32 values [t0, t0 + n) of a contiguous row into shared memory, zero
// past T. The caller commits the group.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int t0,
                                         int n, int T_) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = t0 + i < T_;
    cp_async4(dst + i, ok ? src + t0 + i : src, ok);
  }
}

// Reads the item's key mask row (mb[t] != 0: padded key) once, handing each
// key to on_key(t, padded) in the thread that read it. Returns whether the
// item has any valid key. Ends with a barrier.
template <typename F>
__device__ __forceinline__ bool scan_keys(const uint8_t* mb, int T_,
                                          F&& on_key) {
  constexpr int kUnroll = 8;   // loads in flight per thread
  int any = 0;
  for (int t0 = threadIdx.x; t0 < T_; t0 += kUnroll * kThreads) {
    uint8_t m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kThreads;
      m[u] = t < T_ ? mb[t] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kThreads;
      if (t >= T_) break;
      on_key(t, m[u]);
      if (!m[u]) any = 1;
    }
  }
  return __syncthreads_or(any) != 0;
}

// Whether a key tile is skipped: it holds no valid key and the item has
// one. Its probabilities are then exp(-1e9 - m) = 0 in f32 for every row,
// so skipping it leaves the result unchanged (and its dK, dV are 0). An
// item with no valid key runs every tile: all its rows average over T.
__device__ __forceinline__ bool skip_tile(bool item_live, bool tile_live) {
  return item_live && !tile_live;
}

// The item's key mask into shared memory (ms[t] = 1: padded key) and, per
// tile of `keys` keys, whether it holds a valid key (live[j]) and whether
// it needs masking at all (mixed[j]: a padded key, or keys past T). Returns
// whether the item has any valid key. Ends with a barrier.
__device__ __forceinline__ bool scan_mask(const uint8_t* mb, int T_, int keys,
                                          uint8_t* ms, uint8_t* live,
                                          uint8_t* mixed, int n_tiles) {
  for (int j = threadIdx.x; j < n_tiles; j += kThreads) {
    live[j] = 0;
    mixed[j] = (j + 1) * keys > T_;
  }
  __syncthreads();
  return scan_keys(mb, T_, [&](int t, uint8_t m) {
    ms[t] = m;
    if (m) mixed[t / keys] = 1;
    else live[t / keys] = 1;
  });
}

// The next key tile after j that the loop runs (skip_tile).
__device__ __forceinline__ int next_tile(int j, bool item_live,
                                         const uint8_t* live, int n_tiles) {
  ++j;
  while (j < n_tiles && skip_tile(item_live, live[j])) ++j;
  return j;
}

// Lane offsets, in elements, of the ldmatrix.x4 row addresses:
// an A operand (16 rows x one k-step): rows lane % 16, second half of the
// k-step for lanes 16-31;
template <typename T> __device__ __forceinline__ int a_off(int lane, int LD) {
  return (lane % 16) * LD + (lane / 16) * Op<T>::kVec;
}
// two B operands (16 rows = two n-tiles of 8, one k-step): rows lane % 8
// (+ 8 for lanes 16-31), second half of the k-step for lanes 8-15, 24-31.
// r[0], r[1] are the first n-tile's b0, b1; r[2], r[3] the second's.
template <typename T> __device__ __forceinline__ int b_off(int lane, int LD) {
  return ((lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * Op<T>::kVec;
}

// x rounded to bf16, to nearest even, as an f32 value (attention_round.cuh).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// q * scale in bf16 with the product rounded to bf16, two at a time.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float sc) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  const float2 f = __bfloat1622float2(v);
  return pack_bf16(f.x * sc, f.y * sc);
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a,
                                                             float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a,
                                                          float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(
    __nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------ forward

// Rows of shared tiles in attn_fwd_kernel: two stages of K and V, and Q
// (f32: read every tile) or, in bf16, Q over stage 1 (read once into
// registers before stage 1 is first filled).
template <typename T, int DP>
__host__ __device__ constexpr size_t fwd_tile_bytes() {
  return sizeof(T) * (size_t)((sizeof(T) == 2 ? 0 : kRows) +
                              4 * kKeys) * ld<T, DP>();
}

// Dynamic shared memory of attn_fwd_kernel: the tiles, the mask and the
// two tile flags.
template <typename T, int DP> size_t fwd_smem(int T_) {
  const int n_tiles = (T_ + kKeys - 1) / kKeys;
  return fwd_tile_bytes<T, DP>() + ((T_ + 15) / 16) * 16 + 2 * n_tiles;
}

// Blocks per SM the forward is built for: bf16 (35 KB of shared memory at
// DP = 128, at most 128 registers a thread) takes four, f32 (101 KB) two.
// (bf16 with 64-key tiles at three blocks an SM: 93.1 against 86.1 us at
// the batched shape, PERF.md.)
template <typename T> constexpr int fwd_min_blocks() {
  return sizeof(T) == 2 ? 4 : 2;
}

// O = softmax(S) V over one block of 64 query rows of one (b, h), with
// S = masked (q * scale) k^T (FLASH = false: q scaled in its own type before
// the product, as the TPU inference kernel does) or S = masked (q k^T) *
// scale in f32 (FLASH = true: the stock flash kernel's order; also writes
// lse = m + log l per row). Padded keys score -1e9, keys past T take no part.
// Probabilities enter P.V in T (bf16: the unnormalized p rounded; f32:
// exact), the row sums l in f32 unrounded.
template <typename T, int DP, bool FLASH>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks<T>())
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const uint8_t* __restrict__ mask,
                T* __restrict__ o, float* __restrict__ lse, int H, int T_,
                int D, long long sb, long long sh, long long st, long long osb,
                long long osh, long long ost, float scale) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int LD = ld<T, DP>();
  constexpr int kK = Op<T>::kK;
  constexpr int kNT = kKeys / 8;   // 8-key column tiles of S
  constexpr int kDT = DP / 8;      // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  T* KV = reinterpret_cast<T*>(smem);   // [stage][K, V][kKeys][LD]
  T* Qs = kBf16 ? KV + 2 * kKeys * LD : KV + 4 * kKeys * LD;
  uint8_t* ms = smem + fwd_tile_bytes<T, DP>();
  const int n_tiles = (T_ + kKeys - 1) / kKeys;
  uint8_t* live = ms + ((T_ + 15) / 16) * 16;
  uint8_t* mixed = live + n_tiles;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const T* kb = k + b * sb + h * sh;
  const T* vb = v + b * sb + h * sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  TK_PHASES

  auto load_kv = [&](int j, int stage) {
    T* Ks = KV + 2 * stage * kKeys * LD;
    load_rows<T, kKeys, DP>(Ks, kb, st, j * kKeys, T_, D);
    load_rows<T, kKeys, DP>(Ks + kKeys * LD, vb, st, j * kKeys, T_, D);
  };
  load_rows<T, kRows, DP>(Qs, q + b * sb + h * sh, st, q0, T_, D);
  cp_async_commit();
  load_kv(0, 0);   // the first tile, before the mask says whether it runs
  cp_async_commit();
  const bool skip = scan_mask(mask + (long long)b * T_, T_, kKeys, ms, live,
                              mixed, n_tiles);
  int j = next_tile(-1, skip, live, n_tiles);
  if (j != 0) {   // tile 0 is all padded: load the first tile that runs
    cp_async_wait<0>();
    __syncthreads();
    load_kv(j, 0);
    cp_async_commit();
  }
  cp_async_wait<1>();   // Q has arrived
  __syncthreads();

  const T* Qw = Qs + warp * 16 * LD;
  // bf16: q * scale rounded to bf16, held in registers for the whole loop.
  uint32_t qf[kBf16 ? DP / 16 : 1][4];
  const float sc = kBf16 ? __bfloat162float(__float2bfloat16_rn(scale))
                         : scale;
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      ldsm_x4(qf[kk], Qw + a_off<T>(lane, LD) + kk * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[kk][i] = scale_bf16x2(qf[kk][i], sc);
    }
    __syncthreads();   // Q is in registers: stage 1 may be filled
  }

  float m_i[2] = {-1e30f, -1e30f}, l_i[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  TK_MARK(0);
  for (int stage = 0; j < n_tiles; stage ^= 1) {
    const int jn = next_tile(j, skip, live, n_tiles);
    if (jn < n_tiles) load_kv(jn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile j has arrived
    __syncthreads();
    TK_MARK(1);
    const T* Ks = KV + 2 * stage * kKeys * LD;
    const T* Vs = Ks + kKeys * LD;
    const int k0 = j * kKeys;

    // S = Q K^T over the tile's keys
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / kK; ++kk) {
      if constexpr (kBf16) {
        uint32_t bf[kNT / 2][4];   // all loads first, then the products
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p)
          ldsm_x4(bf[p], Ks + p * 16 * LD + b_off<T>(lane, LD) + kk * kK);
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p) {
          mma_bf16(s[2 * p], qf[kk], bf[p][0], bf[p][1]);
          mma_bf16(s[2 * p + 1], qf[kk], bf[p][2], bf[p][3]);
        }
      } else {
        uint32_t af[4];
        ldsm_x4(af, Qw + a_off<T>(lane, LD) + kk * kK);
        const float qs = FLASH ? 1.f : sc;   // inference: q * scale in f32
        // (no FMA contraction: the split sees q * scale rounded to f32)
        const FragA a = split_a(__fmul_rn(__uint_as_float(af[0]), qs),
                                __fmul_rn(__uint_as_float(af[1]), qs),
                                __fmul_rn(__uint_as_float(af[2]), qs),
                                __fmul_rn(__uint_as_float(af[3]), qs));
        FragB bk[kNT];
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p)
          ldsm_b2(bk[2 * p], bk[2 * p + 1],
                  reinterpret_cast<const float*>(Ks) + p * 16 * LD +
                      b_off<T>(lane, LD) + kk * kK);
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int n = 0; n < kNT; ++n) mma_pass(pass, s[n], a, bk[n]);
      }
    }

    TK_MARK(2);
    // mask, online softmax (rows g and g + 8 of the warp's 16)
    float mx[2] = {neg_inf(), neg_inf()};
    if (mixed[j]) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + n * 8 + 2 * t4 + c;
          const bool out = key >= T_, padded = !out && ms[key];
#pragma unroll
          for (int e = c; e < 4; e += 2) {
            float x = s[n][e];
            if (out) x = neg_inf();
            else if (padded) x = kMasked;
            else if (FLASH) x *= scale;
            s[n][e] = x;
          }
        }
    } else if (FLASH) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
    float alpha[2], m_log2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // finite: key k0 < T lies in this tile
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = ex2((m_i[r] - m_new) * kLog2e);
      m_i[r] = m_new;
      m_log2[r] = m_new * kLog2e;
      l_i[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // bf16: one FFMA (p is rounded to bf16 next; the rounding of
        // m_i * log2(e) moves p by < 2^-17 relative, and keeps a row with no
        // valid key, m_i = -1e9, uniform); f32: (s - m) exactly
        const float p = kBf16 ? ex2(fmaf(s[n][e], kLog2e, -m_log2[e / 2]))
                              : ex2((s[n][e] - m_i[e / 2]) * kLog2e);
        l_i[e / 2] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];

    TK_MARK(3);
    // O += P V
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        // V^T operands by ldmatrix.trans: matrices (keys 0-7, 8-15) x
        // (columns 0-7, 8-15) of a 16 x 16 block
        const T* vrow = Vs + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                        (lane / 16) * 8;
        constexpr int kPairs = DP / 16, kChunk = kPairs < 4 ? kPairs : 4;
#pragma unroll
        for (int p0 = 0; p0 < kPairs; p0 += kChunk) {
          uint32_t bf[kChunk][4];   // all loads first, then the products
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            ldsm_x4_trans(bf[c], vrow + (p0 + c) * 16);
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            mma_bf16(acc[2 * (p0 + c)], pa, bf[c][0], bf[c][1]);
            mma_bf16(acc[2 * (p0 + c) + 1], pa, bf[c][2], bf[c][3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        // k = t is key 2t, k = t + 4 is key 2t + 1 of this 8-key step
        const FragA a = split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
        const float* v2 = reinterpret_cast<const float*>(Vs) +
                          (kk * 8 + 2 * t4) * LD + g;
        constexpr int kChunk = kDT < 8 ? kDT : 8;
#pragma unroll
        for (int n0 = 0; n0 < kDT; n0 += kChunk) {
          FragB bv[kChunk];
#pragma unroll
          for (int c = 0; c < kChunk; ++c) bv[c] = lds_b(v2 + (n0 + c) * 8, LD);
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int c = 0; c < kChunk; ++c)
              mma_pass(pass, acc[n0 + c], a, bv[c]);
        }
      }
    }
    TK_MARK(4);
    __syncthreads();   // the stage is free for the load two tiles on
    TK_MARK(5);
    j = jn;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  // O through shared memory (the ring is free after the loop's last
  // barrier), then out in 16-byte rows
  T* Os = KV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    const float inv = 1.f / l_i[r];
#pragma unroll
    for (int n = 0; n < kDT; ++n)
      store2<T>(Os + row * LD + n * 8 + 2 * t4, acc[n][2 * r] * inv,
                acc[n][2 * r + 1] * inv);
    const int t = q0 + row;
    if (FLASH && t4 == 0 && t < T_)
      lse[(long long)bh * T_ + t] = m_i[r] + logf(l_i[r]);
  }
  __syncthreads();
  {
    constexpr int kVec = Op<T>::kVec, kPerRow = DP / kVec;
    constexpr int kStep = kThreads / kPerRow;
    const int r0 = threadIdx.x / kPerRow, c = (threadIdx.x % kPerRow) * kVec;
    T* ob = o + b * osb + h * osh;
#pragma unroll
    for (int row = r0; row < kRows; row += kStep) {
      const int t = q0 + row;
      if (t < T_ && c < D)
        *reinterpret_cast<uint4*>(ob + t * ost + c) =
            *reinterpret_cast<const uint4*>(Os + row * LD + c);
    }
  }
  TK_MARK(6);
  TK_PHASES_END();
}

// Allow a kernel the most dynamic shared memory a block may take on this
// device (H100: 227 KB less its static shared memory). Each kernel is
// allowed it once; a launch asks for what its T needs.
template <typename K> cudaError_t allow_max_smem(K kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  return err;
}

template <typename T, int DP, bool FLASH>
cudaError_t launch_fwd_dp(const T* q, const T* k, const T* v,
                          const uint8_t* mask, T* o, float* lse, int B, int H,
                          int T_, int D, long long sb, long long sh,
                          long long st, long long osb, long long osh,
                          long long ost, float scale, cudaStream_t stream) {
  static const cudaError_t allowed =
      allow_max_smem(attn_fwd_kernel<T, DP, FLASH>);
  if (allowed != cudaSuccess) return allowed;
  dim3 grid((T_ + kRows - 1) / kRows, B * H);
  attn_fwd_kernel<T, DP, FLASH><<<grid, kThreads, fwd_smem<T, DP>(T_),
                                  stream>>>(q, k, v, mask, o, lse, H, T_, D,
                                            sb, sh, st, osb, osh, ost, scale);
  return cudaGetLastError();
}

// Launch attn_fwd_kernel at the DP that holds D.
template <typename T, bool FLASH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const uint8_t* mask, void* o, float* lse, int B, int H,
                       int T_, int D, long long sb, long long sh, long long st,
                       long long osb, long long osh, long long ost,
                       float scale, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  T* o_ = static_cast<T*>(o);
  switch (padded_dim(D)) {
    case 16:
      return launch_fwd_dp<T, 16, FLASH>(q_, k_, v_, mask, o_, lse, B, H, T_,
                                         D, sb, sh, st, osb, osh, ost, scale,
                                         stream);
    case 32:
      return launch_fwd_dp<T, 32, FLASH>(q_, k_, v_, mask, o_, lse, B, H, T_,
                                         D, sb, sh, st, osb, osh, ost, scale,
                                         stream);
    case 64:
      return launch_fwd_dp<T, 64, FLASH>(q_, k_, v_, mask, o_, lse, B, H, T_,
                                         D, sb, sh, st, osb, osh, ost, scale,
                                         stream);
    default:
      return launch_fwd_dp<T, 128, FLASH>(q_, k_, v_, mask, o_, lse, B, H, T_,
                                          D, sb, sh, st, osb, osh, ost, scale,
                                          stream);
  }
}

}  // namespace
}  // namespace tk_attn

#ifdef TK_PROFILE_PHASES
// Copies the kPhaseSlots phase counters to out (host memory) and zeroes
// them.
extern "C" int tk_attn_phase_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, tk_attn::g_phase_cycles, sizeof(tk_attn::g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[tk_attn::kPhaseSlots] = {};
  return (int)cudaMemcpyToSymbol(tk_attn::g_phase_cycles, zero, sizeof(zero));
}
#endif
