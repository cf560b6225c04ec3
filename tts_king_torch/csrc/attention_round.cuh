// The bf16-probability mode (ModelConfig.attention_probs_bf16: the JAX
// package's XLA attention, its normalized probabilities stored in bf16, and
// the gradient jax.vjp gives it), f32, on Hopper's warpgroup MMA. With S =
// (q k^T) * scale, padded keys at -1e9, P = softmax(S) (f32, normalized)
// and round() rounding to bf16:
//
//   forward (round_fwd_kernel)  O = round(P) v, lse = logsumexp(S)
//   dQ (round_dq_kernel)        dP = round(dO v^T), Delta_i = sum_j P_ij dP_ij,
//                               dS = P (dP - Delta), dQ = dS k * scale
//   dK/dV (round_dkdv_kernel)   dV = round(P)^T dO, dK = dS^T q * scale
//
// No TPU kernel of its own: the JAX package computes the mode on its XLA
// route (tts_king_tpu/models/layers.py, MultiHeadAttention's last branch).
// Replaces the port's two-sweep mode of attention_mma.cuh /
// flash_attention.cu, which computed every product with P twice: an online softmax knows P only
// once it has the row's final max and sum, and Delta is no longer
// rowsum(dO * O). Here nothing is computed twice. The forward keeps S: its
// first pass computes S tile by tile (its row max and sum online) and
// writes S to a scratch buffer in device memory; the second reads S back,
// forms round(P) and adds round(P) V. In training it writes P over S, and
// the backward reads P instead of computing S: dQ's first pass computes
// dP, sums Delta and writes round(dP) (bf16) to a second scratch; its second
// pass reads P and round(dP) and adds dS K; dK/dV reads both for its keys.
// Units of one TF32 pass over one product: forward 3 (S) + 2 (round(P) V:
// round(P) is exact in TF32, its low split 0) = 5; backward 3 (dP) + 3
// (dS K) + 2 (dV) + 3 (dK) = 11. Each thread reads back only what it wrote
// itself (S in the forward, round(dP) in dQ), so no pass waits on another
// block or thread; dK/dV reads what the earlier kernels wrote.
//
// What bounds it on an H100: operations (the bound of row 1p counts 5
// units, row 3p's 5 + 11 and P's bytes, as these kernels keep P); the
// scratch moves 4 bytes (S or P) twice in the forward, 4 + 4 in training,
// and 4 + 2 + 2 + 4 + 2 per (query row, valid key) in the backward, which
// the L2 partly keeps (a block's S is read back right after it is
// written).
//
// The engine: consumer warpgroups of 64 rows (query rows; keys in dK/dV)
// and a producer warpgroup per block. The producer streams raw tiles of 32
// rows of K, V, Q or dO by 16-byte cp.async from all its threads into a
// ring guarded by mbarriers (each thread's copies complete on the slot's
// barrier: cp.async.mbarrier.arrive; on an H100, one cp.async.bulk a row
// from one warp ran as fast in the forward and 26% slower in the backward,
// its issue on the producer's path), a few tiles ahead, and splits each
// into TF32 hi and lo planes (attention_mma.cuh's split: hi rounded to
// TF32, lo = x - hi) in the 128-byte-swizzled K-major layout wgmma reads,
// into a second ring of plane buffers with full and empty mbarriers, while
// the consumers run the products of earlier tiles. In the forward and dQ
// the producer gives registers to the consumers (setmaxnreg). Products are
// wgmma.mma_async m64nNk8 tf32 with A from registers: the 3xTF32 passes
// lo*hi, hi*lo, hi*hi (the two small terms in one accumulator set, the
// large in another, so that two chains of dependent products interleave),
// and 2 passes (lo, hi of the B operand) when A is round(P). A = Q or dO
// (split once into registers) against K or V planes gives S or dP; A =
// round(P) or dS, taken from the S or dP accumulators, against transposed
// V or K planes gives O or dQ: an accumulator holds columns 2t and 2t + 1
// of each 8-wide step where an A operand wants t and t + 4, so the
// transposed plane stores the tile's row 2t at column t and row 2t + 1 at
// column t + 4 (PERM), and no accumulator leaves the registers. In dK/dV,
// A = round(P)^T and dS^T come from the P and round(dP) rows that the
// consumers stage themselves (cp.async, two tiles ahead), B = transposed dO
// and Q planes. The forward and dQ run two consumer warpgroups (128 rows)
// on the planes of one producer; dK/dV one (64 keys). Key tiles holding
// only padded keys are skipped (the item has a valid key), as in the
// unrounded kernels; their scratch is never written and dK/dV takes P = 0
// at padded keys.
//
// Scratch layout: (B, H, T, ld) with ld = T rounded up to 64 (the dK/dV
// block's keys), P or S in f32, round(dP) in bf16; Delta (B, H, ld) f32.

#pragma once

#include "attention_mma.cuh"

namespace tk_attn {
namespace {

constexpr int kRTile = 32;               // rows of a streamed tile
constexpr int kRAlign = 1024;            // the swizzle pattern's repeat
// setmaxnreg: the producer's and the consumers' registers; the block holds
// 65536 / 384 rounded down to 8 (168) a thread at launch, and the two
// budgets add up to exactly that (more would block the consumers forever).
constexpr int kProducerRegs = 88;
constexpr int kConsumerRegs = 208;
// The forward and dQ: two consumer warpgroups, 128 query rows a block.
constexpr int kFqWGs = 2;
constexpr int kFqRows = 64 * kFqWGs;
constexpr int kFqThreads = 128 * (kFqWGs + 1);
constexpr int kFqRawSlots = 4, kFqPlaneSlots = 3;
// dK/dV: one consumer warpgroup, 64 keys a block.
constexpr int kKvThreads = 256;
constexpr int kKvSlots = 2;
// dK/dV's staged P (f32) and round(dP) (bf16) rows: 64 keys, padded so that
// a warp's fragment loads fall on distinct banks.
constexpr int kPLd = 72;                 // floats a staged P row
constexpr int kDpLd = 72;                // bf16 a staged round(dP) row

// The head dims the mode's kernels are built for: D padded to 32, 64 or 128.
inline int round_dim(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : 128; }

template <int DP> struct RCfg {
  static_assert(DP == 32 || DP == 64 || DP == 128, "DP");
  static constexpr int kRawLd = DP + 4;                       // floats a raw row
  static constexpr uint32_t kRaw = kRTile * kRawLd * 4;       // a raw tile
  static constexpr uint32_t kPlane = kRTile * DP * 4;         // a plane
  static constexpr int kKSteps = DP / 8;                      // k8 steps over D
  // dK/dV's stage of P (f32), round(dP) (bf16) and Delta rows
  static constexpr uint32_t kStageDp = kRTile * kPLd * 4;
  static constexpr uint32_t kStageDelta = kStageDp + kRTile * kDpLd * 2;
  static constexpr uint32_t kStage = kStageDelta + kRTile * 4;
};

// Dynamic shared memory of the forward and dQ kernels: the alignment pad,
// the plane ring (two planes a slot), the raw ring, room for the mbarriers
// (16 bytes a slot of either ring), the mask and the tile flags.
template <int DP> size_t round_smem(int T_) {
  const int n_tiles = (T_ + kRTile - 1) / kRTile;
  return kRAlign + kFqPlaneSlots * 2 * RCfg<DP>::kPlane +
         kFqRawSlots * RCfg<DP>::kRaw + 16 * (kFqRawSlots + kFqPlaneSlots) +
         ((T_ + 15) / 16) * 16 + 2 * n_tiles;
}

// dK/dV's: the pad, the plane ring (Q and dO, hi and lo), the raw ring (Q
// and dO), the stages of P and round(dP), and the mbarriers (raw full,
// plane full and empty, stage full).
template <int DP> constexpr size_t round_dkdv_smem() {
  return kRAlign + kKvSlots * (4 * RCfg<DP>::kPlane + 2 * RCfg<DP>::kRaw +
                               RCfg<DP>::kStage + 32);
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// An arrival on bar once this thread's earlier cp.async copies have landed
// (the barrier counts one arrival a copying thread).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar) : "memory");
}

// The producer warpgroup's own barrier (the consumers never join it), and
// dK/dV's consumer warpgroup's.
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Register budgets of the two roles (whole warpgroups).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// Makes this thread's shared-memory stores (the planes) visible to the
// async proxy that wgmma reads them through.
__device__ __forceinline__ void fence_planes() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Ties registers to the point after a wgmma wait: accumulators are not read,
// and A operands not reused, while a wgmma may still touch them.
template <int N> __device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void hold(uint32_t (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Shared-memory descriptor of a K-major operand with 128-byte swizzled rows
// (8-row groups 1024 bytes apart; the leading byte offset is unused in this
// mode, 1 by convention) starting at addr.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// A plane: R rows (the product's N index) by K f32 columns (its k index),
// in chunks of 32 columns, each R rows of 128 bytes; the 16-byte unit u of
// row r is stored at unit u ^ (r % 8) (the 128-byte swizzle). Byte offset
// of element (r, c):
__device__ __forceinline__ uint32_t plane_off(int r, int c, int R) {
  return (uint32_t)(((c >> 5) * R + r) * 128 +
                    ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

// The descriptor of k8 step s of a plane of R rows at plane.
template <int R>
__device__ __forceinline__ uint64_t step_desc(uint32_t plane, int s) {
  return sw128_desc(plane + (uint32_t)((s >> 2) * R * 128 + (s & 3) * 32));
}

#define TKR_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TKR_A_IN \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)

// D (64 x N, f32) += A (64 x 8, TF32 in registers: for warp w of the
// warpgroup, a[0] = (16w + g, t), a[1] = (16w + g + 8, t), a[2] = (16w + g,
// t + 4), a[3] = (16w + g + 8, t + 4)) . B (8 x N, TF32, a plane). D holds,
// for each 8-column step i, (g, 8i + 2t), (g, 8i + 2t + 1), (g + 8, 8i +
// 2t), (g + 8, 8i + 2t + 1) of the warp's 16 rows.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : TKR_D8(0), TKR_D8(8)
      : TKR_A_IN);
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : TKR_D8(0), TKR_D8(8), TKR_D8(16), TKR_D8(24)
      : TKR_A_IN);
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : TKR_D8(0), TKR_D8(8), TKR_D8(16), TKR_D8(24), TKR_D8(32), TKR_D8(40),
        TKR_D8(48), TKR_D8(56)
      : TKR_A_IN);
}

#undef TKR_D8
#undef TKR_A_IN

// ---------------------------------------------------------- the ring

// ------------------------------------------------------------ the rings

// The parity that a wait for use n of a slot of a ring of S slots passes:
// that use is its barrier's (n / S)-th phase. A wait for the release of use
// n - S passes the other parity.
template <int S> __device__ __forceinline__ uint32_t parity(int n) {
  return (uint32_t)(n / S) & 1;
}

// Rows [t0, t0 + kRTile) of a strided (T, D) matrix into a raw tile at dst
// (rows kRawLd floats apart) by 16-byte cp.async, the 128 producer threads
// taking consecutive units of a row; rows past T and columns past D are
// zero-filled by the copy.
template <int DP>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long st, int t0, int T_, int D,
                                          int t) {
  constexpr int kUnits = DP / 4;   // 16-byte units a row
#pragma unroll
  for (int i = 0; i < kRTile * kUnits / 128; ++i) {
    const int u = t + i * 128, r = u / kUnits, c = (u % kUnits) * 4;
    const bool ok = t0 + r < T_ && c < D;
    cp_async16(dst + r * RCfg<DP>::kRawLd + c,
               ok ? src + (long long)(t0 + r) * st + c : src, ok);
  }
}

// The key tiles the forward's and dQ's two passes walk: pass 0's live
// tiles, then pass 1's.
struct Walk {
  int j, pass;
  __device__ __forceinline__ bool done() const { return pass > 1; }
  __device__ __forceinline__ void step(int j_first, bool item_live,
                                       const uint8_t* live, int n_tiles) {
    j = next_tile(j, item_live, live, n_tiles);
    if (j >= n_tiles) {
      j = j_first;
      ++pass;
    }
  }
};

// ------------------------------------------------------------ planes

// A raw tile (kRTile rows of DP floats, kRawLd apart) into hi and lo planes
// of kRTile rows over DP columns (the B operand of S = Q K^T or dP = dO
// V^T), by producer thread t; rows past `rows` and columns past D are zero.
template <int DP>
__device__ __forceinline__ void split_rows(const float* raw,
                                           unsigned char* hi,
                                           unsigned char* lo, int rows, int D,
                                           int t) {
  constexpr int kUnits = DP / 4;   // 16-byte units a row
#pragma unroll
  for (int i = 0; i < kRTile * kUnits / 128; ++i) {
    const int u = t + i * 128;
    const int r = u / kUnits, c = (u % kUnits) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && c < D)
      x = *reinterpret_cast<const float4*>(raw + r * RCfg<DP>::kRawLd + c);
    const Split s0 = split(x.x), s1 = split(x.y), s2 = split(x.z),
                s3 = split(x.w);
    const uint32_t off = plane_off(r, c, kRTile);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
  }
}

// A raw tile transposed into hi and lo planes of DP rows over the tile's
// kRTile rows (the B operand of O = round(P) V, dQ = dS K, dV = round(P)^T
// dO, dK = dS^T Q), by producer thread t: the tile's row i at column i, or
// with PERM (an A operand taken from an accumulator) row 8k + 2t at column
// 8k + t and row 8k + 2t + 1 at column 8k + t + 4. Lane i takes row i, so
// the loads and the stores of a warp fall on distinct banks.
template <int DP, bool PERM>
__device__ __forceinline__ void split_cols(const float* raw,
                                           unsigned char* hi,
                                           unsigned char* lo, int rows, int D,
                                           int t) {
  const int i = t % 32, w = t / 32;
  const int col = PERM ? (i & ~7) | ((i & 1) << 2) | ((i & 7) >> 1) : i;
  const bool in = i < rows;
#pragma unroll
  for (int it = 0; it < DP / 16; ++it) {
    const int c = it * 16 + w * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in && c < D)
      x = *reinterpret_cast<const float4*>(raw + i * RCfg<DP>::kRawLd + c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Split s = split(xs[e]);
      const uint32_t off = plane_off(c + e, col, DP);
      *reinterpret_cast<uint32_t*>(hi + off) = s.hi;
      *reinterpret_cast<uint32_t*>(lo + off) = s.lo;
    }
  }
}

template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&ah)[DP / 8][4],
                                       uint32_t (&al)[DP / 8][4],
                                       const float* src, long long st,
                                       int row0, const bool (&row_in)[2],
                                       int D, int t4) {
#pragma unroll
  for (int s = 0; s < DP / 8; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1, c = 8 * s + t4 + 4 * (e >> 1);
      const float x =
          row_in[r] && c < D ? src[(long long)(row0 + 8 * r) * st + c] : 0.f;
      const Split sp = split(x);
      ah[s][e] = sp.hi;
      al[s][e] = sp.lo;
    }
}

// The permuted A operand of k8 step kk from accumulator-ordered values x
// (x[4 kk + e], e as the accumulator's), k = t standing for column 2t and
// k = t + 4 for 2t + 1.
__device__ __forceinline__ void perm_a(uint32_t (&a)[4], const float* x,
                                       int kk) {
  a[0] = __float_as_uint(x[4 * kk]);
  a[1] = __float_as_uint(x[4 * kk + 2]);
  a[2] = __float_as_uint(x[4 * kk + 1]);
  a[3] = __float_as_uint(x[4 * kk + 3]);
}


// ------------------------------------------------ forward and dQ: shared

// Shared memory of the forward and dQ kernels, carved from the dynamic
// allocation: the plane ring, the raw ring, the mbarriers (raw full, plane
// full, plane empty), the mask and the tile flags.
struct FqSmem {
  unsigned char* planes;
  unsigned char* raw;
  uint32_t raw_full, plane_full, plane_empty;
  uint8_t *ms, *live, *mixed;
};

template <int DP>
__device__ __forceinline__ FqSmem fq_smem(unsigned char* smem_raw, int T_,
                                          int n_tiles) {
  using C = RCfg<DP>;
  FqSmem m;
  m.planes = smem_raw + (kRAlign - smem_addr(smem_raw) % kRAlign) % kRAlign;
  m.raw = m.planes + kFqPlaneSlots * 2 * C::kPlane;
  unsigned char* bars = m.raw + kFqRawSlots * C::kRaw;
  m.raw_full = smem_addr(bars);
  m.plane_full = m.raw_full + 8 * kFqRawSlots;
  m.plane_empty = m.plane_full + 8 * kFqPlaneSlots;
  m.ms = bars + 16 * (kFqRawSlots + kFqPlaneSlots);
  m.live = m.ms + ((T_ + 15) / 16) * 16;
  m.mixed = m.live + n_tiles;
  return m;
}

// The mbarriers (thread 0; the mask scan's barrier publishes them) and the
// mask scan (every thread). Returns whether the item has a valid key.
__device__ __forceinline__ bool fq_prologue(const FqSmem& m,
                                            const uint8_t* mb, int T_,
                                            int n_tiles) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFqRawSlots; ++s)
      mbar_init(m.raw_full + 8 * s, 128);   // every producer thread's copies
    for (int s = 0; s < kFqPlaneSlots; ++s) {
      mbar_init(m.plane_full + 8 * s, 1);
      mbar_init(m.plane_empty + 8 * s, 4 * kFqWGs);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return scan_mask(mb, T_, kRTile, m.ms, m.live, m.mixed, n_tiles);
}

// The producer warpgroup of the forward and dQ kernels: pass 0 streams the
// live key tiles of src0 and splits them into row planes, pass 1 those of
// src1 into transposed planes (PERM). kFqRawSlots raw tiles are in flight,
// copied by cp.async from every producer thread, each thread's copies of a
// tile completing on the slot's barrier.
template <int DP>
__device__ __forceinline__ void produce_fq(const FqSmem& m, const float* src0,
                                           const float* src1, long long st,
                                           int T_, int D, int j_first,
                                           bool item_live, int n_tiles) {
  using C = RCfg<DP>;
  const int t = threadIdx.x - 128 * kFqWGs;
  TK_PHASES
  Walk issue{j_first, 0}, work{j_first, 0};
  int ni = 0;   // tiles issued
  auto copy = [&]() {
    const int s = ni % kFqRawSlots;
    copy_tile<DP>(reinterpret_cast<float*>(m.raw + s * C::kRaw),
                  issue.pass ? src1 : src0, st, issue.j * kRTile, T_, D, t);
    cp_async_arrive(m.raw_full + 8 * s);
    issue.step(j_first, item_live, m.live, n_tiles);
    ++ni;
  };
  while (ni < kFqRawSlots && !issue.done()) copy();
  TK_MARK(16);
  for (int n = 0; !work.done(); ++n) {
    const int s = n % kFqRawSlots, ps = n % kFqPlaneSlots;
    mbar_wait(m.raw_full + 8 * s, parity<kFqRawSlots>(n));
    TK_MARK(17);
    if (n >= kFqPlaneSlots)
      mbar_wait(m.plane_empty + 8 * ps, parity<kFqPlaneSlots>(n) ^ 1);
    TK_MARK(18);
    const float* src = reinterpret_cast<const float*>(m.raw + s * C::kRaw);
    unsigned char* hi = m.planes + ps * 2 * C::kPlane;
    const int rows = min(kRTile, T_ - work.j * kRTile);
    if (work.pass) split_cols<DP, true>(src, hi, hi + C::kPlane, rows, D, t);
    else split_rows<DP>(src, hi, hi + C::kPlane, rows, D, t);
    TK_MARK(19);
    fence_planes();
    TK_MARK(21);
    producers_sync();   // the raw slot is read and the planes written
    if (t == 0) mbar_arrive(m.plane_full + 8 * ps);
    if (!issue.done()) copy();   // into the freed slot
    work.step(j_first, item_live, m.live, n_tiles);
    TK_MARK(20);
  }
  TK_PHASES_END();
}

// The consumers' wait for plane slot n and its release.
__device__ __forceinline__ uint32_t planes_wait(const FqSmem& m, int n,
                                                uint32_t planes_a,
                                                uint32_t plane_bytes) {
  const int ps = n % kFqPlaneSlots;
  mbar_wait(m.plane_full + 8 * ps, parity<kFqPlaneSlots>(n));
  return planes_a + ps * 2 * plane_bytes;
}
__device__ __forceinline__ void planes_release(const FqSmem& m, int n,
                                               int lane) {
  if (lane == 0) mbar_arrive(m.plane_empty + 8 * (n % kFqPlaneSlots));
}

// ------------------------------------------------------------ forward

// One block per (b, h, 128 query rows): two consumer warpgroups of 64 rows
// and the producer. Pass 1 over the live key tiles: S = Q K^T (3 passes in
// two accumulator sets), masked and scaled, its row max m and sum l
// online, S written to sp. Pass 2: S read back (the next tile's while this
// one's products run), P = exp(S - m) / l (written over S when write_p),
// O += round(P) V (2 passes, two sets). Then O (normalized) and, where lse
// is not null, lse = m + log l.
template <int DP>
__global__ void __launch_bounds__(kFqThreads, 1)
round_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ o, float* __restrict__ lse,
                 float* __restrict__ sp, int write_p, int H, int T_, int D,
                 long long sb, long long sh, long long st, long long osb,
                 long long osh, long long ost, long long ld, float scale) {
  using C = RCfg<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_tiles = (T_ + kRTile - 1) / kRTile;
  const FqSmem m = fq_smem<DP>(smem_raw, T_, n_tiles);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  TK_PHASES

  const bool item_live = fq_prologue(m, mask + (long long)b * T_, T_,
                                     n_tiles);
  const int j_first = next_tile(-1, item_live, m.live, n_tiles);
  if (threadIdx.x >= 128 * kFqWGs) {   // the producer: K tiles, then V
    producer_regs();
    produce_fq<DP>(m, k + b * sb + h * sh, v + b * sb + h * sh, st, T_, D,
                   j_first, item_live, n_tiles);
    return;
  }
  consumer_regs();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  // the thread's rows: row0 and row0 + 8
  const int row0 = blockIdx.x * kFqRows + wg * 64 + warp * 16 + g;
  const bool row_in[2] = {row0 < T_, row0 + 8 < T_};
  float* srow[2] = {sp + ((long long)bh * T_ + row0) * ld,
                    sp + ((long long)bh * T_ + row0 + 8) * ld};
  const uint32_t planes_a = smem_addr(m.planes);

  uint32_t qh[C::kKSteps][4], ql[C::kKSteps][4];
  load_a<DP>(qh, ql, q + b * sb + h * sh, st, row0, row_in, D, t4);
  float m_i[2] = {-1e30f, -1e30f}, l_i[2] = {0.f, 0.f};
  TK_MARK(0);

  // pass 1: S, m and l
  int n = 0;
  for (int j = j_first; j < n_tiles;
       j = next_tile(j, item_live, m.live, n_tiles), ++n) {
    const uint32_t hi = planes_wait(m, n, planes_a, C::kPlane);
    const uint32_t lo = hi + C::kPlane;
    TK_MARK(1);
    float s0[kRTile / 2], s[kRTile / 2];
#pragma unroll
    for (int i = 0; i < kRTile / 2; ++i) s0[i] = s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < C::kKSteps; ++ks) {
      wgmma_tf32<kRTile>(s0, ql[ks], step_desc<kRTile>(hi, ks));
      wgmma_tf32<kRTile>(s, qh[ks], step_desc<kRTile>(hi, ks));
      wgmma_tf32<kRTile>(s0, qh[ks], step_desc<kRTile>(lo, ks));
    }
    wgmma_commit();
    TK_MARK(2);
    wgmma_wait0();
    hold(s0);
    hold(s);
    hold(qh);
    hold(ql);
    planes_release(m, n, lane);
    TK_MARK(3);

    // S in registers of its own, masked by selects (padded keys at -1e9,
    // keys past T at -inf)
    const int k0 = j * kRTile;
    float sv[kRTile / 2];
#pragma unroll
    for (int nt = 0; nt < kRTile / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + nt * 8 + 2 * t4 + c;
        const bool out = key >= T_;
        const bool padded = m.ms[out ? 0 : key] != 0;
#pragma unroll
        for (int e = c; e < 4; e += 2) {
          const int i = 4 * nt + e;
          const float x = (s[i] + s0[i]) * scale;
          sv[i] = out ? neg_inf() : padded ? kMasked : x;
        }
      }
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int i = 0; i < kRTile / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sv[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);   // finite: k0 < T
      l_i[r] *= ex2((m_i[r] - m_new) * kLog2e);
      m_i[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kRTile / 2; ++i)
      l_i[(i >> 1) & 1] += ex2((sv[i] - m_i[(i >> 1) & 1]) * kLog2e);
#pragma unroll
    for (int nt = 0; nt < kRTile / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row_in[r])
          *reinterpret_cast<float2*>(srow[r] + k0 + 8 * nt + 2 * t4) =
              make_float2(sv[4 * nt + 2 * r], sv[4 * nt + 2 * r + 1]);
    TK_MARK(4);
  }

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    inv_l[r] = 1.f / l_i[r];
  }

  // pass 2: O += round(P) V
  float acc_lo[DP / 2], acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_lo[i] = acc[i] = 0.f;
  float sn[kRTile / 2];
  auto load_s = [&](int j) {
    const int k0 = j * kRTile;
#pragma unroll
    for (int nt = 0; nt < kRTile / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 x = make_float2(0.f, 0.f);
        if (row_in[r])
          x = *reinterpret_cast<const float2*>(srow[r] + k0 + 8 * nt + 2 * t4);
        sn[4 * nt + 2 * r] = x.x;
        sn[4 * nt + 2 * r + 1] = x.y;
      }
  };
  load_s(j_first);
  for (int j = j_first; j < n_tiles; ++n) {
    const int jn = next_tile(j, item_live, m.live, n_tiles);
    const int k0 = j * kRTile;
    float p[kRTile / 2];
#pragma unroll
    for (int i = 0; i < kRTile / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float pu = ex2((sn[i] - m_i[r]) * kLog2e) * inv_l[r];
      sn[i] = pu;
      p[i] = round_bf16(pu);
    }
    if (write_p) {
#pragma unroll
      for (int nt = 0; nt < kRTile / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row_in[r])
            *reinterpret_cast<float2*>(srow[r] + k0 + 8 * nt + 2 * t4) =
                make_float2(sn[4 * nt + 2 * r], sn[4 * nt + 2 * r + 1]);
    }
    uint32_t pa[kRTile / 8][4];
#pragma unroll
    for (int kk = 0; kk < kRTile / 8; ++kk) perm_a(pa[kk], p, kk);
    TK_MARK(5);
    const uint32_t hi = planes_wait(m, n, planes_a, C::kPlane);
    const uint32_t lo = hi + C::kPlane;
    TK_MARK(1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRTile / 8; ++kk) {   // round(P)'s low split is 0
      wgmma_tf32<DP>(acc_lo, pa[kk], step_desc<DP>(lo, kk));
      wgmma_tf32<DP>(acc, pa[kk], step_desc<DP>(hi, kk));
    }
    wgmma_commit();
    TK_MARK(2);
    if (jn < n_tiles) load_s(jn);
    TK_MARK(7);
    wgmma_wait0();
    hold(acc_lo);
    hold(acc);
    hold(pa);
    planes_release(m, n, lane);
    TK_MARK(3);
    j = jn;
  }

  float* ob = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (!row_in[r]) continue;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int d = nt * 8 + 2 * t4;
      if (d < D)
        store2<float>(ob + t * ost + d,
                      acc_lo[4 * nt + 2 * r] + acc[4 * nt + 2 * r],
                      acc_lo[4 * nt + 2 * r + 1] + acc[4 * nt + 2 * r + 1]);
    }
    if (lse != nullptr && t4 == 0)
      lse[(long long)bh * T_ + t] = m_i[r] + logf(l_i[r]);
  }
  TK_MARK(6);
  TK_PHASES_END();
}

// ---------------------------------------------------------------- dQ

// One block per (b, h, 128 query rows), as the forward. Pass 1 over the
// live key tiles: dP = dO V^T (3 passes, two sets), rounded to bf16 and
// written to dp; Delta_i = sum_j P_ij round(dP_ij) with P read from p (the
// forward's; read while the products run), written to delta. Pass 2: P and
// round(dP) read back (the next tile's while this one's products run), dS
// = P (round(dP) - Delta), dQ += dS K (3 passes: the two small terms in one
// set, the large in another). dQ = that * scale.
template <int DP>
__global__ void __launch_bounds__(kFqThreads, 1)
round_dq_kernel(const float* __restrict__ k, const float* __restrict__ v,
                const uint8_t* __restrict__ mask, const float* __restrict__ dO,
                const float* __restrict__ p, __nv_bfloat16* __restrict__ dp,
                float* __restrict__ delta, float* __restrict__ dq, int H,
                int T_, int D, long long sb, long long sh, long long st,
                long long osb, long long osh, long long ost, long long ld,
                float scale) {
  using C = RCfg<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_tiles = (T_ + kRTile - 1) / kRTile;
  const FqSmem m = fq_smem<DP>(smem_raw, T_, n_tiles);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  TK_PHASES

  const bool item_live = fq_prologue(m, mask + (long long)b * T_, T_,
                                     n_tiles);
  const int j_first = next_tile(-1, item_live, m.live, n_tiles);
  if (threadIdx.x >= 128 * kFqWGs) {   // the producer: V tiles, then K
    producer_regs();
    produce_fq<DP>(m, v + b * sb + h * sh, k + b * sb + h * sh, st, T_, D,
                   j_first, item_live, n_tiles);
    return;
  }
  consumer_regs();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int row0 = blockIdx.x * kFqRows + wg * 64 + warp * 16 + g;
  const bool row_in[2] = {row0 < T_, row0 + 8 < T_};
  const long long r0 = ((long long)bh * T_ + row0) * ld;
  const float* prow[2] = {p + r0, p + r0 + 8 * ld};
  __nv_bfloat16* dprow[2] = {dp + r0, dp + r0 + 8 * ld};
  const uint32_t planes_a = smem_addr(m.planes);
  // P of tile j at the thread's positions (0 on rows past T)
  auto load_p = [&](float (&x)[kRTile / 2], int j) {
    const int k0 = j * kRTile;
#pragma unroll
    for (int nt = 0; nt < kRTile / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 y = make_float2(0.f, 0.f);
        if (row_in[r])
          y = *reinterpret_cast<const float2*>(prow[r] + k0 + 8 * nt + 2 * t4);
        x[4 * nt + 2 * r] = y.x;
        x[4 * nt + 2 * r + 1] = y.y;
      }
  };

  uint32_t ah[C::kKSteps][4], al[C::kKSteps][4];
  load_a<DP>(ah, al, dO + b * osb + h * osh, ost, row0, row_in, D, t4);
  float d_sum[2] = {0.f, 0.f};
  TK_MARK(0);

  // pass 1: dP, Delta
  int n = 0;
  for (int j = j_first; j < n_tiles;
       j = next_tile(j, item_live, m.live, n_tiles), ++n) {
    const uint32_t hi = planes_wait(m, n, planes_a, C::kPlane);
    const uint32_t lo = hi + C::kPlane;
    TK_MARK(1);
    float s0[kRTile / 2], s[kRTile / 2];
#pragma unroll
    for (int i = 0; i < kRTile / 2; ++i) s0[i] = s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < C::kKSteps; ++ks) {
      wgmma_tf32<kRTile>(s0, al[ks], step_desc<kRTile>(hi, ks));
      wgmma_tf32<kRTile>(s, ah[ks], step_desc<kRTile>(hi, ks));
      wgmma_tf32<kRTile>(s0, ah[ks], step_desc<kRTile>(lo, ks));
    }
    wgmma_commit();
    TK_MARK(2);
    float pj[kRTile / 2];
    load_p(pj, j);
    TK_MARK(7);
    wgmma_wait0();
    hold(s0);
    hold(s);
    hold(ah);
    hold(al);
    planes_release(m, n, lane);
    TK_MARK(3);
    const int k0 = j * kRTile;
#pragma unroll
    for (int nt = 0; nt < kRTile / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * nt + 2 * r;
        const float d0 = round_bf16(s0[i] + s[i]);
        const float d1 = round_bf16(s0[i + 1] + s[i + 1]);
        d_sum[r] += pj[i] * d0 + pj[i + 1] * d1;
        if (row_in[r])
          *reinterpret_cast<uint32_t*>(dprow[r] + k0 + 8 * nt + 2 * t4) =
              pack_bf16(d0, d1);
      }
    TK_MARK(4);
  }
  float d_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    d_sum[r] += __shfl_xor_sync(0xffffffffu, d_sum[r], 1);
    d_sum[r] += __shfl_xor_sync(0xffffffffu, d_sum[r], 2);
    d_row[r] = d_sum[r];
    if (t4 == 0 && row_in[r])
      delta[(long long)bh * ld + row0 + 8 * r] = d_row[r];
  }

  // pass 2: dQ += dS K
  float acc_lo[DP / 2], acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_lo[i] = acc[i] = 0.f;
  float pn[kRTile / 2];
  uint32_t dpn[kRTile / 4];   // bf16 pairs
  auto load_pdp = [&](int j) {
    load_p(pn, j);
    const int k0 = j * kRTile;
#pragma unroll
    for (int nt = 0; nt < kRTile / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        dpn[2 * nt + r] =
            row_in[r] ? *reinterpret_cast<const uint32_t*>(dprow[r] + k0 +
                                                           8 * nt + 2 * t4)
                      : 0u;
  };
  load_pdp(j_first);
  for (int j = j_first; j < n_tiles; ++n) {
    const int jn = next_tile(j, item_live, m.live, n_tiles);
    float ds[kRTile / 2];
#pragma unroll
    for (int nt = 0; nt < kRTile / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 dpv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&dpn[2 * nt + r]));
        ds[4 * nt + 2 * r] = pn[4 * nt + 2 * r] * (dpv.x - d_row[r]);
        ds[4 * nt + 2 * r + 1] = pn[4 * nt + 2 * r + 1] * (dpv.y - d_row[r]);
      }
    uint32_t dh[kRTile / 8][4], dl[kRTile / 8][4];
#pragma unroll
    for (int kk = 0; kk < kRTile / 8; ++kk) {
      const float x[4] = {ds[4 * kk], ds[4 * kk + 2], ds[4 * kk + 1],
                          ds[4 * kk + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Split sp = split(x[e]);
        dh[kk][e] = sp.hi;
        dl[kk][e] = sp.lo;
      }
    }
    TK_MARK(5);
    const uint32_t hi = planes_wait(m, n, planes_a, C::kPlane);
    const uint32_t lo = hi + C::kPlane;
    TK_MARK(1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRTile / 8; ++kk) {
      wgmma_tf32<DP>(acc_lo, dl[kk], step_desc<DP>(hi, kk));
      wgmma_tf32<DP>(acc, dh[kk], step_desc<DP>(hi, kk));
      wgmma_tf32<DP>(acc_lo, dh[kk], step_desc<DP>(lo, kk));
    }
    wgmma_commit();
    TK_MARK(2);
    if (jn < n_tiles) load_pdp(jn);
    TK_MARK(7);
    wgmma_wait0();
    hold(acc_lo);
    hold(acc);
    hold(dh);
    hold(dl);
    planes_release(m, n, lane);
    TK_MARK(3);
    j = jn;
  }

  float* dqb = dq + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (!row_in[r]) continue;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int d = nt * 8 + 2 * t4;
      if (d < D)
        store2<float>(dqb + t * ost + d,
                      (acc_lo[4 * nt + 2 * r] + acc[4 * nt + 2 * r]) * scale,
                      (acc_lo[4 * nt + 2 * r + 1] + acc[4 * nt + 2 * r + 1]) *
                          scale);
    }
  }
  TK_MARK(6);
  TK_PHASES_END();
}

// ------------------------------------------------------------- dK/dV

// One block per (b, h, 64 keys), the keys the consumer warpgroup's rows,
// and the producer warpgroup. Over every tile of 32 query rows the
// producer stages raw Q and dO (cp.async, completing on the slot's
// barrier) and splits them into transposed planes; the consumers stage the
// tile's P (64 keys, f32), round(dP) (bf16) and Delta rows themselves, two
// tiles ahead (cp.async, completing on the stage's barrier), form round(P)^T
// and dS^T = P^T (round(dP)^T - Delta) as A operands from the stage (P = 0
// at a padded key of an item with a valid key and at keys past T: skipped
// tiles hold no P), then dV += round(P)^T dO (2 passes) and dK += dS^T Q (3
// passes). A block whose 64 keys are all padded writes zeros and returns
// (its P is 0). One block an SM (its shared memory), so no register
// hand-over is needed.
template <int DP>
__global__ void __launch_bounds__(kKvThreads, 1)
round_dkdv_kernel(const float* __restrict__ q,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ dO, const float* __restrict__ p,
                  const __nv_bfloat16* __restrict__ dp,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int T_, int D, long long sb,
                  long long sh, long long st, long long osb, long long osh,
                  long long ost, long long ld, float scale) {
  using C = RCfg<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* planes =
      smem_raw + (kRAlign - smem_addr(smem_raw) % kRAlign) % kRAlign;
  // [slot][Q hi, Q lo, dO hi, dO lo]; raw [slot][Q, dO]; stages [slot]
  unsigned char* raw = planes + kKvSlots * 4 * C::kPlane;
  unsigned char* stages = raw + kKvSlots * 2 * C::kRaw;
  const uint32_t raw_full = smem_addr(stages + kKvSlots * C::kStage);
  const uint32_t plane_full = raw_full + 8 * kKvSlots;
  const uint32_t plane_empty = plane_full + 8 * kKvSlots;
  const uint32_t stage_full = plane_empty + 8 * kKvSlots;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const uint8_t* mb = mask + (long long)b * T_;
  float* dkb = dk + b * osb + h * osh;
  float* dvb = dv + b * osb + h * osh;
  TK_PHASES

  if (threadIdx.x == 0) {
    for (int s = 0; s < kKvSlots; ++s) {
      mbar_init(raw_full + 8 * s, 128);     // every producer thread's copies
      mbar_init(plane_full + 8 * s, 1);
      mbar_init(plane_empty + 8 * s, 4);    // every consumer warp
      mbar_init(stage_full + 8 * s, 128);   // every consumer thread's copies
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int mine = 0;   // a valid key in this block's 64
  const bool item_live = scan_keys(mb, T_, [&](int t, uint8_t mk) {
    if (!mk && t >= k0 && t < k0 + kRows) mine = 1;
  });
  if (skip_tile(item_live, __syncthreads_or(mine))) {
    for (int i = threadIdx.x; i < kRows * D; i += kKvThreads) {
      const int t = k0 + i / D, d = i % D;
      if (t < T_) dkb[t * ost + d] = dvb[t * ost + d] = 0.f;
    }
    TK_MARK(15);
    TK_PHASES_END();
    return;
  }
  const int nq = (T_ + kRTile - 1) / kRTile;
  auto rows_of = [&](int i) { return min(kRTile, T_ - i * kRTile); };

  if (threadIdx.x >= 128) {   // the producer warpgroup: Q and dO
    const int t = threadIdx.x - 128;
    const float* qb = q + b * sb + h * sh;
    const float* dob = dO + b * osb + h * osh;
    auto copy = [&](int i) {
      const int s = i % kKvSlots;
      float* at = reinterpret_cast<float*>(raw + 2 * s * C::kRaw);
      copy_tile<DP>(at, qb, st, i * kRTile, T_, D, t);
      copy_tile<DP>(at + C::kRaw / 4, dob, ost, i * kRTile, T_, D, t);
      cp_async_arrive(raw_full + 8 * s);
    };
    for (int i = 0; i < kKvSlots && i < nq; ++i) copy(i);
    TK_MARK(24);
    for (int i = 0; i < nq; ++i) {
      const int s = i % kKvSlots;
      mbar_wait(raw_full + 8 * s, parity<kKvSlots>(i));
      TK_MARK(25);
      if (i >= kKvSlots)
        mbar_wait(plane_empty + 8 * s, parity<kKvSlots>(i) ^ 1);
      TK_MARK(26);
      const float* rq = reinterpret_cast<const float*>(raw + 2 * s * C::kRaw);
      unsigned char* pl = planes + s * 4 * C::kPlane;
      split_cols<DP, false>(rq, pl, pl + C::kPlane, rows_of(i), D, t);
      split_cols<DP, false>(rq + C::kRaw / 4, pl + 2 * C::kPlane,
                            pl + 3 * C::kPlane, rows_of(i), D, t);
      TK_MARK(27);
      fence_planes();
      TK_MARK(29);
      producers_sync();   // the raw slot is read and the planes written
      if (t == 0) mbar_arrive(plane_full + 8 * s);
      if (i + kKvSlots < nq) copy(i + kKvSlots);   // into the freed slot
      TK_MARK(28);
    }
    TK_PHASES_END();
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // the thread's keys (rows of the products): kr and kr + 8 of the block;
  // P is 0 at a padded key of a live item and at keys past T
  const int kr = warp * 16 + g;
  bool key_zero[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = k0 + kr + 8 * r;
    key_zero[r] = t >= T_ || (item_live && mb[t]);
  }
  const uint32_t planes_a = smem_addr(planes);
  // stage i: the tile's P, round(dP) and Delta rows, by every consumer
  // thread, completing on the stage's barrier
  auto stage = [&](int i) {
    const int s = i % kKvSlots, t0 = i * kRTile, t = threadIdx.x;
    unsigned char* stg = stages + s * C::kStage;
    const long long row0 = (long long)bh * T_ + t0;
#pragma unroll
    for (int u = t; u < kRTile * 16; u += 128) {   // P: 16 units a row
      const int r = u / 16, c = (u % 16) * 4;
      const bool ok = t0 + r < T_;
      cp_async16(reinterpret_cast<float*>(stg) + r * kPLd + c,
                 ok ? p + (row0 + r) * ld + k0 + c : p, ok);
    }
#pragma unroll
    for (int u = t; u < kRTile * 8; u += 128) {   // round(dP): 8 a row
      const int r = u / 8, c = (u % 8) * 8;
      const bool ok = t0 + r < T_;
      cp_async16(reinterpret_cast<__nv_bfloat16*>(stg + C::kStageDp) +
                     r * kDpLd + c,
                 ok ? dp + (row0 + r) * ld + k0 + c : dp, ok);
    }
    if (t < kRTile / 4)   // Delta: ld >= t0 + kRTile
      cp_async16(reinterpret_cast<float*>(stg + C::kStageDelta) + 4 * t,
                 delta + (long long)bh * ld + t0 + 4 * t, true);
    cp_async_arrive(stage_full + 8 * s);
  };
  for (int i = 0; i < kKvSlots && i < nq; ++i) stage(i);

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  TK_MARK(8);
  for (int i = 0; i < nq; ++i) {
    const int s = i % kKvSlots;
    mbar_wait(stage_full + 8 * s, parity<kKvSlots>(i));
    TK_MARK(14);
    // A operands from the stage: element e of k8 step kk is (key kr + 8 (e
    // & 1), query 8 kk + t + 4 (e >> 1)) of the tile
    const unsigned char* stg = stages + s * C::kStage;
    const float* ps = reinterpret_cast<const float*>(stg);
    const __nv_bfloat16* dps =
        reinterpret_cast<const __nv_bfloat16*>(stg + C::kStageDp);
    const float* dls = reinterpret_cast<const float*>(stg + C::kStageDelta);
    const int rows = rows_of(i);
    uint32_t pa[kRTile / 8][4], dh[kRTile / 8][4], dl[kRTile / 8][4];
#pragma unroll
    for (int kk = 0; kk < kRTile / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e & 1, key = kr + 8 * r;
        const int qi = 8 * kk + t4 + 4 * (e >> 1);
        float pv = 0.f, ds = 0.f;
        if (!key_zero[r] && qi < rows) {
          pv = ps[qi * kPLd + key];
          ds = pv * (__bfloat162float(dps[qi * kDpLd + key]) - dls[qi]);
        }
        pa[kk][e] = __float_as_uint(round_bf16(pv));
        const Split sp = split(ds);
        dh[kk][e] = sp.hi;
        dl[kk][e] = sp.lo;
      }
    consumers_sync();   // every consumer thread has read the stage
    if (i + kKvSlots < nq) stage(i + kKvSlots);
    TK_MARK(10);
    mbar_wait(plane_full + 8 * s, parity<kKvSlots>(i));
    TK_MARK(9);
    const uint32_t qhi = planes_a + s * 4 * C::kPlane, qlo = qhi + C::kPlane;
    const uint32_t dhi = qhi + 2 * C::kPlane, dlo = qhi + 3 * C::kPlane;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRTile / 8; ++kk) {   // round(P)'s low split is 0
      wgmma_tf32<DP>(dv_acc, pa[kk], step_desc<DP>(dlo, kk));
      wgmma_tf32<DP>(dk_acc, dl[kk], step_desc<DP>(qhi, kk));
    }
#pragma unroll
    for (int kk = 0; kk < kRTile / 8; ++kk) {
      wgmma_tf32<DP>(dv_acc, pa[kk], step_desc<DP>(dhi, kk));
      wgmma_tf32<DP>(dk_acc, dh[kk], step_desc<DP>(qlo, kk));
    }
#pragma unroll
    for (int kk = 0; kk < kRTile / 8; ++kk)
      wgmma_tf32<DP>(dk_acc, dh[kk], step_desc<DP>(qhi, kk));
    wgmma_commit();
    TK_MARK(11);
    wgmma_wait0();
    hold(dk_acc);
    hold(dv_acc);
    hold(pa);
    hold(dh);
    hold(dl);
    if (lane == 0) mbar_arrive(plane_empty + 8 * s);
    TK_MARK(12);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = k0 + kr + 8 * r;
    if (t >= T_) continue;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int d = nt * 8 + 2 * t4;
      if (d < D) {
        store2<float>(dkb + t * ost + d, dk_acc[4 * nt + 2 * r] * scale,
                      dk_acc[4 * nt + 2 * r + 1] * scale);
        store2<float>(dvb + t * ost + d, dv_acc[4 * nt + 2 * r],
                      dv_acc[4 * nt + 2 * r + 1]);
      }
    }
  }
  TK_MARK(13);
  TK_PHASES_END();
}

// ------------------------------------------------------------ launches

// ld must be T rounded up to 64 (the scratch's row length).
inline bool bad_round_shape(int B, int H, int T_, int D, long long ld) {
  return bad_shape(B, H, T_, D, 4) || ld != ((long long)T_ + 63) / 64 * 64;
}

template <int DP>
cudaError_t launch_round_fwd_dp(const float* q, const float* k,
                                const float* v, const uint8_t* mask, float* o,
                                float* lse, float* sp, int write_p, int B,
                                int H, int T_, int D, long long sb,
                                long long sh, long long st, long long osb,
                                long long osh, long long ost, long long ld,
                                float scale, cudaStream_t s) {
  static const cudaError_t allowed = allow_max_smem(round_fwd_kernel<DP>);
  if (allowed != cudaSuccess) return allowed;
  dim3 grid((T_ + kFqRows - 1) / kFqRows, B * H);
  round_fwd_kernel<DP><<<grid, kFqThreads, round_smem<DP>(T_), s>>>(
      q, k, v, mask, o, lse, sp, write_p, H, T_, D, sb, sh, st, osb, osh, ost,
      ld, scale);
  return cudaGetLastError();
}

// The forward at the DP that holds D. sp: (B, H, T, ld) f32 scratch, P in
// it afterwards when write_p.
inline cudaError_t launch_round_fwd(const float* q, const float* k,
                                    const float* v, const uint8_t* mask,
                                    float* o, float* lse, float* sp,
                                    int write_p, int B, int H, int T_, int D,
                                    long long sb, long long sh, long long st,
                                    long long osb, long long osh,
                                    long long ost, long long ld, float scale,
                                    cudaStream_t s) {
  if (bad_round_shape(B, H, T_, D, ld)) return cudaErrorInvalidValue;
  const int DP = round_dim(D);
  auto launch = DP == 32   ? launch_round_fwd_dp<32>
                : DP == 64 ? launch_round_fwd_dp<64>
                           : launch_round_fwd_dp<128>;
  return launch(q, k, v, mask, o, lse, sp, write_p, B, H, T_, D, sb, sh, st,
                osb, osh, ost, ld, scale, s);
}

}  // namespace
}  // namespace tk_attn
