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
// are s8 x s8 -> s32; the sum is dequantized in f32 as
// (acc -> f32) * (sx * wscale[c]) + bias, rounded to the stage dtype, and
// rows outside [0, T) are zeroed.
//
// The windows are the TPU kernel's: one per (batch item, TPU tile of TS = r *
// tile time steps); branch b's first conv covers the tile widened by ext[b]
// steps a side, and each conv shrinks the window by its packed halo r *
// ceil(c d / r) a side (the wrapper passes these). A conv computes exactly
// the next conv's window, so its epilogue also reduces max |lrelu(output)|
// over it, which is the next conv's sx.
//
// What bounds it on an H100: 2 * 21 * 6 * C^2 int8 operations per time step
// of a stage against a few bytes in and out, so arithmetic (1,979 dense int8
// TOP/s). The difficulty is the scale: one max over a conv's whole window
// (1,144 / 2,180 / 4,248 rows at C = 128 / 64 / 32 for k = 11), which the
// next conv needs before it can start, and whose stage-dtype activations
// (293 KB at C = 128) do not fit one SM.
//
// Design (mrf_int8_cluster):
//   * one thread-block cluster of S CTAs per window (S <= 8, the portable
//     maximum); CTA s owns the window's rows [s P, (s + 1) P) in the
//     coordinates of the widest branch's window (row 0 = time step t0 -
//     lmax). Its rows of h (the residual) stay in its shared memory in the
//     stage dtype for the whole stage, channel-major ([c][row], rows padded
//     to P + 8 so that a warp's epilogue stores fall in distinct banks), and
//     with them the branch sum when it fits (msum: bf16 at every shipped
//     stage), so device memory sees x in (once a branch), y out once, and
//     the taps: no scratch buffer;
//   * the per-conv max is a reduction over the cluster: each CTA reduces its
//     rows and sends its max by st.async into a slot of every CTA's shared
//     memory, counted on that CTA's round mbarrier (the bytes complete the
//     round: no fence, no release-arrive; a release at cluster scope costs a
//     MEMBAR.ALL.GPU). Two barriers and two slot sets alternate by round, so
//     a CTA one round ahead cannot count towards the round before. One round
//     per conv and one after each branch's x load, none after a branch's last
//     conv;
//   * the next conv's input is quantized once per element, right after the
//     round, from the registers where the epilogue left lrelu of the output
//     (no stage-dtype copy of conv 1's output when P is one pass), into an
//     int8 window, chunk-major ([c_in / 16][row][16 bytes]: any 8
//     consecutive rows are one 128-byte no-swizzle core matrix); the reach of
//     c d rows a side is then exchanged as int8 rows with the neighbours by
//     st.async counted on their reach barrier. The division is replaced by a
//     product by the reciprocal rounded with the 1.5 * 2^23 trick; a value
//     that lands within kNear of a half-integer takes the IEEE division
//     (quant_fast); bf16 rounding is done on the integer units (bf16_bits):
//     Hopper converts types at a quarter of its integer rate;
//   * products on wgmma.mma_async .s32.s8.s8, k32, both operands K-major in
//     shared memory without swizzle. Transposed at Cp >= 64:
//     y^T[c_out][t] = sum_j W_j[c_out][c_in] x[t + j d - c d][c_in], A the
//     tap (M = c_out), B the int8 window: a tap's shift j d is only the
//     descriptor's start address + 16 j d bytes. Four consumer warpgroups
//     hold 64 x 96 tiles (m64n96k32; ptxas budgets the 17-warp block at 96
//     registers a thread); at Cp = 128 two of them take the two channel
//     halves of a 96-row range. At Cp = 32 the products turn (RM: rows as M,
//     A the shifted window, B the tap, m64n32k32), so that no warp holds
//     padding channels. A CTA whose P rows exceed one pass runs its products
//     and epilogue in passes (only at widths below the shipped ones);
//   * taps are packed once by the wrapper ([tap][c_in / 16][c_out][16
//     bytes], mrf_int8.pack_kernel_taps) and streamed through a ring of
//     `slots` taps on mbarriers: the producer warp's thread in each CTA
//     copies its 1/S of every tap with cp.async.bulk .multicast::cluster
//     into the same slot of all S CTAs, so the cluster reads each tap from L2
//     once; a slot is refilled once the consumer warps of all S CTAs have
//     released it (remote arrivals on each CTA's empty barrier);
//   * the epilogue works on the accumulator's layout: scale, bias, rounding
//     to the stage dtype, the row mask, the residual (conv 2, in place), the
//     max over the conv's output window; a tile inside the window and [0, T)
//     (most) skips the row tests;
//   * the branch mean, in the plain version's order, s = h0; s = s + h1;
//     y = (s + h2) / 3, each CTA over its own rows of the tile, along time
//     when y is a (B, C, T) view.
// The plan (S, P, passes, slots, msum) comes from the wrapper's int8_plan
// (ops/kernels/mrf_int8.py); the entry point recomputes the shared bytes and
// refuses a plan that does not fit or does not cover the window. Every
// mbarrier wait traps after ~2^35 cycles, so that a protocol fault ends the
// launch with an error instead of hanging the card.
//
// Rounding follows the plain version (ops/kernels/mrf_int8.py) operation by
// operation: IEEE division for the scales (and for the quantization where
// the product by the reciprocal cannot decide it), __fmul_rn / __fadd_rn in
// the dequantization so that nvcc does not contract it into an FMA, round
// half up and the clip to +-127. The branch mean divides by the branch
// count.
//
// Layout: x and y are (B, T, C) views given by element strides (a (B, C, T)
// tensor is read in place). Taps: for each conv, branch-major and in chain
// order [convs1_0, convs2_0, ...], k taps of Cp * Cp bytes in the layout
// above; scales and biases (n_convs, Cp) f32; zero past C. Cp is 32, 64 or
// 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBranch = 4;
constexpr int kMaxDil = 4;
constexpr int kMaxConv = 2 * kMaxDil;
constexpr int kMaxCluster = 8;              // the portable cluster size
constexpr int kMaxSlots = 8;
constexpr int kConsumerWGs = 4;
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kWarps = kConsumers / 32;     // consumer warps
// + the producer warp. ptxas budgets this block (17 warps, allocated as 20)
// at 96 registers a thread, so a warpgroup's tile is 64 x 96 (48
// accumulators); setmaxnreg would not raise the budget it compiles for.
constexpr int kThreads = kConsumers + 32;
// Shared header: full[kMaxSlots] and empty[kMaxSlots] mbarriers of the
// ring, the max rounds' and the reach rounds' mbarriers (two each), the
// cluster's max slots [2][kMaxCluster] and the warps' maxes.
constexpr int kFullOff = 0, kEmptyOff = 64, kRoundOff = 128, kReachOff = 144,
              kRedOff = 160, kWredOff = 224, kHeader = 512;
constexpr long long kSmemLimit = 232448;
constexpr float kSlope = 0.1f;

// The products' geometry at Cp: each consumer warpgroup holds U tiles of NT
// rows (wgmma's N) of one m64 tile of output channels; at Cp = 128 two
// warpgroups take the two m64 halves of each row range, below it the
// warpgroups split the rows. A pass covers PASS rows; a CTA's P rows are
// whole passes.
//
// At Cp = 32 an m64 tile of output channels would be half padding, so the
// products turn the other way (RM, rows as M): D[t][c_out] = sum_j
// x[t + j d - c d][c_in] . W_j[c_out][c_in], A the shifted int8 window
// (the same descriptor offset), B the tap (N = 32); a warpgroup holds U
// m64 tiles of rows.
template <int CP> struct Cfg {
  static constexpr bool RM = CP == 32;
  static constexpr int NT = RM ? 64 : 96;          // rows of a tile
  static constexpr int U = RM ? 3 : 1;             // tiles a warpgroup holds
  static constexpr int MT = CP == 128 ? 2 : 1;     // m64 channel tiles
  static constexpr int TAPB = CP * CP;             // bytes of one tap
  static constexpr int WGROWS = U * NT;            // rows a warpgroup covers
  static constexpr int PASS = kConsumerWGs / MT * WGROWS;
  static constexpr int KSTEPS = CP / 32;
  static constexpr int NACC = RM ? 16 : NT / 2;    // s32 accumulators a tile
};

__host__ __device__ inline int pass_rows(int Cp) {
  return Cp == 128 ? Cfg<128>::PASS : Cp == 64 ? Cfg<64>::PASS : Cfg<32>::PASS;
}
__host__ __device__ inline int tap_bytes(int Cp) { return Cp * Cp; }

// Bytes of dynamic shared memory: header, ring, int8 window (P rows and the
// reach), h in the stage dtype (channels rounded up to 8, rows padded to
// P + 8), and as much again for conv 1's output when P takes more than one
// pass and for the branch sum when msum. mrf_int8.int8_plan's smem is the
// same sum.
__host__ __device__ inline long long smem_bytes(int Cp, int C, int P,
                                                int cdmax, int slots,
                                                int msum, int esize) {
  const long long cb = (C + 7) / 8 * 8;
  const int bufs = 1 + (P > pass_rows(Cp)) + (msum != 0);
  return kHeader + (long long)slots * tap_bytes(Cp) +
         (long long)Cp * (P + 2 * cdmax) + bufs * cb * (P + 8) * esize;
}

#ifdef TK_PROFILE_PHASES
// Phase marks, for scripts/probe_mrf_int8.py --phases: thread 0 (a
// consumer) adds the cycles since its previous mark to the phase the mark
// closes: x load, quantize (the next conv's input, this CTA's rows), reach
// (the exchange with the neighbours, with the wait for this CTA's slowest
// warp and for them), tap wait, products, epilogue, cluster max and its
// round, branch mean; summed over CTAs.
constexpr int kPhases = 8;
__device__ unsigned long long g_phase_cycles[kPhases];
__shared__ long long s_phase[kPhases + 1];   // sums, then the last mark
#define TK_PHASE_START()                                              \
  do {                                                                \
    if (threadIdx.x == 0) {                                           \
      for (int i_ = 0; i_ < kPhases; ++i_) s_phase[i_] = 0;           \
      s_phase[kPhases] = clock64();                                   \
    }                                                                 \
  } while (0)
#define TK_PHASE(i)                                                   \
  do {                                                                \
    if (threadIdx.x == 0) {                                           \
      const long long now_ = clock64();                               \
      s_phase[i] += now_ - s_phase[kPhases];                          \
      s_phase[kPhases] = now_;                                        \
    }                                                                 \
  } while (0)
#define TK_PHASE_END()                                                \
  do {                                                                \
    if (threadIdx.x == 0)                                             \
      for (int i_ = 0; i_ < kPhases; ++i_)                            \
        atomicAdd(&g_phase_cycles[i_], (unsigned long long)s_phase[i_]); \
  } while (0)
#else
#define TK_PHASE_START() do { } while (0)
#define TK_PHASE(i) do { } while (0)
#define TK_PHASE_END() do { } while (0)
#endif
enum { kPhX, kPhQuant, kPhReach, kPhTapWait, kPhProducts, kPhEpilogue,
       kPhClusterMax, kPhMean };

struct Plan {
  int nb;                                   // branches
  int nd;                                   // dilation pairs per branch
  int ks[kMaxBranch];
  int dil[kMaxDil];
  int halo[kMaxBranch][kMaxConv];           // steps each conv trims a side
  int ext[kMaxBranch];                      // first window's half-extension
  int lmax;                                 // max ext: row 0 is t0 - lmax
  int cdmax;                                // widest reach c d
  int S, P, npass, slots;                   // cluster, rows a CTA, passes, ring
  int msum;                                 // branch sum in shared memory
  long long toff[kMaxBranch][kMaxConv];     // byte offset of a conv's taps
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The bits of v rounded to bf16 (to nearest, ties to even) in the high half,
// on the integer units: Hopper converts types at 16 values a clock per SM,
// a quarter of its integer rate, and the stage rounds several times per
// element. Finite values round as __float2bfloat16_rn does (to inf past
// the largest bf16).
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(bf16_bits(v) >> 16));
}

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __uint_as_float(bf16_bits(v));
}

template <typename T> __device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : round_to<T>(v * kSlope);
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
  *reinterpret_cast<uint32_t*>(p) = (bf16_bits(a) >> 16) | bf16_bits(b);
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

// Time steps [tb, tb + 8) of one channel (stride 1 along time) whose row
// pointer is p, zeros outside [0, Tlen): one 16-byte-aligned vector load
// when all lie inside and vec, else one load per step.
template <typename T>
__device__ __forceinline__ void load_time8(const T* p, int tb, int Tlen,
                                           bool vec, float (&v)[8]) {
  if (vec && tb >= 0 && tb + 8 <= Tlen) {
    load8(p + tb, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = tb + i >= 0 && tb + i < Tlen ? to_f<T>(p[tb + i]) : 0.f;
}

// q = clip(floor(a / sx + 0.5), -127, 127), as the plain version rounds.
__device__ __forceinline__ uint32_t quant(float a, float sx) {
  float q = floorf(__fadd_rn(__fdiv_rn(a, sx), 0.5f));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

// The same q from x = a * rs (rs = __frcp_rn(sx)) with no conversion
// instruction: adding 1.5 * 2^23 rounds x to an integer n (ties to even) in
// the low bits of t, and d = x - n. x differs from the rounded a / sx by
// less than 4e-5 for |a / sx| <= 127.5, so floor(a / sx + 0.5) = n unless x
// lies within kNear of a half-integer (|d| > 1/2 - kNear), ties included;
// `near` is set for such an x and the caller then takes quant's IEEE
// division (tests/test_torch_mrf_int8_cluster.py holds the two against each
// other on adversarial values).
constexpr float kNear = 1.0f / 16384;
constexpr float kMagic = 12582912.0f;   // 1.5 * 2^23
__device__ __forceinline__ uint32_t quant_fast(float a, float rs, bool& near) {
  const float x = __fmul_rn(a, rs);
  const float t = __fadd_rn(x, kMagic);
  const float d = __fsub_rn(x, __fsub_rn(t, kMagic));
  near |= !(fabsf(d) <= 0.5f - kNear);
  const int q = static_cast<int>(__float_as_uint(t) - 0x4B400000u);
  return static_cast<uint32_t>(min(max(q, -127), 127)) & 0xffu;
}

__device__ __forceinline__ float act_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
}

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// All threads of the cluster (every thread of every CTA calls it).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address of `addr` (a shared::cta address) in CTA rank.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// A wait that has not ended after ~2^35 cycles (tens of seconds) traps:
// a protocol fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void watchdog(long long& t0) {
  if (t0 == 0) t0 = clock64();
  else if (clock64() - t0 > (1LL << 35)) __trap();
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    watchdog(t0);
  }
}

// Arrive on the mbarrier at shared::cluster address bar (any CTA's), with
// the default release at CTA scope: it orders nothing but the arrival (a
// consumer's wgmma reads of a slot are complete before it releases it).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The same bytes into dst of every CTA in mask, each completing on its own
// mbarrier at the offset of bar.
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// Stores into another CTA's shared memory (shared::cluster addresses) that
// count their bytes towards the transaction count of its mbarrier bar: the
// receiver's wait on bar sees the data, with no fence on either side.
__device__ __forceinline__ void st_async_b32(uint32_t addr, uint32_t v,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];\n" ::"r"(addr), "r"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async_v4(uint32_t addr, uint4 v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr), "r"(v.x), "r"(v.y),
      "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the accumulators to the wait before them, so that no read of them
// is scheduled while a wgmma may still write them.
template <int N> __device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, K-major without swizzle: 8-row core
// matrices of 16 bytes a row, lbo bytes between the two core matrices of a
// k32 step (along K), sbo bytes between 8-row groups (along M or N).
__device__ __forceinline__ uint64_t desc_ns(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

#define TK_D8(i)                                                         \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),            \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define TK_R8(a, b, c, d_, e, f, g, h) \
  "%" #a ", %" #b ", %" #c ", %" #d_ ", %" #e ", %" #f ", %" #g ", %" #h

// D (64 x N, s32) = A (64 x 32, s8) . B (32 x N, s8) + (scale_d ? D : 0),
// both operands in shared memory, K-major.
template <int N> __device__ __forceinline__ void wgmma_s8(
    int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <> __device__ __forceinline__ void wgmma_s8<32>(
    int (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      TK_R8(0, 1, 2, 3, 4, 5, 6, 7) ", " TK_R8(8, 9, 10, 11, 12, 13, 14, 15)
      "}, %16, %17, p;\n}\n"
      : TK_D8(0), TK_D8(8)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_s8<96>(
    int (&d)[48], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      TK_R8(0, 1, 2, 3, 4, 5, 6, 7) ", " TK_R8(8, 9, 10, 11, 12, 13, 14, 15)
      ", " TK_R8(16, 17, 18, 19, 20, 21, 22, 23) ", "
      TK_R8(24, 25, 26, 27, 28, 29, 30, 31) ", "
      TK_R8(32, 33, 34, 35, 36, 37, 38, 39) ", "
      TK_R8(40, 41, 42, 43, 44, 45, 46, 47)
      "}, %48, %49, p;\n}\n"
      : TK_D8(0), TK_D8(8), TK_D8(16), TK_D8(24), TK_D8(32), TK_D8(40)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef TK_R8
#undef TK_D8

// The tap ring as a consumer walks it: the next slot to wait for and the
// parity of its round, and the next slot to release.
struct Ring {
  uint32_t base, full, empty;   // shared::cta addresses
  int slots, slot, rslot, S;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++slot == slots) { slot = 0; phase ^= 1; }
  }
  // One arrival from each consumer warp on the slot's empty barrier of every
  // CTA of the cluster: the producers refill it once all S CTAs are done.
  __device__ __forceinline__ void release(int lane) {
    if (lane < S) mbar_arrive_remote(mapa(empty + 8 * rslot, lane));
    if (++rslot == slots) rslot = 0;
  }
};

// The producer (one thread a CTA) walks the taps in the consumers' order
// (branch, conv, pass, tap) and copies its 1/S share of each, multicast,
// into the next slot of every CTA once the cluster has released it.
template <int CP>
__device__ void produce(const int8_t* __restrict__ taps, const Plan& plan,
                        uint32_t ring, uint32_t full0, uint32_t empty0,
                        uint32_t rank) {
  constexpr int TAPB = Cfg<CP>::TAPB;
  const int S = plan.S;
  const int piece = (TAPB / S + 15) / 16 * 16;
  const int lo = (int)rank * piece;
  const int n = min(piece, TAPB - lo);
  const uint16_t mask = (uint16_t)((1u << S) - 1);
  int slot = 0, q = 0;
  uint32_t phase = 0;
  for (int br = 0; br < plan.nb; ++br)
    for (int i = 0; i < 2 * plan.nd; ++i)
      for (int p = 0; p < plan.npass; ++p)
        for (int j = 0; j < plan.ks[br]; ++j, ++q) {
          const uint32_t full = full0 + 8 * slot;
          if (q >= plan.slots) mbar_wait(empty0 + 8 * slot, phase ^ 1);
          mbar_expect_tx(full, TAPB);
          const int8_t* src = taps + plan.toff[br][i] + (long long)j * TAPB;
          const uint32_t dst = ring + slot * TAPB;
          if (S == 1)
            bulk_load(dst, src, TAPB, full);
          else if (n > 0)
            bulk_load_multicast(dst + lo, src + lo, n, full, mask);
          if (++slot == plan.slots) { slot = 0; phase ^= 1; }
        }
}

// One pass's products of a conv: for each tap j (a ring slot), the
// warpgroup's U NT-row tiles starting at local row row0, m64 tile mt of
// the tap, all Cp / 32 k-steps; every wgmma is issued unconditionally.
// Tap j's slot is released once tap j + 1's products are issued and tap j's
// are done.
template <int CP>
__device__ __forceinline__ void products(int (&acc)[Cfg<CP>::U][Cfg<CP>::NACC],
                                         Ring& rg, uint32_t qs, int QR,
                                         int rpad, int mt, int row0, int k,
                                         int d, int lane) {
  using K = Cfg<CP>;
  const int cd = (k - 1) / 2 * d;
  for (int j = 0; j < k; ++j) {
    mbar_wait(rg.full + 8 * rg.slot, rg.phase);
    TK_PHASE(kPhTapWait);
    const uint32_t tap = rg.base + rg.slot * K::TAPB;
    rg.advance();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K::KSTEPS; ++kk) {
      const uint64_t dt = desc_ns(tap + mt * 64 * 16 + kk * 2 * CP * 16,
                                  CP * 16, 128);
#pragma unroll
      for (int u = 0; u < K::U; ++u) {
        const uint32_t row = (uint32_t)(rpad + row0 + u * K::NT - cd + j * d);
        const uint64_t dq =
            desc_ns(qs + row * 16 + kk * 2 * QR * 16, QR * 16, 128);
        if constexpr (K::RM)
          wgmma_s8<CP>(acc[u], dq, dt, (j | kk) != 0);
        else
          wgmma_s8<K::NT>(acc[u], dt, dq, (j | kk) != 0);
      }
    }
    wgmma_commit();
    if (j > 0) {
      wgmma_wait<1>();
      rg.release(lane);
    }
    TK_PHASE(kPhProducts);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < K::U; ++u) fence_acc(acc[u]);
  rg.release(lane);
  TK_PHASE(kPhProducts);
}

// This CTA's rows [lr0, lr1) of the int8 window from src (its stage-dtype
// rows): a pair of rows (from an even row) and 16 channels a thread, lanes
// on consecutive pairs. A pair with a value near a rounding boundary is
// redone with the IEEE division, in a loop kept out of the unrolled path.
template <typename T, int CP>
__device__ __forceinline__ void quantize_rows(const T* src, int8_t* Q,
                                              int QR, int rpad, int L, int CB,
                                              int lr0, int lr1, float sx,
                                              float rs) {
  if (lr1 <= lr0) return;
  const int e0 = lr0 & ~1;
  const int npairs = (lr1 - e0 + 1) / 2;
  const int total = npairs * (CP / 16);
  for (int idx = threadIdx.x; idx < total; idx += kConsumers) {
    const int pr = idx % npairs, ch = idx / npairs;
    const int lr = e0 + 2 * pr;
    const T* p = src + (size_t)(ch * 16) * L + lr;
    float2 v[16];
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
      v[jj] = ch * 16 + jj < CB ? load2(p + jj * L) : make_float2(0.f, 0.f);
    uint32_t wa[4], wb[4];
    bool near = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t a = 0, b = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float2 f = v[4 * e + jj];
        a |= quant_fast(lrelu<T>(f.x), rs, near) << (8 * jj);
        b |= quant_fast(lrelu<T>(f.y), rs, near) << (8 * jj);
      }
      wa[e] = a;
      wb[e] = b;
    }
    int8_t* q = Q + ((size_t)ch * QR + rpad + lr) * 16;
    if (lr >= lr0)
      *reinterpret_cast<uint4*>(q) = make_uint4(wa[0], wa[1], wa[2], wa[3]);
    if (lr + 1 < lr1)
      *reinterpret_cast<uint4*>(q + 16) =
          make_uint4(wb[0], wb[1], wb[2], wb[3]);
    if (near) {   // rare: a quotient near a rounding boundary
#pragma unroll 1
      for (int jj = 0; jj < 16; ++jj) {
        const float2 f =
            ch * 16 + jj < CB ? load2(p + jj * L) : make_float2(0.f, 0.f);
        if (lr >= lr0) q[jj] = (int8_t)quant(lrelu<T>(f.x), sx);
        if (lr + 1 < lr1) q[16 + jj] = (int8_t)quant(lrelu<T>(f.y), sx);
      }
    }
  }
}

// The reach of the next conv (cd rows a side): after this CTA's rows of
// the int8 window are written, its first cd rows go to the left
// neighbour's window (as its rows P .. P + cd) and its last cd rows to the
// right neighbour's (as its rows -cd .. 0), by st.async counted on the
// receiver's reach barrier of round n; then the wait for this CTA's own.
template <int CP>
__device__ __forceinline__ void exchange_reach(int8_t* Q, int QR, int rpad,
                                               int P, int cd, int S,
                                               uint32_t rank, uint32_t reach0,
                                               int n) {
  fence_proxy_async();
  consumers_sync();   // this CTA's rows are in Q
  const uint32_t bar = reach0 + 8 * (n & 1);
  const bool has_l = rank > 0, has_r = (int)rank < S - 1;
  if (threadIdx.x == 0)
    mbar_expect_tx(bar, (uint32_t)((has_l + has_r) * cd * CP));
  const int per = cd * (CP / 16);
  for (int idx = threadIdx.x; idx < 2 * per; idx += kConsumers) {
    const bool right = idx >= per;
    if (right ? !has_r : !has_l) continue;
    const int e = right ? idx - per : idx;
    const int r = e % cd, ch = e / cd;
    const int src = right ? P - cd + r : r;    // this CTA's row
    const int dst = right ? r - cd : P + r;    // the neighbour's row
    const uint32_t to = right ? rank + 1 : rank - 1;
    const uint4 v = *reinterpret_cast<const uint4*>(
        Q + ((size_t)ch * QR + rpad + src) * 16);
    st_async_v4(mapa(smem_u32(Q + ((size_t)ch * QR + rpad + dst) * 16), to),
                v, mapa(bar, to));
  }
  mbar_wait(bar, (uint32_t)(n >> 1) & 1);
  fence_proxy_async();   // the received rows, for wgmma's reads
}

// The cluster's max of m (each consumer thread's) in round n: every thread
// of the CTA gets it. Each CTA sends its max by st.async into slot `rank`
// of every CTA's red[n & 1], counted on that CTA's max barrier.
__device__ __forceinline__ float cluster_max(float m, int n, float* red,
                                             float* wred, uint32_t round0,
                                             int S, uint32_t rank) {
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) wred[threadIdx.x >> 5] = m;
  consumers_sync();
  const int par = n & 1;
  const uint32_t bar = round0 + 8 * par;
  if (threadIdx.x == 0) mbar_expect_tx(bar, 4u * S);
  if (threadIdx.x < S) {
    float mm = wred[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, wred[w]);
    const uint32_t to = (uint32_t)threadIdx.x;
    st_async_b32(mapa(smem_u32(red + par * kMaxCluster + rank), to),
                 __float_as_uint(mm), mapa(bar, to));
  }
  mbar_wait(bar, (uint32_t)(n >> 1) & 1);
  float r = red[par * kMaxCluster];
  for (int s = 1; s < S; ++s) r = fmaxf(r, red[par * kMaxCluster + s]);
  return r;
}

// The epilogue of one NT-row tile (local rows r0 + [0, NT)) on D's
// (c_out, row pair) layout: dequantize, round, add the residual res (conv
// 2, in place), zero the rows outside [0, T) (local [tlo, thi)); store the
// value v to save when given (h for conv 2, conv 1's output of a pass
// before the last) and leave lrelu(v), the next conv's input, in acc (0 for
// a row outside the conv's output window, local [wlo, whi), which no conv
// reads again); the max of |lrelu(v)| over that window.
// CHECK is false for a tile inside both, as most are: no row tests.
template <typename T, int NT, bool CHECK>
__device__ __forceinline__ void epilogue_tile(
    int (&acc)[NT / 2], const T* res, T* save, int L, const int (&ch)[2],
    const bool (&cin)[2], const float (&sc)[2], const float (&bi)[2], int r0,
    int t, int wlo, int whi, int tlo, int thi, float& m) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!cin[hh]) continue;
    const T* rrow = res + (size_t)ch[hh] * L;
    T* srow = save + (size_t)ch[hh] * L;
#pragma unroll
    for (int ii = 0; ii < NT / 8; ++ii) {
      const int lr = r0 + 8 * ii + 2 * t;
      const float2 rv = res ? load2(rrow + lr) : make_float2(0.f, 0.f);
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int& a = acc[4 * ii + 2 * hh + e];
        float w = round_to<T>(
            __fadd_rn(__fmul_rn(__int2float_rn(a), sc[hh]), bi[hh]));
        if (res) w = round_to<T>((e ? rv.y : rv.x) + w);
        const int row = lr + e;
        if (CHECK && (row < tlo || row >= thi)) w = 0.f;
        const bool live = !CHECK || (row >= wlo && row < whi);
        const float l = lrelu<T>(w);
        if (live) m = fmaxf(m, fabsf(l));
        // a row outside the window is never read as an input again; its
        // value (from stale rows, any number) is dropped, so that its
        // quantization takes the fast path
        a = __float_as_int(live ? l : 0.f);
        v[e] = w;
      }
      if (save) store2(srow + lr, v[0], v[1]);
    }
  }
}

// epilogue_tile for the rows-as-M tiles (Cp = 32): D's rows are time rows
// r0 + 16 w + g + 8 h of warp w, its columns the channels 8 i + 2 t + e.
template <typename T, bool CHECK>
__device__ __forceinline__ void epilogue_tile_rm(
    int (&acc)[16], const T* res, T* save, int L, const int (&ch)[8],
    const bool (&cin)[8], const float (&sc)[8], const float (&bi)[8], int r0,
    int wl, int g, int wlo, int whi, int tlo, int thi, float& m) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * wl + g + 8 * h;
    const bool valid = !CHECK || (row >= tlo && row < thi);
    const bool live = !CHECK || (row >= wlo && row < whi);
#pragma unroll
    for (int q = 0; q < 8; ++q) {   // q = 2 i + e
      if (!cin[q]) continue;
      int& a = acc[4 * (q >> 1) + 2 * h + (q & 1)];
      float w = round_to<T>(
          __fadd_rn(__fmul_rn(__int2float_rn(a), sc[q]), bi[q]));
      const int at = ch[q] * L + row;   // ch[q] * L < 2^31
      if (res) w = round_to<T>(to_f<T>(res[at]) + w);
      if (!valid) w = 0.f;
      const float l = lrelu<T>(w);
      if (live) m = fmaxf(m, fabsf(l));
      a = __float_as_int(live ? l : 0.f);   // as in epilogue_tile
      if (save) save[at] = from_f<T>(w);
    }
  }
}

// The next conv's input rows of the warpgroup's tiles in the last pass
// (local rows row0 + u NT + [0, NT)), quantized from the registers, where
// the epilogue left lrelu of the conv's output, into the int8 window: one
// byte a value. The values of a group of 8 with one near a rounding
// boundary are redone with the IEEE division.
template <int CP, int NCH>
__device__ __forceinline__ void quantize_regs(
    const int (&acc)[Cfg<CP>::U][Cfg<CP>::NACC], int8_t* Q, int QR, int rpad,
    const int (&ch)[NCH], const bool (&cin)[NCH], int row0, int wl, int g,
    int t, float sx, float rs) {
  using K = Cfg<CP>;
  // the fast path is one branch-free block; a value near a rounding
  // boundary flags its group of 8 (bit G), and only flagged groups are
  // redone with the division
  uint32_t flagged = 0;
  if constexpr (K::RM) {   // rows 16 wl + g + 8 h of each tile, 8 channels
    auto at = [&](int u, int h, int q) {   // group u 2 + h
      return Q + (rpad + row0 + u * K::NT + 16 * wl + g + 8 * h) * 16 +
             (ch[q] >> 4) * QR * 16 + (ch[q] & 15);
    };
    auto val = [&](int u, int h, int q) {
      return __int_as_float(acc[u][4 * (q >> 1) + 2 * h + (q & 1)]);
    };
#pragma unroll
    for (int u = 0; u < K::U; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < NCH; ++q) {
          if (!cin[q]) continue;
          bool near = false;
          *at(u, h, q) = (int8_t)quant_fast(val(u, h, q), rs, near);
          flagged |= (uint32_t)near << (2 * u + h);
        }
    if (flagged) {   // rare
#pragma unroll
      for (int u = 0; u < K::U; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if ((flagged >> (2 * u + h)) & 1u) {
#pragma unroll
            for (int q = 0; q < NCH; ++q)
              if (cin[q]) *at(u, h, q) = (int8_t)quant(val(u, h, q), sx);
          }
    }
    return;
  }
  // transposed: channels ch[hh], rows 2 t + 8 ii + e of each tile; a group
  // is 4 ii of one hh
  constexpr int G = K::NT / 32;   // groups per (u, hh)
  auto at = [&](int u, int hh, int ii, int e) {
    return Q + ((ch[hh] >> 4) * QR + rpad + row0 + u * K::NT + 2 * t +
                8 * ii + e) * 16 + (ch[hh] & 15);
  };
  auto val = [&](int u, int hh, int ii, int e) {
    return __int_as_float(acc[u][4 * ii + 2 * hh + e]);
  };
#pragma unroll
  for (int u = 0; u < K::U; ++u)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!cin[hh]) continue;
#pragma unroll
      for (int ii = 0; ii < K::NT / 8; ++ii)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bool near = false;
          *at(u, hh, ii, e) = (int8_t)quant_fast(val(u, hh, ii, e), rs, near);
          flagged |= (uint32_t)near << ((u * 2 + hh) * G + ii / 4);
        }
    }
  if (flagged) {   // rare
#pragma unroll
    for (int u = 0; u < K::U; ++u)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          if (cin[hh] && ((flagged >> ((u * 2 + hh) * G + gi)) & 1u)) {
#pragma unroll
            for (int ii = 4 * gi; ii < 4 * gi + 4; ++ii)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                *at(u, hh, ii, e) = (int8_t)quant(val(u, hh, ii, e), sx);
          }
  }
}

template <typename T, int CP>
__global__ void __launch_bounds__(kThreads, 1)
mrf_int8_cluster(const T* __restrict__ x, T* __restrict__ y,
                 const int8_t* __restrict__ taps,
                 const float* __restrict__ scales,
                 const float* __restrict__ biases, Plan plan, int Tlen, int C,
                 int TS, long long xsb, long long xst, long long xsc,
                 long long ysb, long long yst, long long ysc) {
  using K = Cfg<CP>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = plan.S, P = plan.P;
  const uint32_t rank = cluster_rank();
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + kFullOff, empty0 = sbase + kEmptyOff;
  const uint32_t round0 = sbase + kRoundOff, reach0 = sbase + kReachOff;
  float* red = reinterpret_cast<float*>(smem + kRedOff);
  float* wred = reinterpret_cast<float*>(smem + kWredOff);
  const uint32_t ring = sbase + kHeader;
  int8_t* Q = reinterpret_cast<int8_t*>(smem + kHeader +
                                        plan.slots * K::TAPB);
  const int rpad = plan.cdmax;
  const int QR = P + 2 * rpad;
  const int L = P + 8;
  const int CB = (C + 7) / 8 * 8;
  T* A = reinterpret_cast<T*>(Q + (size_t)CP * QR);    // h
  T* Bf = A + (size_t)CB * L;   // conv 1's output, when P is several passes
  T* M = Bf + (plan.npass > 1 ? (size_t)CB * L : 0);   // the branch sum

  if (threadIdx.x == 0) {
    for (int s = 0; s < plan.slots; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWarps * S);
    }
    for (int i = 0; i < 2; ++i) {   // one arrival (with the expected bytes)
      mbar_init(round0 + 8 * i, 1);
      mbar_init(reach0 + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (threadIdx.x >= kConsumers) {   // the producer warp
    if (threadIdx.x == kConsumers)
      produce<CP>(taps, plan, ring, full0, empty0, rank);
    cluster_sync();
    return;
  }
  TK_PHASE_START();

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * TS;
  const int base = (int)rank * P;        // window row of local row 0
  const int g0 = t0 - plan.lmax + base;  // time step of local row 0
  const T* xb = x + b * xsb;
  T* yb = y + b * ysb;
  // 16-byte vectors along time: rows of x and y aligned
  constexpr int kVec = 16 / sizeof(T);
  const bool xvec = xsc % kVec == 0 && xsb % kVec == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool yvec = ysc % kVec == 0 && ysb % kVec == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int wl = warp % 4, g = lane >> 2, t = lane & 3;
  const int mt = wg % K::MT;
  const int wrow0 = wg / K::MT * K::WGROWS;   // in a pass
  const uint32_t qs = smem_u32(Q);
  Ring rg;
  rg.base = ring;
  rg.full = full0;
  rg.empty = empty0;
  rg.slots = plan.slots;
  rg.slot = rg.rslot = 0;
  rg.S = S;
  rg.phase = 0;
  const int nconv = 2 * plan.nd;
  int round = 0;
  int acc[K::U][K::NACC];

  for (int br = 0; br < plan.nb; ++br) {
    const int k = plan.ks[br];
    int lo = plan.lmax - plan.ext[br];
    int hi = plan.lmax + TS + plan.ext[br];

    // x rows of the window into A (zeros outside [0, T) and past C), the
    // first conv's max. Lanes on consecutive time steps when x is (B, C, T).
    {
      const int r0 = max(0, lo - base), r1 = min(P, hi - base);
      float m = 0.f;
      if (xst == 1) {
        // groups of 8 time steps aligned in time, lanes on consecutive
        // groups of one channel, 4 groups in flight a thread
        const int gs = g0 + r0, ge = g0 + r1;
        const int m0 = (gs >= 0 ? gs : gs - 7) / 8;   // floor(gs / 8)
        const int ng = max(0, (ge + 7 - 8 * m0) / 8);
        const int total = ng * CB;
        for (int b0 = tid; b0 < total; b0 += 2 * kConsumers) {
          float v[2][8];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int idx = b0 + u * kConsumers;
            const int grp = idx % ng, c = idx / ng;
            if (idx < total && c < C)
              load_time8(xb + c * xsc, 8 * (m0 + grp), Tlen, xvec, v[u]);
            else
              for (int e = 0; e < 8; ++e) v[u][e] = 0.f;
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int idx = b0 + u * kConsumers;
            if (idx >= total) continue;
            const int grp = idx % ng, c = idx / ng;
            const int rb = 8 * (m0 + grp) - g0;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (rb + e >= r0 && rb + e < r1) {
                A[(size_t)c * L + rb + e] = from_f<T>(v[u][e]);
                m = fmaxf(m, fabsf(lrelu<T>(v[u][e])));
              }
          }
        }
      } else {          // a warp a row, lanes along the channels
        for (int r = r0 + warp; r < r1; r += kWarps)
          for (int c = lane; c < CB; c += 32) {
            const int gt = g0 + r;
            const float v = gt >= 0 && gt < Tlen && c < C
                                ? to_f<T>(xb[(long long)gt * xst + c * xsc])
                                : 0.f;
            A[(size_t)c * L + r] = from_f<T>(v);
            m = fmaxf(m, fabsf(lrelu<T>(v)));
          }
      }
      TK_PHASE(kPhX);
      float sx = act_scale(cluster_max(m, round++, red, wred, round0, S,
                                       rank));
      TK_PHASE(kPhClusterMax);
      // the first conv's input: this CTA's rows of x quantized, the reach
      // exchanged with the neighbours
      quantize_rows<T, CP>(A, Q, QR, rpad, L, CB, max(0, lo - base),
                           min(P, hi - base), sx, __frcp_rn(sx));
      TK_PHASE(kPhQuant);
      exchange_reach<CP>(Q, QR, rpad, P, (k - 1) / 2 * plan.dil[0], S, rank,
                         reach0, br * nconv);
      TK_PHASE(kPhReach);

      for (int i = 0; i < nconv; ++i) {
        const bool conv1 = i % 2 == 0;
        const int d = conv1 ? plan.dil[i / 2] : 1;
        const int h = plan.halo[br][i];
        const int n = br * nconv + i;
        const int olo = lo + h, ohi = hi - h;   // output window
        // this thread's output channels: two of its m64 tile, or (rows
        // as M) eight of the 32
        constexpr int NCH = K::RM ? 8 : 2;
        float sc[NCH], bi[NCH];
        int ch[NCH];
        bool cin[NCH];
#pragma unroll
        for (int q = 0; q < NCH; ++q) {
          const int c = K::RM ? 8 * (q >> 1) + 2 * t + (q & 1)
                              : mt * 64 + wl * 16 + g + 8 * q;
          ch[q] = c;
          cin[q] = c < CB;
          sc[q] = cin[q] ? __fmul_rn(sx, scales[(size_t)n * CP + c]) : 0.f;
          bi[q] = cin[q] ? biases[(size_t)n * CP + c] : 0.f;
        }
        // conv 2 adds h in place; conv 1's output is kept in shared memory
        // only for the passes before the last (the last stays in registers)
        const T* res = conv1 ? nullptr : A;
        float m = 0.f;
        for (int p = 0; p < plan.npass; ++p) {
          const int prow = p * K::PASS + wrow0;   // the warpgroup's first row
          products<CP>(acc, rg, qs, QR, rpad, mt, prow, k, d, lane);

          // epilogue; rows in local coordinates
          T* save = conv1 ? (p + 1 < plan.npass ? Bf : nullptr) : A;
          const int wlo = olo - base, whi = ohi - base;
          const int tlo = -g0, thi = Tlen - g0;
#pragma unroll
          for (int u = 0; u < K::U; ++u) {
            const int tr0 = prow + u * K::NT;
            const bool inside = tr0 >= max(wlo, tlo) &&
                                tr0 + K::NT <= min(whi, thi);
            if constexpr (K::RM) {
              if (inside)
                epilogue_tile_rm<T, false>(acc[u], res, save, L, ch, cin, sc,
                                           bi, tr0, wl, g, wlo, whi, tlo, thi,
                                           m);
              else
                epilogue_tile_rm<T, true>(acc[u], res, save, L, ch, cin, sc,
                                          bi, tr0, wl, g, wlo, whi, tlo, thi,
                                          m);
            } else if (inside) {
              epilogue_tile<T, K::NT, false>(acc[u], res, save, L, ch, cin,
                                             sc, bi, tr0, t, wlo, whi, tlo,
                                             thi, m);
            } else {
              epilogue_tile<T, K::NT, true>(acc[u], res, save, L, ch, cin, sc,
                                            bi, tr0, t, wlo, whi, tlo, thi,
                                            m);
            }
          }
          TK_PHASE(kPhEpilogue);
        }
        lo = olo;
        hi = ohi;
        if (i + 1 == nconv) {
          consumers_sync();   // A holds the branch output in every row
          break;
        }
        sx = act_scale(cluster_max(m, round++, red, wred, round0, S, rank));
        TK_PHASE(kPhClusterMax);
        // the next conv's input: the last pass's rows from the registers,
        // the earlier passes' from shared memory; the reach exchanged
        const float rs = __frcp_rn(sx);
        const int last = (plan.npass - 1) * K::PASS;
        if (last > 0)
          quantize_rows<T, CP>(conv1 ? Bf : A, Q, QR, rpad, L, CB,
                               max(0, lo - base), min(last, hi - base), sx,
                               rs);
        quantize_regs<CP, NCH>(acc, Q, QR, rpad, ch, cin, last + wrow0, wl, g,
                               t, sx, rs);
        TK_PHASE(kPhQuant);
        const int dn = (i + 1) % 2 == 0 ? plan.dil[(i + 1) / 2] : 1;
        exchange_reach<CP>(Q, QR, rpad, P, (k - 1) / 2 * dn, S, rank, reach0,
                           n + 1);
        TK_PHASE(kPhReach);
      }
    }

    // branch mean over this CTA's rows of the tile, accumulated in M (msum)
    // or else in y: s = h0; s = s + h1; ...; y = (s + hn) / n
    {
      const bool first = br == 0, last = br == plan.nb - 1;
      const bool in_m = plan.msum != 0;   // the sum so far lies in M
      const int r0 = max(0, plan.lmax - base);
      const int r1 = min(P, min(plan.lmax + TS, plan.lmax + Tlen - t0) - base);
      auto mean = [&](float h, float prev) {
        if (!first) h = round_to<T>(prev + h);
        return last ? round_to<T>(h / (float)plan.nb) : h;
      };
      if (yst == 1) {
        // groups of 8 time steps aligned in time, as the x load; a group
        // wholly inside the rows is one 16-byte load and store of y
        const int gs = g0 + r0, ge = g0 + r1;
        const int m0 = (gs >= 0 ? gs : gs - 7) / 8;
        const int ng = max(0, (ge + 7 - 8 * m0) / 8);
        const int total = ng * C;
        for (int b0 = tid; b0 < total; b0 += 2 * kConsumers) {
          float prev[2][8];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int idx = b0 + u * kConsumers;
            const int grp = idx % ng, c = idx / ng;
            const int tb = 8 * (m0 + grp);
            const bool whole = yvec && tb >= gs && tb + 8 <= ge;
            if (idx < total && !first && !in_m && whole)
              load8(yb + c * ysc + tb, prev[u]);
            else
              for (int e = 0; e < 8; ++e) prev[u][e] = 0.f;
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int idx = b0 + u * kConsumers;
            if (idx >= total) continue;
            const int grp = idx % ng, c = idx / ng;
            const int tb = 8 * (m0 + grp);
            const T* hrow = A + (size_t)c * L + (tb - g0);
            T* dst = yb + c * ysc + tb;
            if (in_m) {   // rows of M; y written once, by the last branch
              T* mrow = M + (size_t)c * L + (tb - g0);
              float w[8];
#pragma unroll
              for (int e = 0; e < 8; ++e)
                w[e] = tb + e >= gs && tb + e < ge
                           ? mean(to_f<T>(hrow[e]),
                                  first ? 0.f : to_f<T>(mrow[e]))
                           : 0.f;
              if (!last) {
                for (int e = 0; e < 8; ++e)
                  if (tb + e >= gs && tb + e < ge) mrow[e] = from_f<T>(w[e]);
              } else if (yvec && tb >= gs && tb + 8 <= ge) {
                store8(dst, w);
              } else {
                for (int e = 0; e < 8; ++e)
                  if (tb + e >= gs && tb + e < ge) dst[e] = from_f<T>(w[e]);
              }
            } else if (yvec && tb >= gs && tb + 8 <= ge) {
              float w[8];
#pragma unroll
              for (int e = 0; e < 8; ++e)
                w[e] = mean(to_f<T>(hrow[e]), prev[u][e]);
              store8(dst, w);
            } else {
              for (int e = 0; e < 8; ++e)
                if (tb + e >= gs && tb + e < ge)
                  dst[e] = from_f<T>(
                      mean(to_f<T>(hrow[e]), first ? 0.f : to_f<T>(dst[e])));
            }
          }
        }
      } else {          // a warp a row, lanes along the channels
        for (int r = r0 + warp; r < r1; r += kWarps)
          for (int c = lane; c < C; c += 32) {
            T* dst = yb + (long long)(g0 + r) * yst + c * ysc;
            T* acc_at = in_m && !last ? M + (size_t)c * L + r : dst;
            const T* prev_at = in_m ? M + (size_t)c * L + r : dst;
            *acc_at = from_f<T>(mean(to_f<T>(A[(size_t)c * L + r]),
                                     first ? 0.f : to_f<T>(*prev_at)));
          }
      }
      consumers_sync();   // the next branch's x load rewrites A
      TK_PHASE(kPhMean);
    }
  }
  TK_PHASE_END();
  // no CTA leaves while another may still read its rows or arrive on its
  // barriers
  cluster_sync();
}

template <typename T, int CP>
cudaError_t launch(const void* x, void* y, const void* taps,
                   const void* scales, const void* biases, const Plan& plan,
                   int B, int Tlen, int C, int TS, int n_tiles, long long xsb,
                   long long xst, long long xsc, long long ysb, long long yst,
                   long long ysc, cudaStream_t stream) {
  const size_t smem = (size_t)smem_bytes(CP, C, plan.P, plan.cdmax,
                                         plan.slots, plan.msum,
                                         (int)sizeof(T));
  auto kern = mrf_int8_cluster<T, CP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.S, n_tiles, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x),
                           static_cast<T*>(y),
                           static_cast<const int8_t*>(taps),
                           static_cast<const float*>(scales),
                           static_cast<const float*>(biases), plan, Tlen, C,
                           TS, xsb, xst, xsc, ysb, yst, ysc);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs (mrf_int8.int8_plan's sum);
// the wrapper and the entry point refuse a plan above 232,448.
extern "C" long long tk_mrf_int8_cluster_smem(int Cp, int C, int P,
                                              int cdmax, int slots, int msum,
                                              int is_bf16) {
  return smem_bytes(Cp, C, P, cdmax, slots, msum, is_bf16 ? 2 : 4);
}

// Rows one pass of a CTA covers at Cp (P is a multiple of it).
extern "C" int tk_mrf_int8_pass_rows(int Cp) { return pass_rows(Cp); }

// halos: nb x (2 nd) steps each conv trims from its window a side, branch-
// major, chain order. S, P, slots, msum: the plan (a cluster of S CTAs a
// window, P rows each, a ring of `slots` taps, the branch sum in shared
// memory or in y). Returns a cudaError_t value: 0 on a
// successful launch, cudaErrorInvalidValue for arguments or a plan it
// refuses.
extern "C" int tk_mrf_int8_cluster_stage(
    const void* x, void* y, const void* taps, const void* scales,
    const void* biases, int is_bf16, int B, int Tlen, int C, int Cp, int TS,
    int n_tiles, int nb, const int* ks, int nd, const int* dil,
    const int* halos, int S, int P, int slots, int msum, long long xsb,
    long long xst,
    long long xsc, long long ysb, long long yst, long long ysc,
    void* stream) {
  if (nb < 1 || nb > kMaxBranch || nd < 1 || nd > kMaxDil || C < 1 ||
      C > Cp || !(Cp == 32 || Cp == 64 || Cp == 128) || TS < 1 || Tlen < 1 ||
      B < 1 || B > 65535 || n_tiles < 1 || n_tiles > 65535 ||
      (long long)n_tiles * TS < Tlen || S < 1 || S > kMaxCluster ||
      slots < 2 || slots > kMaxSlots || P < pass_rows(Cp) ||
      P % pass_rows(Cp) != 0)
    return (int)cudaErrorInvalidValue;
  Plan plan = {};
  plan.nb = nb;
  plan.nd = nd;
  plan.S = S;
  plan.P = P;
  plan.npass = P / pass_rows(Cp);
  plan.slots = slots;
  plan.msum = msum != 0;
  for (int p = 0; p < nd; ++p) {
    if (dil[p] < 1) return (int)cudaErrorInvalidValue;
    plan.dil[p] = dil[p];
  }
  const long long tapb = tap_bytes(Cp);
  long long off = 0;
  for (int br = 0; br < nb; ++br) {
    const int k = ks[br];
    if (k < 1 || k % 2 == 0) return (int)cudaErrorInvalidValue;
    plan.ks[br] = k;
    int ext = 0;
    for (int i = 0; i < 2 * nd; ++i) {
      const int d = (i % 2 == 0) ? dil[i / 2] : 1;
      const int cd = (k - 1) / 2 * d;
      const int h = halos[br * 2 * nd + i];
      if (h < cd) return (int)cudaErrorInvalidValue;   // reads past the window
      plan.cdmax = cd > plan.cdmax ? cd : plan.cdmax;
      plan.halo[br][i] = h;
      ext += h;
      plan.toff[br][i] = off;
      off += (long long)k * tapb;
    }
    plan.ext[br] = ext;
    plan.lmax = ext > plan.lmax ? ext : plan.lmax;
  }
  // the cluster covers the widest window; a reach comes from the next CTA
  // only; the shared bytes fit
  if ((long long)S * P < TS + 2LL * plan.lmax ||
      (S > 1 && P < plan.cdmax) ||
      smem_bytes(Cp, C, P, plan.cdmax, slots, msum, is_bf16 ? 2 : 4) >
          kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
#define TK_LAUNCH(TYPE, CP)                                                  \
  launch<TYPE, CP>(x, y, taps, scales, biases, plan, B, Tlen, C, TS,         \
                   n_tiles, xsb, xst, xsc, ysb, yst, ysc, s)
  cudaError_t err;
  if (is_bf16)
    err = Cp == 32 ? TK_LAUNCH(BF, 32) : Cp == 64 ? TK_LAUNCH(BF, 64)
                                                  : TK_LAUNCH(BF, 128);
  else
    err = Cp == 32 ? TK_LAUNCH(float, 32) : Cp == 64 ? TK_LAUNCH(float, 64)
                                                     : TK_LAUNCH(float, 128);
#undef TK_LAUNCH
  return (int)err;
}

#ifdef TK_PROFILE_PHASES
// Copies the phase counters to out (host memory, kPhases values) and zeroes
// them.
extern "C" int tk_mrf_int8_phase_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif

extern "C" const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
