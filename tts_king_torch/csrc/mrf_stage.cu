// One HiFi-GAN MRF stage, fused: the mean over ResBlock1 branches of
//     3 x [lrelu 0.1 -> conv(k, dilation d) -> lrelu 0.1 -> conv(k, 1) -> + residual]
// for inputs of C <= 128 channels, f32 or bf16, inference only.
//
// Replaces: tts_king_tpu/ops/pallas/mrf_packed.py, fused_mrf_packed (bf16/f32
// mode; kernel body `kernel`, wrapper mrf_stage_apply). The TPU kernel works
// on a space-to-depth packed layout so that narrow convs fill the 128-lane
// matrix unit; that packing is a TPU lowering and is not carried over. This
// kernel computes the unpacked function on (B, T, C).
//
// What bounds it on an H100: at the shipped width (k = 3, 7, 11; dilations
// 1, 3, 5) a stage is 2 * 21 * 6 * C^2 operations per time step against
// 2 * C elements in and out, thousands of operations per byte, so the
// stage is bound by arithmetic on the tensor cores: bf16 (989 TFLOP/s) in
// bf16; in f32 3xTF32 (each f32 product as three TF32 products, 495 / 3
// TFLOP/s), which keeps f32's accuracy to a few ulps (attention_mma.cuh).
//
// bf16 (mrf_stage_tc): one block per (batch item, tile of TT time steps).
// All 18 convs of the stage run on the tile in shared memory, so x is read
// and y written once per branch instead of once per conv. Each branch reads
// x with its own halo (k=11: 60 rows a side, k=7: 36, k=3: 12); every conv
// shrinks the live rows by its reach. Two buffers of (TT + 2 * max halo)
// rows suffice: A holds the residual stream h; conv1 reads lrelu(A) and
// writes lrelu(conv1) into B; conv2 reads B and adds into A in place (each
// element of A is read and then written by one thread). Rows outside
// [0, T) are zeroed after every conv and after every residual add, which
// reproduces per-conv zero padding at the sequence edges, and a tile's halo
// never reads a neighbouring batch item. The tile TT and the ring's slots
// come from the wrapper's tile_plan (ops/kernels/mrf.py); the entry point
// checks that they fit.
//
// f32 (mrf_pass_f32, mrf_mean_f32), sized for speak's batch of one, where
// a stage's tiles alone give too few blocks and f32 activations (4 bytes a
// channel) leave little shared memory beside a halo:
//   * a pass per dilation pair, each a grid of blocks per (tile of TT
//     steps, branch, batch item): three times the blocks of a grid over
//     tiles, and a reach of c (d + 1) rows a side instead of the branch's
//     whole halo. A block reads its branch's h (x in the first pass) over
//     TT + 2 c (d + 1) rows, runs conv1 over TT + 2 c rows and conv2 over TT
//     rows, and writes h + conv2 to a scratch buffer in L2 that the next
//     pass reads; then a last pass averages the branches' buffers in branch
//     order, ((h0 + h1) + h2) / 3, with no atomics. The widest branch's
//     blocks come first in the grid, so the lighter ones fill the tail;
//   * products on mma.sync.m16n8k8.tf32 as 3xTF32 (attention_mma.cuh's
//     split and passes): M = time rows, N = output channels, K = input
//     channels per tap; the 8 consumer warps share the conv's window as
//     up to 2 m16 tiles each (two warps across the channels at Cp = 128);
//     A fragments by ldmatrix.x4 from the shifted rows (one row address a
//     lane, so any tap shift is free; conv1's leaky ReLU applied before the
//     split), B fragments by ldmatrix.x4 from the tap chunk, both split to
//     hi / lo in registers; each 16-channel chunk's products summed from
//     zero and added to the conv's sums on the CUDA cores (products_f32);
//   * taps packed once in chunks of 16 input channels (Cp rows of 20
//     floats; mrf.py's f32_tap_offset), which a producer warp streams with
//     cp.async.bulk into a ring of slots on mbarriers while the consumers
//     multiply; the consumer warps release each slot once their products
//     that read it are issued;
//   * rows are Cp + 4 floats apart (4 times an odd number of words), so the
//     8 rows of an ldmatrix fall in distinct banks. Conv1's rows outside
//     [0, T) are zeroed, the input's are loaded as zeros, and h + conv2 is
//     written on [0, T) only: per-conv zero padding at the sequence edges.
//
// bf16 (conv_tc, mrf_stage_tc), a warp-specialised Hopper kernel:
//   * products: a conv over a window is a sum of shifted GEMMs,
//     out[t, :] += in[t + (j - c) d, :] . W_j, with M = time rows, N = Cp
//     output channels and K = Cp input channels per tap. Each consumer
//     warpgroup holds MT 64-row tiles of the conv's whole window in its
//     accumulators (wgmma.mma_async m64nCpk16, f32), so every tap is read
//     once per conv. A shifted tap starts at any row, which a shared-memory
//     descriptor's 8-row swizzle atoms cannot address, so A comes from
//     registers: ldmatrix.x4 with one row address per lane, and conv1's
//     leaky ReLU applied to the fragments. B is the tap in shared memory;
//   * taps: packed once by the wrapper in wgmma's canonical K-major layout
//     (128-byte swizzle at Cp >= 64, 64- and 32-byte at Cp = 32, 16;
//     mrf.py's tap_byte_offset), so one chunk (a K-half of a tap at Cp = 128,
//     a whole tap below) is one contiguous cp.async.bulk completing on an
//     mbarrier. Every block consumes the stage's 126 taps in the same order:
//     a producer warpgroup (one issuing thread, registers released with
//     setmaxnreg) keeps a ring of `slots` chunks full while the consumers
//     multiply, and the consumer warps release each slot through a second
//     mbarrier once their products that read it are done;
//   * between convs, a named barrier over the consumer warpgroups (conv n+1
//     reads rows other warpgroups wrote in conv n); the producer runs ahead;
//   * the epilogue works on the accumulator's (row, column pair) layout,
//     which is mma.sync's C layout per warp: bias, rounding, leaky ReLU or
//     the residual add, the row mask;
//   * x comes in and y goes out along time in 16-byte vectors when the
//     tensor is a (B, C, T) view (the Generator's), transposed on the way
//     into shared memory with a warp's 32 lanes on 32 channels of one row.
//
// Rounding, as in the TPU kernel and the plain version: f32 accumulation, the
// sum rounded to the working type once, then the bias added in that type; the
// leaky ReLU, the residual add and each step of the branch mean round to the
// working type. bf16 accumulates the branch mean in y itself (each block owns
// its rows of y).
//
// Layout: x and y are (B, T, C) views given by element strides, so a
// (B, C, T) tensor from nn.ConvTranspose1d can be passed without a copy.
// Weights are packed once by the wrapper: for branch b (branch-major), conv
// n in chain order [convs1_0, convs2_0, convs1_1, ...], a block of k_b taps,
// in bf16 the swizzled K-major B layout, in f32 chunks of 16 input channels
// of Cp rows (c_out) of 20 floats; Cp = 16, 32, 64 or 128, zero past C.
// Biases (Cp,) per conv in the same order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"   // the 3xTF32 split and mma.sync passes

namespace {

constexpr int kMaxBranch = 4;
constexpr int kMaxDil = 4;
constexpr int kMaxC = 128;
constexpr float kSlope = 0.1f;
constexpr long long kSmemLimit = 232448;

#ifdef TK_PROFILE_PHASES
// Phase marks, for scripts/probe_mrf_int8.py --kernel bf16|f32 --phases:
// thread 0 (a consumer) adds the cycles since its previous mark to the
// phase the mark closes, each with the barrier that ends it. bf16: x load,
// tap wait, products, epilogue, branch mean; f32 (the passes): h load, tap
// wait, products, conv1's epilogue, conv2's epilogue with the store of h.
__device__ unsigned long long g_phase_cycles[5];
__shared__ long long s_phase[6];   // 5 sums, then the last mark
#define TK_PHASE_START()                                              \
  do {                                                                \
    if (threadIdx.x == 0) {                                           \
      for (int i_ = 0; i_ < 5; ++i_) s_phase[i_] = 0;                 \
      s_phase[5] = clock64();                                         \
    }                                                                 \
  } while (0)
#define TK_PHASE(i)                                                   \
  do {                                                                \
    if (threadIdx.x == 0) {                                           \
      const long long now_ = clock64();                               \
      s_phase[i] += now_ - s_phase[5];                                \
      s_phase[5] = now_;                                              \
    }                                                                 \
  } while (0)
#define TK_PHASE_END()                                                \
  do {                                                                \
    if (threadIdx.x == 0)                                             \
      for (int i_ = 0; i_ < 5; ++i_)                                  \
        atomicAdd(&g_phase_cycles[i_], (unsigned long long)s_phase[i_]); \
  } while (0)
#else
#define TK_PHASE_START() do { } while (0)
#define TK_PHASE(i) do { } while (0)
#define TK_PHASE_END() do { } while (0)
#endif

struct Plan {
  int nb;                            // branches
  int nd;                            // dilation pairs per branch
  int ks[kMaxBranch];                // kernel size per branch
  int dil[kMaxDil];                  // dilation of each conv1
  int halo[kMaxBranch];              // rows of reach per branch and side
  int hmax;
  int cmax, rmax;                    // f32: widest c and pass reach c (d + 1)
  long long woff[kMaxBranch][2 * kMaxDil];  // element offset of each conv's taps
};

// v rounded to bf16, as a float.
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ------------------------------------------------- bf16: wgmma + bulk copies

using BF = __nv_bfloat16;

constexpr int kConsumerWGs = 2;                       // consumer warpgroups
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreadsTC = kConsumers + 128;          // + the producer's
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kRingAlign = 1024;                      // the swizzle atom's repeat
constexpr int kXUnroll = 4;                           // 16-byte loads in flight

template <int CP> struct TC {
  static constexpr int MT = CP == 128 ? 3 : 5;        // m64 tiles a warpgroup holds
  static constexpr int SWB = CP >= 64 ? 128 : 2 * CP; // bytes of a swizzle-atom row
  static constexpr int KC = SWB / 2;                  // input channels per chunk
  static constexpr int NCH = CP / KC;                 // chunks per tap
  static constexpr int KSTEPS = KC / 16;              // k16 steps per chunk
  static constexpr int KG = CP == 32 ? 2 : 1;         // k16 steps per group
  static constexpr int GPC = KSTEPS / KG;             // groups per chunk
  static constexpr bool PIPE = CP == 128;             // two groups in flight
  static constexpr int CHUNK = CP * SWB;              // bytes per chunk
  static constexpr int RS = CP + 8;                   // elements between rows
  static constexpr int NACC = CP / 2;                 // f32 accumulators per tile
  static constexpr uint64_t MODE = SWB == 128 ? 1 : SWB == 64 ? 2 : 3;
};

__host__ __device__ inline int swizzle_bytes(int Cp) {
  return Cp >= 64 ? 128 : 2 * Cp;
}

// The ring (slots chunks and a full and an empty mbarrier each) at a
// 1024-byte boundary, then the two activation buffers. Rows are padded by
// 16 bytes, so the 8 rows of an ldmatrix or of an epilogue store start in
// distinct banks.
__host__ __device__ inline long long smem_bytes_tc(int Cp, int TT, int hmax,
                                                   int slots) {
  return kRingAlign + (long long)slots * (Cp * swizzle_bytes(Cp) + 16) +
         2LL * (TT + 2 * hmax) * (Cp + 8) * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
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

// bf16x2 in a 32-bit register: the correctly rounded sum, and the pair
// (lo, hi) of f32 values rounded to bf16.
__device__ __forceinline__ uint32_t add_bf2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}

// lrelu<BF> on both halves: v >= 0 gives v and v < 0 gives round(0.1 v),
// which is max(v, round(0.1 v)) either way (rounding is monotone).
__device__ __forceinline__ uint32_t lrelu_pair(uint32_t v) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  const uint32_t p = pack_bf2(f.x * kSlope, f.y * kSlope);
  uint32_t r;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(v), "r"(p));
  return r;
}

// Ties the accumulators to the wait before them, so that no read of them
// is scheduled while a wgmma may still write them.
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of one k16 slice of a tap chunk at addr:
// K-major, swizzled rows of SWB bytes, 8-row groups SBO = 8 * SWB bytes
// apart; the leading byte offset is unused in this mode (1 by convention).
template <int CP> __device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t sbo = 8 * TC<CP>::SWB;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((sbo >> 4) << 32) | (TC<CP>::MODE << 62);
}

#define TK_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TK_A_IN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), \
                "r"(scale_d)

// D (64 x N, f32) = A (64 x 16, bf16 registers) . B (16 x N, bf16, shared
// memory, K-major) + (scale_d ? D : 0).
template <int N> __device__ __forceinline__ void wgmma_rs(
    float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc, int scale_d);

template <> __device__ __forceinline__ void wgmma_rs<16>(
    float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : TK_D8(0)
      : TK_A_IN);
}

template <> __device__ __forceinline__ void wgmma_rs<32>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : TK_D8(0), TK_D8(8)
      : TK_A_IN);
}

template <> __device__ __forceinline__ void wgmma_rs<64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : TK_D8(0), TK_D8(8), TK_D8(16), TK_D8(24)
      : TK_A_IN);
}

template <> __device__ __forceinline__ void wgmma_rs<128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : TK_D8(0), TK_D8(8), TK_D8(16), TK_D8(24), TK_D8(32), TK_D8(40),
        TK_D8(48), TK_D8(56)
      : TK_A_IN);
}

#undef TK_D8
#undef TK_A_IN

// The ring's state as a consumer or the producer walks the chunks: the next
// slot to fill or wait for and the parity of its round; a consumer also
// keeps the next slot to release (one arrival per warp, from lane 0).
struct Ring {
  uint32_t base, full, empty;   // shared addresses
  int slots, slot, rslot;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++slot == slots) { slot = 0; phase ^= 1; }
  }
  __device__ __forceinline__ void release(int lane) {
    if (lane == 0) mbar_arrive(empty + 8 * rslot);
    if (++rslot == slots) rslot = 0;
  }
};

// Tiles of a window of ntiles 64-row tiles that warpgroup wg holds (tile i
// of wg is the window's tile kConsumerWGs i + wg).
__device__ __forceinline__ int tiles_held(int wg, int ntiles) {
  return ntiles > wg ? (ntiles - wg + kConsumerWGs - 1) / kConsumerWGs : 0;
}

// A conv's products on the tiles a warpgroup holds, NA of them (a
// compile-time count: each wgmma is issued unconditionally, so the compiler
// keeps the accumulators in place and does not serialize the products).
// One group is KG k16 steps of one chunk: A fragments by ldmatrix (conv1's
// leaky ReLU applied), then NA x KG wgmmas, committed. With PIPE (C = 128,
// where a group is the longest) two groups are in flight, their A fragments
// in two register sets; otherwise each group is waited for before the next
// loads its fragments. A chunk's slot is released once its last group is
// done.
template <int CP, bool CONV1, int NA>
__device__ __forceinline__ void products(
    float (&acc)[TC<CP>::MT][TC<CP>::NACC], Ring& ring,
    const uint32_t (&arow)[TC<CP>::MT], int lane, int k, int d) {
  using Cfg = TC<CP>;
  constexpr int KG = Cfg::KG, GPC = Cfg::GPC, RS = Cfg::RS;
  constexpr int NAR = NA > 0 ? NA : 1;
  const int c = (k - 1) / 2;
  const int ngroups = k * Cfg::NCH * GPC;
  uint32_t chunk = 0;
  auto group = [&](uint32_t (&a)[KG][NAR][4], int gi) {
    const int q = gi / GPC;                     // chunk of the conv
    const int j = q / Cfg::NCH, h = q % Cfg::NCH;
    const int s0 = (gi % GPC) * KG;
    if (gi % GPC == 0) {
      mbar_wait(ring.full + 8 * ring.slot, ring.phase);
      TK_PHASE(1);
      chunk = ring.base + ring.slot * Cfg::CHUNK;
      ring.advance();
    }
    if constexpr (NA > 0) {
      const uint32_t shift = (uint32_t)((j - c) * d * RS * 2);
#pragma unroll
      for (int kg = 0; kg < KG; ++kg) {
        const uint32_t kb = (uint32_t)(h * Cfg::KC + (s0 + kg) * 16) * 2;
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          ldmatrix_x4(a[kg][i], arow[i] + shift + kb);
          if (CONV1) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[kg][i][e] = lrelu_pair(a[kg][i][e]);
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kg = 0; kg < KG; ++kg) {
        const uint64_t desc = b_desc<CP>(chunk + (s0 + kg) * 32);
        const int scale_d = (gi | kg) != 0;
#pragma unroll
        for (int i = 0; i < NA; ++i) wgmma_rs<CP>(acc[i], a[kg][i], desc, scale_d);
      }
      wgmma_commit();
      if constexpr (Cfg::PIPE) {
        wgmma_wait<1>();                        // group gi - 1 is done
      } else {
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < NA; ++i) fence_acc(acc[i]);
      }
    }
    TK_PHASE(2);
    if (Cfg::PIPE ? gi > 0 && gi % GPC == 0 : gi % GPC == GPC - 1)
      ring.release(lane);
  };
  uint32_t a0[KG][NAR][4], a1[KG][NAR][4];
  for (int gi = 0; gi < ngroups; gi += 2) {
    group(a0, gi);
    if (gi + 1 < ngroups) group(Cfg::PIPE ? a1 : a0, gi + 1);
  }
  if constexpr (Cfg::PIPE) {
    if constexpr (NA > 0) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NA; ++i) fence_acc(acc[i]);
    }
    ring.release(lane);
  }
}

// products<CP, CONV1, na> for a count na known only at run time (uniform
// across the warpgroup).
template <int CP, bool CONV1, int NA>
__device__ __forceinline__ void products_for(
    int na, float (&acc)[TC<CP>::MT][TC<CP>::NACC], Ring& ring,
    const uint32_t (&arow)[TC<CP>::MT], int lane, int k, int d) {
  if (na == NA) {
    products<CP, CONV1, NA>(acc, ring, arow, lane, k, d);
  } else if constexpr (NA > 0) {
    products_for<CP, CONV1, NA - 1>(na, acc, ring, arow, lane, k, d);
  }
}

// The producer: one thread walks the stage's chunks in the consumers' order
// (branch, conv, tap, K-half) and copies each into the next free slot.
template <int CP>
__device__ __forceinline__ void produce(const BF* __restrict__ w,
                                        const Plan& plan, Ring ring) {
  using Cfg = TC<CP>;
  const char* wb = reinterpret_cast<const char*>(w);
  int q = 0;
  for (int br = 0; br < plan.nb; ++br)
    for (int n = 0; n < 2 * plan.nd; ++n) {
      const char* src = wb + plan.woff[br][n] * (long long)sizeof(BF);
      const int nchunks = plan.ks[br] * Cfg::NCH;
      for (int i = 0; i < nchunks; ++i, ++q) {
        const uint32_t full = ring.full + 8 * ring.slot;
        if (q >= ring.slots) mbar_wait(ring.empty + 8 * ring.slot, ring.phase ^ 1);
        mbar_expect_tx(full, Cfg::CHUNK);
        bulk_load(ring.base + ring.slot * Cfg::CHUNK,
                  src + (long long)i * Cfg::CHUNK, Cfg::CHUNK, full);
        ring.advance();
      }
    }
}

// One conv over buffer rows [olo, ohi), as conv_rows. Tile i of warpgroup wg
// covers rows olo + 64 (kConsumerWGs i + wg) + [0, 64); warp wl of it rows
// + 16 wl + [0, 16). Rows past ohi repeat row ohi - 1 (their results are
// dropped), so no read leaves the conv's input window. wg is warp-uniform
// (read through a shuffle), so the compiler sees that the dispatch on the
// warpgroup's tile count does not diverge within a warpgroup.
template <int CP, bool CONV1>
__device__ __forceinline__ void conv_tc(
    const BF* __restrict__ in, BF* __restrict__ out,
    float (&acc)[TC<CP>::MT][TC<CP>::NACC], Ring& ring,
    const BF* __restrict__ bg, int wg, int k, int d, int olo, int ohi,
    int g0, int Tlen) {
  using Cfg = TC<CP>;
  constexpr int MT = Cfg::MT, RS = Cfg::RS;
  const int wl = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int ntiles = (ohi - olo + 63) / 64;
  uint32_t arow[MT];
  const uint32_t in_s = smem_u32(in);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r =
        min(olo + 64 * (kConsumerWGs * i + wg) + 16 * wl + (lane & 15), ohi - 1);
    arow[i] = in_s + (uint32_t)(r * RS + (lane >> 4) * 8) * 2;
  }

  products_for<CP, CONV1, MT>(tiles_held(wg, ntiles), acc, ring, arow, lane,
                               k, d);

  // Epilogue on D's (row, column pair) layout, mma.sync's C layout per
  // warp, in bf16x2: the sum rounded once, + bias, then leaky ReLU (conv1)
  // or + residual (conv2), rows outside [0, T) zeroed.
  const int g = lane >> 2, t = lane & 3;
  int rowoff[MT][2];
  uint32_t live = 0, valid = 0;                 // bit 2 i + hh
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = olo + 64 * (kConsumerWGs * i + wg) + 16 * wl + g + 8 * hh;
      const int gt = g0 + row;
      rowoff[i][hh] = row * RS + 2 * t;
      if (kConsumerWGs * i + wg < ntiles && row < ohi) live |= 1u << (2 * i + hh);
      if (gt >= 0 && gt < Tlen) valid |= 1u << (2 * i + hh);
    }
#pragma unroll
  for (int nt = 0; nt < CP / 8; ++nt) {
    const uint32_t b2 = *reinterpret_cast<const uint32_t*>(bg + nt * 8 + 2 * t);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int bit = 2 * i + hh;
        if (!((live >> bit) & 1)) continue;
        uint32_t* o = reinterpret_cast<uint32_t*>(out + rowoff[i][hh] + nt * 8);
        const uint32_t y = add_bf2(
            pack_bf2(acc[i][4 * nt + 2 * hh], acc[i][4 * nt + 2 * hh + 1]), b2);
        const uint32_t v = CONV1 ? lrelu_pair(y) : add_bf2(*o, y);
        *o = ((valid >> bit) & 1) ? v : 0u;
      }
  }
  consumers_sync();
  TK_PHASE(3);
}

// Eight time steps [tb, tb + 8) of channel ch of x (stride 1 along time),
// zero outside [0, Tlen) and past C; one 16-byte load when the group lies
// inside and vec (16-byte aligned rows).
__device__ __forceinline__ uint4 load_time8(const BF* __restrict__ xc, int tb,
                                            int Tlen, bool in_c, bool vec) {
  if (in_c && vec && tb >= 0 && tb + 8 <= Tlen)
    return __ldg(reinterpret_cast<const uint4*>(xc + tb));
  uint4 v;
  BF* e = reinterpret_cast<BF*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = (in_c && tb + i >= 0 && tb + i < Tlen) ? xc[tb + i]
                                                  : __float2bfloat16_rn(0.f);
  return v;
}

// x rows [lo, hi) of the tile into A (rows of RS elements); zeros outside
// [0, T) and past C. Along time (xst == 1): lanes on neighbouring channels,
// each with 8 steps of its channel, so a warp's stores to one row are 64
// contiguous bytes; otherwise one element a thread.
template <int CP>
__device__ void load_x(const BF* __restrict__ xb, BF* __restrict__ A, int lo,
                       int hi, int g0, int Tlen, int C, long long xst,
                       long long xsc, bool vec) {
  constexpr int RS = TC<CP>::RS;
  const int tid = threadIdx.x;
  if (xst == 1) {
    const int gs = g0 + lo, ge = g0 + hi;
    const int m0 = (gs >= 0 ? gs : gs - 7) / 8;   // floor(gs / 8)
    const int ng = (ge + 7 - 8 * m0) / 8;
    const int total = ng * CP;
    for (int base = tid; base < total; base += kXUnroll * kConsumers) {
      uint4 v[kXUnroll];
#pragma unroll
      for (int u = 0; u < kXUnroll; ++u) {
        const int idx = base + u * kConsumers;
        const int ch = idx % CP, tb = 8 * (m0 + idx / CP);
        if (idx < total)
          v[u] = load_time8(xb + ch * xsc, tb, Tlen, ch < C, vec);
      }
#pragma unroll
      for (int u = 0; u < kXUnroll; ++u) {
        const int idx = base + u * kConsumers;
        if (idx >= total) continue;
        const int ch = idx % CP, tb = 8 * (m0 + idx / CP);
        const BF* e = reinterpret_cast<const BF*>(&v[u]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = tb + i - g0;
          if (row >= lo && row < hi) A[row * RS + ch] = e[i];
        }
      }
    }
  } else {
    const int nrows = hi - lo;
    for (int idx = tid; idx < nrows * CP; idx += kConsumers) {
      const int r = idx / CP, ch = idx % CP;
      const int g = g0 + lo + r;
      BF v = __float2bfloat16_rn(0.f);
      if (g >= 0 && g < Tlen && ch < C) v = xb[g * xst + ch * xsc];
      A[(lo + r) * RS + ch] = v;
    }
  }
}

// Branch mean, accumulated in y: y = h0; y = y + h1; ...; y = (y + hn) / n,
// over the tile's tt rows (buffer rows hmax + [0, tt)). Along time: 8 steps
// of one channel a lane, one 16-byte load and store when aligned.
template <int CP>
__device__ void branch_mean(const BF* __restrict__ A, BF* __restrict__ yb,
                            int hmax, int t0, int tt, int C, long long yst,
                            long long ysc, bool vec, bool first, bool last,
                            int nb) {
  constexpr int RS = TC<CP>::RS;
  const int tid = threadIdx.x;
  auto mean = [&](float v, float prev) {
    if (!first) v = round_bf(prev + v);
    if (last) v = v / (float)nb;
    return v;
  };
  if (yst == 1) {
    const int ng = (tt + 7) / 8;
    for (int idx = tid; idx < ng * C; idx += kConsumers) {
      const int ch = idx % C, r0 = 8 * (idx / C);
      BF* dst = yb + (long long)(t0 + r0) + ch * ysc;
      if (vec && r0 + 8 <= tt) {
        uint4 prev = make_uint4(0, 0, 0, 0), outv;
        if (!first) prev = *reinterpret_cast<const uint4*>(dst);
        const BF* pe = reinterpret_cast<const BF*>(&prev);
        BF* oe = reinterpret_cast<BF*>(&outv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          oe[i] = __float2bfloat16_rn(mean(
              __bfloat162float(A[(hmax + r0 + i) * RS + ch]),
              __bfloat162float(pe[i])));
        *reinterpret_cast<uint4*>(dst) = outv;
      } else {
        for (int i = 0; i < 8 && r0 + i < tt; ++i) {
          const float prev = first ? 0.f : __bfloat162float(dst[i]);
          dst[i] = __float2bfloat16_rn(
              mean(__bfloat162float(A[(hmax + r0 + i) * RS + ch]), prev));
        }
      }
    }
  } else {
    for (int idx = tid; idx < tt * C; idx += kConsumers) {
      const int r = idx / C, ch = idx % C;
      BF* dst = yb + (t0 + r) * yst + ch * ysc;
      const float prev = first ? 0.f : __bfloat162float(*dst);
      *dst = __float2bfloat16_rn(
          mean(__bfloat162float(A[(hmax + r) * RS + ch]), prev));
    }
  }
}

template <int CP>
__global__ void __launch_bounds__(kThreadsTC, 1)
mrf_stage_tc(const BF* __restrict__ x, BF* __restrict__ y,
             const BF* __restrict__ w, const BF* __restrict__ bias, Plan plan,
             int Tlen, int C, int TT, int slots, long long xsb, long long xst,
             long long xsc, long long ysb, long long yst, long long ysc) {
  using Cfg = TC<CP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (kRingAlign - raw % kRingAlign) % kRingAlign;
  Ring ring;
  ring.base = raw + pad;
  ring.full = ring.base + slots * Cfg::CHUNK;
  ring.empty = ring.full + 8 * slots;
  ring.slots = slots;
  ring.slot = 0;
  ring.rslot = 0;
  ring.phase = 0;
  BF* A = reinterpret_cast<BF*>(smem_raw + pad + slots * (Cfg::CHUNK + 16));
  BF* Bf = A + (size_t)(TT + 2 * plan.hmax) * Cfg::RS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kConsumers / 32);   // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kConsumerWGs) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) produce<CP>(w, plan, ring);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  TK_PHASE_START();

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int g0 = t0 - plan.hmax;   // time step of buffer row 0
  const BF* xb = x + b * xsb;
  BF* yb = y + b * ysb;
  const bool xvec = xsc % 8 == 0 && xsb % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool yvec = TT % 8 == 0 && ysc % 8 == 0 && ysb % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  float acc[Cfg::MT][Cfg::NACC];

  for (int br = 0; br < plan.nb; ++br) {
    const int k = plan.ks[br];
    const int c = (k - 1) / 2;
    int lo = plan.hmax - plan.halo[br];
    int hi = plan.hmax + TT + plan.halo[br];
    load_x<CP>(xb, A, lo, hi, g0, Tlen, C, xst, xsc, xvec);
    consumers_sync();
    TK_PHASE(0);

    for (int p = 0; p < plan.nd; ++p) {
      const int d = plan.dil[p];
      const int n1 = br * 2 * plan.nd + 2 * p;
      conv_tc<CP, true>(A, Bf, acc, ring, bias + (size_t)n1 * CP, wg, k, d,
                        lo + c * d, hi - c * d, g0, Tlen);
      lo += c * d;
      hi -= c * d;
      conv_tc<CP, false>(Bf, A, acc, ring, bias + (size_t)(n1 + 1) * CP, wg,
                         k, 1, lo + c, hi - c, g0, Tlen);
      lo += c;
      hi -= c;
    }

    branch_mean<CP>(A, yb, plan.hmax, t0, min(TT, Tlen - t0), C, yst, ysc,
                    yvec, br == 0, br == plan.nb - 1, plan.nb);
    consumers_sync();
    TK_PHASE(4);
  }
  TK_PHASE_END();
}

// ---------------------------------------- f32: 3xTF32 mma.sync, a pass per pair

constexpr int kF32KC = 16;                    // input channels per tap chunk
constexpr int kF32Row = kF32KC + 4;           // floats per chunk row
constexpr int kF32Warps = 8;                  // consumer warps
constexpr int kF32Consumers = 32 * kF32Warps;
constexpr int kThreadsF32 = kF32Consumers + 32;   // + the producer warp
constexpr int kF32MT = 2;                     // m16 tiles a warp holds

template <int CP> struct F32 {
  static constexpr int WN = CP == 128 ? 2 : 1;   // warps across the channels
  static constexpr int WM = kF32Warps / WN;      // warps across the rows
  static constexpr int NT = CP / 8 / WN;         // n8 tiles a warp holds
  static constexpr int RS = CP + 4;              // floats between rows
  static constexpr int NCH = CP / kF32KC;        // chunks per tap
  static constexpr int CHUNK = CP * kF32Row * 4; // bytes per chunk
};

// The ring (a chunk and two mbarriers a slot), then the input rows (TT + 2
// rmax) and conv1's rows (TT + 2 cmax). mrf.py's _smem_f32 is the same sum.
__host__ __device__ inline long long smem_bytes_f32(int Cp, int TT, int rmax,
                                                    int cmax, int slots) {
  return (long long)slots * (Cp * kF32Row * 4 + 16) +
         (2LL * TT + 2 * rmax + 2 * cmax) * (Cp + 4) * 4;
}

// d = a * b on mma.sync.m16n8k8.tf32 with a zero accumulator in.
__device__ __forceinline__ void mma_tf32_zero(float d[4], const uint32_t a[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ void f32_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kF32Consumers) : "memory");
}

// The producer: one thread copies a pass's chunks, conv1's k taps then
// conv2's, each tap's chunks in K order, into the ring.
template <int CP>
__device__ __forceinline__ void produce_f32(const float* __restrict__ w1,
                                            const float* __restrict__ w2,
                                            int k, Ring ring) {
  constexpr int CHUNK = F32<CP>::CHUNK;
  const int n = k * F32<CP>::NCH;
  for (int q = 0; q < 2 * n; ++q) {
    const char* src = reinterpret_cast<const char*>(q < n ? w1 : w2) +
                      (long long)(q % n) * CHUNK;
    const uint32_t full = ring.full + 8 * ring.slot;
    if (q >= ring.slots) mbar_wait(ring.empty + 8 * ring.slot, ring.phase ^ 1);
    mbar_expect_tx(full, CHUNK);
    bulk_load(ring.base + ring.slot * CHUNK, src, CHUNK, full);
    ring.advance();
  }
}

// Rows [g0, g0 + nrows) of one item's h (strides st, sc; channels [0, cin)
// readable) into A (rows of RS floats, CP channels); zeros outside [0, T)
// and past cin. Channel-contiguous rows of CP floats (the scratch buffers)
// go by 16-byte loads; a (C, T) view along time, lanes on neighbouring
// steps.
template <int CP>
__device__ void load_rows_f32(const float* __restrict__ h,
                              float* __restrict__ A, int g0, int nrows,
                              int Tlen, int cin, long long st, long long sc) {
  constexpr int RS = F32<CP>::RS;
  const int tid = threadIdx.x;
  if (sc == 1 && cin == CP && st % 4 == 0 &&
      reinterpret_cast<uintptr_t>(h) % 16 == 0) {
    constexpr int V = CP / 4;
    for (int idx = tid; idx < nrows * V; idx += kF32Consumers) {
      const int r = idx / V, q = idx % V, g = g0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g >= 0 && g < Tlen)
        v = __ldg(reinterpret_cast<const float4*>(h + g * st) + q);
      *reinterpret_cast<float4*>(A + r * RS + 4 * q) = v;
    }
  } else {
    for (int idx = tid; idx < nrows * CP; idx += kF32Consumers) {
      int r, ch;
      if (st == 1) { r = idx % nrows; ch = idx / nrows; }
      else { r = idx / CP; ch = idx % CP; }
      const int g = g0 + r;
      float v = 0.f;
      if (g >= 0 && g < Tlen && ch < cin) v = h[g * st + ch * sc];
      A[r * RS + ch] = v;
    }
  }
}

// One conv's products over output rows [0, m) of a window: out[i] = sum_j
// in[i + j d] . W_j, every 16-channel chunk of every tap from the ring in
// turn. Warp (wm, wn) holds the window's m16 tiles wm, wm + WM, ... (na <=
// kF32MT of them) for output channels wn * NT * 8 + [0, NT * 8). Rows past
// m repeat row m - 1 (their results are dropped), so no read leaves the
// input window. Each k8 step: A fragments by ldmatrix.x4 (conv1's leaky
// ReLU applied) and split; then per pair of n8 tiles one ldmatrix.x4 of B,
// split, and the three passes of 3xTF32 on the pair (holding one pair's B
// keeps the fold below within 168 registers). A chunk's products go into
// partial sums that start from zero and are added to the conv's sums on
// the CUDA cores (rounded to nearest): the tensor core's f32 accumulation
// does not round to nearest, and summed in one accumulator over a whole
// conv (3 x 176 mma at k = 11, C = 128) its error grew with C, to 14 times
// this fold's at C = 128 (PERF.md, section 6).
template <int CP, bool CONV1>
__device__ __forceinline__ void products_f32(
    float (&acc)[kF32MT][F32<CP>::NT][4], Ring& ring,
    const float* __restrict__ in, int m, int k, int d, int wm, int wn,
    int lane) {
  using Cfg = F32<CP>;
  constexpr int NT = Cfg::NT, RS = Cfg::RS;
  const int ntiles = (m + 15) / 16;
  const int na = ntiles > wm ? (ntiles - wm + Cfg::WM - 1) / Cfg::WM : 0;
#pragma unroll
  for (int i = 0; i < kF32MT; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
  uint32_t arow[kF32MT];
  const uint32_t in_s = smem_u32(in);
#pragma unroll
  for (int i = 0; i < kF32MT; ++i) {
    const int r = min(16 * (wm + Cfg::WM * i) + (lane & 15), m - 1);
    arow[i] = in_s + (uint32_t)(r * RS + (lane >> 4) * 4) * 4;
  }
  const uint32_t brow =
      (uint32_t)((wn * NT * 8 + (lane & 7) + ((lane >> 4) << 3)) * kF32Row +
                 ((lane >> 3) & 1) * 4) * 4;
  float part[kF32MT][NT][4];   // the chunk's products, from zero
  for (int j = 0; j < k; ++j) {
    const uint32_t shift = (uint32_t)(j * d * RS * 4);
    for (int h = 0; h < Cfg::NCH; ++h) {
      mbar_wait(ring.full + 8 * ring.slot, ring.phase);
      TK_PHASE(1);
      const uint32_t chunk = ring.base + ring.slot * Cfg::CHUNK + brow;
      ring.advance();
#pragma unroll
      for (int s = 0; s < kF32KC / 8; ++s) {
        tk_attn::FragA a[kF32MT];
#pragma unroll
        for (int i = 0; i < kF32MT; ++i) {
          if (i < na) {
            uint32_t r[4];
            ldmatrix_x4(r, arow[i] + shift + (uint32_t)((h * kF32KC + s * 8) * 4));
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              v[e] = __uint_as_float(r[e]);
              if (CONV1) v[e] = v[e] >= 0.f ? v[e] : v[e] * kSlope;
            }
            a[i] = tk_attn::split_a(v[0], v[1], v[2], v[3]);
          }
        }
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4(r, chunk + (uint32_t)((p * 16 * kF32Row + s * 8) * 4));
          const tk_attn::FragB b[2] = {
              {tk_attn::split(r[0]), tk_attn::split(r[1])},
              {tk_attn::split(r[2]), tk_attn::split(r[3])}};
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int i = 0; i < kF32MT; ++i)
              if (i < na) {
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  if (s == 0 && pass == 0)
                    mma_tf32_zero(part[i][2 * p + q], a[i].lo, b[q].b0.hi,
                                  b[q].b1.hi);
                  else
                    tk_attn::mma_pass(pass, part[i][2 * p + q], a[i], b[q]);
                }
              }
        }
      }
#pragma unroll
      for (int i = 0; i < kF32MT; ++i)
        if (i < na) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][nt][e] += part[i][nt][e];
        }
      __syncwarp();
      ring.release(lane);
      TK_PHASE(2);
    }
  }
}

// One pass of dilation pair p: a block per (tile of TT steps, branch, batch
// item), blockIdx.y = (nb - 1 - branch) * B + item. in: the branch's h
// (x for the first pass: stride isbr 0 between branches); out: the scratch
// buffer of h + conv2, [branch][item][t][CP]. Buffer A holds times
// t0 - r + [0, TT + 2r) of h, B conv1's times t0 - c + [0, TT + 2c).
// Two blocks an SM at Cp <= 32, where a block's buffers take at most half
// the shared memory (f32_plan's tiles at Cp = 32 need under 100 KB).
template <int CP>
__global__ void __launch_bounds__(kThreadsF32, CP <= 32 ? 2 : 1)
mrf_pass_f32(const float* __restrict__ in, float* __restrict__ out,
             const float* __restrict__ w, const float* __restrict__ bias,
             Plan plan, int p, int B, int Tlen, int cin, int TT, int slots,
             long long isbr, long long isb, long long ist, long long isc) {
  using Cfg = F32<CP>;
  constexpr int NT = Cfg::NT, RS = Cfg::RS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ring ring;
  ring.base = smem_u32(smem_raw);
  ring.full = ring.base + slots * Cfg::CHUNK;
  ring.empty = ring.full + 8 * slots;
  ring.slots = slots;
  ring.slot = 0;
  ring.rslot = 0;
  ring.phase = 0;
  float* A = reinterpret_cast<float*>(smem_raw + slots * (Cfg::CHUNK + 16));
  float* Bm = A + (size_t)(TT + 2 * plan.rmax) * RS;

  const int br = plan.nb - 1 - (int)blockIdx.y / B;   // widest branch first
  const int b = blockIdx.y % B;
  const int t0 = blockIdx.x * TT;
  const int k = plan.ks[br], c = (k - 1) / 2, d = plan.dil[p];
  const int r = c * (d + 1);
  const int m1 = TT + 2 * c;
  const int n1 = br * 2 * plan.nd + 2 * p;   // conv1's index; conv2's n1 + 1

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kF32Warps);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (warp == kF32Warps) {
    if (lane == 0)
      produce_f32<CP>(w + plan.woff[br][2 * p], w + plan.woff[br][2 * p + 1],
                      k, ring);
    return;
  }
  TK_PHASE_START();
  const int wm = warp % Cfg::WM, wn = warp / Cfg::WM;
  const int g = lane >> 2, t = lane & 3;
  const int nbase = wn * NT * 8 + 2 * t;

  load_rows_f32<CP>(in + br * isbr + b * isb, A, t0 - r, TT + 2 * r, Tlen,
                    cin, ist, isc);
  f32_consumers_sync();
  TK_PHASE(0);

  float acc[kF32MT][NT][4];
  // conv1: Bm[i] = mask(lrelu(conv(lrelu(A))[i] + bias)), time t0 - c + i
  products_f32<CP, true>(acc, ring, A, m1, k, d, wm, wn, lane);
  {
    const float* bg = bias + (size_t)n1 * CP + nbase;
#pragma unroll
    for (int i = 0; i < kF32MT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * (wm + Cfg::WM * i) + g + 8 * hh;
        if (row >= m1) continue;
        const int gt = t0 - c + row;
        const bool valid = gt >= 0 && gt < Tlen;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(bg + nt * 8));
          float v0 = acc[i][nt][2 * hh] + bv.x, v1 = acc[i][nt][2 * hh + 1] + bv.y;
          v0 = v0 >= 0.f ? v0 : v0 * kSlope;
          v1 = v1 >= 0.f ? v1 : v1 * kSlope;
          *reinterpret_cast<float2*>(Bm + row * RS + nbase + nt * 8) =
              valid ? make_float2(v0, v1) : make_float2(0.f, 0.f);
        }
      }
  }
  f32_consumers_sync();
  TK_PHASE(3);

  // conv2: out[t0 + i] = A[i + r] + (conv(Bm)[i] + bias), on [0, T) only
  products_f32<CP, false>(acc, ring, Bm, TT, k, 1, wm, wn, lane);
  {
    const float* bg = bias + (size_t)(n1 + 1) * CP + nbase;
    float* ob = out + ((size_t)br * B + b) * Tlen * CP + nbase;
#pragma unroll
    for (int i = 0; i < kF32MT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * (wm + Cfg::WM * i) + g + 8 * hh;
        if (row >= TT || t0 + row >= Tlen) continue;
        const float* res = A + (row + r) * RS + nbase;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(bg + nt * 8));
          const float2 hv = *reinterpret_cast<const float2*>(res + nt * 8);
          *reinterpret_cast<float2*>(ob + (size_t)(t0 + row) * CP + nt * 8) =
              make_float2(hv.x + (acc[i][nt][2 * hh] + bv.x),
                          hv.y + (acc[i][nt][2 * hh + 1] + bv.y));
        }
      }
  }
  TK_PHASE(4);
  TK_PHASE_END();
}

// The branch mean: y = ((h0 + h1) + h2) / nb over the last pass's buffers
// s ([branch][item][t][CP]), a 32 x 32 (time, channel) tile a block, read
// along channels and written along y's contiguous axis.
__global__ void __launch_bounds__(256)
mrf_mean_f32(const float* __restrict__ s, float* __restrict__ y, int nb,
             int B, int Tlen, int C, int CP, long long ysb, long long yst,
             long long ysc) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, t0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const long long plane = (long long)B * Tlen * CP;   // one branch's h
  for (int i = ty; i < 32; i += 8) {
    const int t = t0 + i, ch = c0 + tx;
    if (t < Tlen && ch < C) {
      const float* q = s + ((long long)b * Tlen + t) * CP + ch;
      float v = q[0];
      for (int br = 1; br < nb; ++br) v = v + q[br * plane];
      tile[i][tx] = v / (float)nb;
    }
  }
  __syncthreads();
  const bool along_t = yst == 1;
  for (int i = ty; i < 32; i += 8) {
    const int t = t0 + (along_t ? tx : i), ch = c0 + (along_t ? i : tx);
    if (t < Tlen && ch < C)
      y[b * ysb + t * yst + ch * ysc] = along_t ? tile[tx][i] : tile[i][tx];
  }
}

// The widest row window a conv of the plan writes.
int widest_window(const Plan& plan, int TT) {
  int widest = 0;
  for (int br = 0; br < plan.nb; ++br) {
    const int c = (plan.ks[br] - 1) / 2;
    int lo = plan.hmax - plan.halo[br], hi = plan.hmax + TT + plan.halo[br];
    for (int p = 0; p < plan.nd; ++p) {
      const int reach[2] = {c * plan.dil[p], c};
      for (int i = 0; i < 2; ++i) {
        lo += reach[i];
        hi -= reach[i];
        widest = hi - lo > widest ? hi - lo : widest;
      }
    }
  }
  return widest;
}

template <int CP>
cudaError_t launch_tc(const void* x, void* y, const void* w, const void* bias,
                      const Plan& plan, int B, int Tlen, int C, int TT,
                      int slots, long long xsb, long long xst, long long xsc,
                      long long ysb, long long yst, long long ysc,
                      cudaStream_t stream) {
  // At least half an SM's shared memory, so one block runs per SM: its
  // consumers take the registers its producer frees (setmaxnreg), which a
  // second block on the SM would hold while waiting for its own.
  const long long need = smem_bytes_tc(CP, TT, plan.hmax, slots);
  const long long smem = need > kSmemLimit / 2 ? need : kSmemLimit / 2;
  if (slots < 1 || smem > kSmemLimit ||
      widest_window(plan, TT) > 64 * kConsumerWGs * TC<CP>::MT)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mrf_stage_tc<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tlen + TT - 1) / TT, B);
  mrf_stage_tc<CP><<<grid, kThreadsTC, smem, stream>>>(
      static_cast<const BF*>(x), static_cast<BF*>(y),
      static_cast<const BF*>(w), static_cast<const BF*>(bias), plan, Tlen, C,
      TT, slots, xsb, xst, xsc, ysb, yst, ysc);
  return cudaGetLastError();
}

template <int CP>
cudaError_t launch_f32(const void* x, void* y, const void* w, const void* bias,
                       float* scratch, const Plan& plan, int B, int Tlen,
                       int C, int TT, int slots, long long xsb, long long xst,
                       long long xsc, long long ysb, long long yst,
                       long long ysc, cudaStream_t stream) {
  const long long smem = smem_bytes_f32(CP, TT, plan.rmax, plan.cmax, slots);
  if (slots < 1 || smem > kSmemLimit || TT % 16 != 0 ||
      TT + 2 * plan.cmax > 16 * F32<CP>::WM * kF32MT ||
      (long long)B * plan.nb > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mrf_pass_f32<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long plane = (long long)B * Tlen * CP;
  float* bufs[2] = {scratch, scratch + plan.nb * plane};
  const dim3 grid((Tlen + TT - 1) / TT, B * plan.nb);
  for (int p = 0; p < plan.nd; ++p) {
    const bool first = p == 0;
    mrf_pass_f32<CP><<<grid, kThreadsF32, smem, stream>>>(
        first ? static_cast<const float*>(x) : bufs[(p + 1) % 2], bufs[p % 2],
        static_cast<const float*>(w), static_cast<const float*>(bias), plan,
        p, B, Tlen, first ? C : CP, TT, slots, first ? 0 : plane,
        first ? xsb : (long long)Tlen * CP, first ? xst : CP,
        first ? xsc : 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 mgrid((Tlen + 31) / 32, (C + 31) / 32, B);
  mrf_mean_f32<<<mgrid, 256, 0, stream>>>(bufs[(plan.nd - 1) % 2],
                                          static_cast<float*>(y), plan.nb, B,
                                          Tlen, C, CP, ysb, yst, ysc);
  return cudaGetLastError();
}

}  // namespace

namespace {

// The stage's Plan from the wrapper's arguments; false if they are out of
// range. A packed tap holds tap_elems elements (mrf.py's tap_elems).
bool make_plan(Plan& plan, int B, int Tlen, int C, int Cp, int TT, int nb,
               const int* ks, int nd, const int* dil, long long tap_elems) {
  if (nb < 1 || nb > kMaxBranch || nd < 1 || nd > kMaxDil || C < 1 ||
      C > kMaxC || Cp < C || !(Cp == 16 || Cp == 32 || Cp == 64 || Cp == 128) ||
      TT < 1 || Tlen < 1 || B < 1)
    return false;
  plan = Plan{};
  plan.nb = nb;
  plan.nd = nd;
  int dmax = 0;
  for (int p = 0; p < nd; ++p) {
    if (dil[p] < 1) return false;
    plan.dil[p] = dil[p];
    dmax = dil[p] > dmax ? dil[p] : dmax;
  }
  long long off = 0;
  for (int br = 0; br < nb; ++br) {
    if (ks[br] < 1 || ks[br] % 2 == 0) return false;
    plan.ks[br] = ks[br];
    const int c = (ks[br] - 1) / 2;
    int halo = 0;
    for (int p = 0; p < nd; ++p) {
      halo += c * dil[p] + c;
      plan.woff[br][2 * p] = off;
      off += ks[br] * tap_elems;
      plan.woff[br][2 * p + 1] = off;
      off += ks[br] * tap_elems;
    }
    plan.halo[br] = halo;
    plan.hmax = halo > plan.hmax ? halo : plan.hmax;
    plan.cmax = c > plan.cmax ? c : plan.cmax;
  }
  plan.rmax = plan.cmax * (dmax + 1);
  return true;
}

}  // namespace

// bf16. Returns a cudaError_t value: 0 on a successful launch. TT and slots
// come from the wrapper's tile_plan; a plan that does not fit is refused.
// is_bf16 must be 1 (f32 goes through tk_mrf_stage_f32); the argument keeps
// the interface of earlier sources, so scripts/probe_mrf_int8.py can time
// one against another without an adapter.
extern "C" int tk_mrf_stage(const void* x, void* y, const void* w,
                            const void* bias, int is_bf16, int B, int Tlen,
                            int C, int Cp, int TT, int slots, int nb,
                            const int* ks, int nd, const int* dil,
                            long long xsb, long long xst, long long xsc,
                            long long ysb, long long yst, long long ysc,
                            void* stream) {
  Plan plan;
  if (!is_bf16 || !make_plan(plan, B, Tlen, C, Cp, TT, nb, ks, nd, dil,
                             (long long)Cp * Cp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Cp == 16)
    err = launch_tc<16>(x, y, w, bias, plan, B, Tlen, C, TT, slots, xsb, xst,
                        xsc, ysb, yst, ysc, s);
  else if (Cp == 32)
    err = launch_tc<32>(x, y, w, bias, plan, B, Tlen, C, TT, slots, xsb, xst,
                        xsc, ysb, yst, ysc, s);
  else if (Cp == 64)
    err = launch_tc<64>(x, y, w, bias, plan, B, Tlen, C, TT, slots, xsb, xst,
                        xsc, ysb, yst, ysc, s);
  else
    err = launch_tc<128>(x, y, w, bias, plan, B, Tlen, C, TT, slots, xsb,
                         xst, xsc, ysb, yst, ysc, s);
  return (int)err;
}

// f32: the passes and the branch mean, launched in order on the stream.
// scratch holds 2 * nb * B * Tlen * Cp floats (two buffers of each branch's
// h). TT and slots come from the wrapper's tile_plan (an F32Plan); a plan
// that does not fit is refused. Returns a cudaError_t value.
extern "C" int tk_mrf_stage_f32(const void* x, void* y, const void* w,
                                const void* bias, void* scratch, int B,
                                int Tlen, int C, int Cp, int TT, int slots,
                                int nb, const int* ks, int nd, const int* dil,
                                long long xsb, long long xst, long long xsc,
                                long long ysb, long long yst, long long ysc,
                                void* stream) {
  Plan plan;
  if (!make_plan(plan, B, Tlen, C, Cp, TT, nb, ks, nd, dil,
                 (long long)Cp / kF32KC * Cp * kF32Row))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err;
  if (Cp == 16)
    err = launch_f32<16>(x, y, w, bias, sc, plan, B, Tlen, C, TT, slots, xsb,
                         xst, xsc, ysb, yst, ysc, s);
  else if (Cp == 32)
    err = launch_f32<32>(x, y, w, bias, sc, plan, B, Tlen, C, TT, slots, xsb,
                         xst, xsc, ysb, yst, ysc, s);
  else if (Cp == 64)
    err = launch_f32<64>(x, y, w, bias, sc, plan, B, Tlen, C, TT, slots, xsb,
                         xst, xsc, ysb, yst, ysc, s);
  else
    err = launch_f32<128>(x, y, w, bias, sc, plan, B, Tlen, C, TT, slots,
                          xsb, xst, xsc, ysb, yst, ysc, s);
  return (int)err;
}

#ifdef TK_PROFILE_PHASES
// Copies the 5 phase counters to out (host memory) and zeroes them.
extern "C" int tk_mrf_phase_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif

extern "C" const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
