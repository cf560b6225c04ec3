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
// stage is bound by arithmetic: the bf16 tensor cores (989 TFLOP/s) in
// bf16; in f32 the CUDA cores, since TF32 would change the f32 results.
//
// Both routes: one block per (batch item, tile of TT time steps). All 18
// convs of the stage run on the tile in shared memory, so x is read and y
// written once per branch instead of once per conv. Each branch reads x with
// its own halo (k=11: 60 rows a side, k=7: 36, k=3: 12); every conv shrinks
// the live rows by its reach. Two buffers of (TT + 2 * max halo) rows
// suffice: A holds the residual stream h; conv1 reads lrelu(A) and writes
// lrelu(conv1) into B; conv2 reads B and adds into A in place (each element
// of A is read and then written by one thread). Rows outside [0, T) are
// zeroed after every conv and after every residual add, which reproduces
// per-conv zero padding at the sequence edges, and a tile's halo never reads
// a neighbouring batch item. The tile TT (and in bf16 the ring's slots) come
// from the wrapper's tile_plan (ops/kernels/mrf.py); the entry point checks
// that they fit.
//
// f32 (conv_rows, mrf_stage_f32): taps stream from L2 through shared memory
// in chunks of 32 input channels; each thread owns 8 rows x 8 channels and
// sums on the CUDA cores.
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
// working type. The branch mean is accumulated in y itself (each block owns
// its rows of y).
//
// Layout: x and y are (B, T, C) views given by element strides, so a
// (B, C, T) tensor from nn.ConvTranspose1d can be passed without a copy.
// Weights are packed once by the wrapper: for branch b (branch-major), conv
// n in chain order [convs1_0, convs2_0, convs1_1, ...], a block of k_b taps
// of Cp x Cp elements, [tap][c_in][c_out] in f32 (Cp = C rounded up to 8),
// in bf16 the swizzled K-major B layout (Cp = 16, 32, 64 or 128); zero past
// C. Biases (Cp,) per conv in the same order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBranch = 4;
constexpr int kMaxDil = 4;
constexpr int kMaxC = 128;
constexpr float kSlope = 0.1f;
constexpr long long kSmemLimit = 232448;

#ifdef TK_PROFILE_PHASES
// Phase marks of the bf16 kernel, for scripts/probe_mrf_int8.py --kernel
// bf16 --phases: thread 0 (a consumer) adds the cycles since its previous
// mark to the phase the mark closes: x load, tap wait, products, epilogue,
// branch mean (each with the barrier that ends it).
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
  long long woff[kMaxBranch][2 * kMaxDil];  // element offset of each conv's taps
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

// ---------------------------------------------------------------- f32

constexpr int kThreads = 256;
constexpr int kRM = 8;    // output rows per thread
constexpr int kCN = 8;    // output channels per thread
constexpr int kWCH = 32;  // input channels per shared weight chunk

// Rows are padded by one 32-bit word, so neighbouring rows start in
// neighbouring banks.
__host__ __device__ inline long long smem_bytes_f32(int TT, int hmax, int Cp) {
  return 4LL * ((long long)kWCH * Cp + 2LL * (TT + 2 * hmax) * (Cp + 1));
}

// Eight consecutive floats of shared memory (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// One conv over rows [olo, ohi) of the tile (buffer rows; buffer row 0 is
// time step g0; RS elements between rows). CONV1: out = lrelu(mask(conv(
// lrelu(in)) + bias)). Otherwise (conv2): out = mask(out + mask(conv(in) +
// bias)), in place. A thread owns rows p0 + rg + r * nrg (r < kRM), so the
// row groups of a warp read neighbouring rows, which the padded row stride
// puts in distinct banks, and kCN neighbouring output channels.
template <typename T, bool CONV1>
__device__ void conv_rows(const T* __restrict__ in, T* __restrict__ out,
                          T* __restrict__ wsm, const T* __restrict__ wg,
                          const T* __restrict__ bg, int k, int d, int olo,
                          int ohi, int Cp, int RS, int g0, int Tlen) {
  const int tid = threadIdx.x;
  const int ngc = Cp / kCN;         // channel groups
  const int nrg = kThreads / ngc;   // row groups
  const int cg = tid % ngc;
  const int rg = tid / ngc;
  const bool active = rg < nrg;     // Cp / 8 need not divide 256
  const int rows_per_pass = nrg * kRM;
  const int c = (k - 1) / 2;
  const int co0 = cg * kCN;

  for (int p0 = olo; p0 < ohi; p0 += rows_per_pass) {
    const int r0 = p0 + rg;
    const bool live = active && r0 < ohi;
    float acc[kRM][kCN];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int n = 0; n < kCN; ++n) acc[r][n] = 0.f;

    for (int j = 0; j < k; ++j) {
      const int off = (j - c) * d;
      // rows past ohi repeat the last live row; their results are dropped
      int rowoff[kRM];
#pragma unroll
      for (int r = 0; r < kRM; ++r)
        rowoff[r] = (min(r0 + r * nrg, ohi - 1) + off) * RS;
      for (int ci0 = 0; ci0 < Cp; ci0 += kWCH) {
        const int nci = min(kWCH, Cp - ci0);
        __syncthreads();
        {
          const uint4* src = reinterpret_cast<const uint4*>(
              wg + ((long long)j * Cp + ci0) * Cp);
          uint4* dst = reinterpret_cast<uint4*>(wsm);
          const int nvec = nci * Cp * (int)sizeof(T) / 16;
          for (int e = tid; e < nvec; e += kThreads) dst[e] = src[e];
        }
        __syncthreads();
        if (live) {
          for (int i = 0; i < nci; ++i) {
            float w[kCN];
            load8(wsm + i * Cp + co0, w);
#pragma unroll
            for (int r = 0; r < kRM; ++r) {
              float a = to_f<T>(in[rowoff[r] + ci0 + i]);
              if (CONV1) a = lrelu<T>(a);
#pragma unroll
              for (int n = 0; n < kCN; ++n) acc[r][n] = fmaf(a, w[n], acc[r][n]);
            }
          }
        }
      }
    }

    if (live) {
      float bias[kCN];
#pragma unroll
      for (int n = 0; n < kCN; ++n) bias[n] = to_f<T>(bg[co0 + n]);
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const int row = r0 + r * nrg;
        if (row >= ohi) break;
        const int g = g0 + row;
        const bool valid = g >= 0 && g < Tlen;
        T* o = out + row * RS + co0;
#pragma unroll
        for (int n = 0; n < kCN; ++n) {
          const float y = round_to<T>(round_to<T>(acc[r][n]) + bias[n]);
          if (CONV1) {
            o[n] = from_f<T>(valid ? lrelu<T>(y) : 0.f);
          } else {
            o[n] = from_f<T>(valid ? to_f<T>(o[n]) + y : 0.f);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mrf_stage_f32(const float* __restrict__ x, float* __restrict__ y,
              const float* __restrict__ w, const float* __restrict__ bias,
              Plan plan, int Tlen, int C, int Cp, int TT, long long xsb,
              long long xst, long long xsc, long long ysb, long long yst,
              long long ysc) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = TT + 2 * plan.hmax;
  const int RS = Cp + 1;
  T* wsm = reinterpret_cast<T*>(smem_raw);   // weights, 16-byte aligned rows
  T* A = wsm + kWCH * Cp;
  T* Bf = A + (size_t)R * RS;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int g0 = t0 - plan.hmax;   // time step of buffer row 0
  const T* xb = x + b * xsb;
  T* yb = y + b * ysb;
  const int tid = threadIdx.x;
  const int nconv = 2 * plan.nd;

  for (int br = 0; br < plan.nb; ++br) {
    const int k = plan.ks[br];
    const int c = (k - 1) / 2;
    int lo = plan.hmax - plan.halo[br];
    int hi = plan.hmax + TT + plan.halo[br];

    // x rows [lo, hi) into A; zeros outside [0, T) and past C
    __syncthreads();
    const int nrows = hi - lo;
    for (int idx = tid; idx < nrows * Cp; idx += kThreads) {
      int r, ch;
      if (xst == 1) { r = idx % nrows; ch = idx / nrows; }   // (B, C, T) memory
      else { r = idx / Cp; ch = idx % Cp; }
      const int g = g0 + lo + r;
      float v = 0.f;
      if (g >= 0 && g < Tlen && ch < C) v = to_f<T>(xb[g * xst + ch * xsc]);
      A[(lo + r) * RS + ch] = from_f<T>(v);
    }

    for (int p = 0; p < plan.nd; ++p) {
      const int n1 = 2 * p, n2 = 2 * p + 1;
      const int d = plan.dil[p];
      const int bidx = br * nconv;
      const T* w1 = w + plan.woff[br][n1];
      const T* w2 = w + plan.woff[br][n2];
      const T* b1 = bias + (size_t)(bidx + n1) * Cp;
      const T* b2 = bias + (size_t)(bidx + n2) * Cp;
      conv_rows<T, true>(A, Bf, wsm, w1, b1, k, d, lo + c * d, hi - c * d,
                         Cp, RS, g0, Tlen);
      lo += c * d;
      hi -= c * d;
      conv_rows<T, false>(Bf, A, wsm, w2, b2, k, 1, lo + c, hi - c, Cp, RS,
                          g0, Tlen);
      lo += c;
      hi -= c;
    }
    __syncthreads();

    // branch mean, accumulated in y: y = h0; y = y + h1; ...; y = (y + hn) / n
    const bool first = br == 0, last = br == plan.nb - 1;
    const int tt = min(TT, Tlen - t0);
    for (int idx = tid; idx < tt * C; idx += kThreads) {
      int r, ch;
      if (yst == 1) { r = idx % tt; ch = idx / tt; }
      else { r = idx / C; ch = idx % C; }
      T* dst = yb + (t0 + r) * yst + ch * ysc;
      float v = to_f<T>(A[(plan.hmax + r) * RS + ch]);
      if (!first) v = round_to<T>(to_f<T>(*dst) + v);
      if (last) v = v / (float)plan.nb;
      *dst = from_f<T>(v);
    }
  }
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
    if (!first) v = round_to<BF>(prev + v);
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

cudaError_t launch_f32(const void* x, void* y, const void* w, const void* bias,
                       const Plan& plan, int B, int Tlen, int C, int Cp,
                       int TT, long long xsb, long long xst, long long xsc,
                       long long ysb, long long yst, long long ysc,
                       cudaStream_t stream) {
  const long long smem = smem_bytes_f32(TT, plan.hmax, Cp);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mrf_stage_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tlen + TT - 1) / TT, B);
  mrf_stage_f32<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const float*>(w), static_cast<const float*>(bias), plan,
      Tlen, C, Cp, TT, xsb, xst, xsc, ysb, yst, ysc);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch. TT and (bf16) slots
// come from the wrapper's tile_plan; a plan that does not fit is refused.
extern "C" int tk_mrf_stage(const void* x, void* y, const void* w,
                            const void* bias, int is_bf16, int B, int Tlen,
                            int C, int Cp, int TT, int slots, int nb,
                            const int* ks, int nd, const int* dil,
                            long long xsb, long long xst, long long xsc,
                            long long ysb, long long yst, long long ysc,
                            void* stream) {
  // f32: Cp a multiple of 8; bf16: Cp one of 16, 32, 64, 128
  const bool cp_ok = is_bf16 ? (Cp == 16 || Cp == 32 || Cp == 64 || Cp == 128)
                             : Cp % 8 == 0;
  if (nb < 1 || nb > kMaxBranch || nd < 1 || nd > kMaxDil || C < 1 ||
      C > kMaxC || !cp_ok || Cp < C || Cp > kMaxC || TT < 1 || Tlen < 1 ||
      B < 1)
    return (int)cudaErrorInvalidValue;
  Plan plan = {};
  plan.nb = nb;
  plan.nd = nd;
  for (int p = 0; p < nd; ++p) plan.dil[p] = dil[p];
  long long off = 0;
  for (int br = 0; br < nb; ++br) {
    if (ks[br] < 1 || ks[br] % 2 == 0) return (int)cudaErrorInvalidValue;
    plan.ks[br] = ks[br];
    const int c = (ks[br] - 1) / 2;
    int halo = 0;
    for (int p = 0; p < nd; ++p) {
      halo += c * dil[p] + c;
      plan.woff[br][2 * p] = off;
      off += (long long)ks[br] * Cp * Cp;
      plan.woff[br][2 * p + 1] = off;
      off += (long long)ks[br] * Cp * Cp;
    }
    plan.halo[br] = halo;
    plan.hmax = halo > plan.hmax ? halo : plan.hmax;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!is_bf16)
    err = launch_f32(x, y, w, bias, plan, B, Tlen, C, Cp, TT, xsb, xst, xsc,
                     ysb, yst, ysc, s);
  else if (Cp == 16)
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
