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
// stage is bound by arithmetic. bf16 runs on the tensor cores (mma.sync
// m16n8k16, f32 accumulation; conv_rows_tc); f32 runs on the CUDA cores in
// f32 (conv_rows), since TF32 would change the f32 results. Neither path
// pipelines its loads (no cp.async/TMA, no wgmma): simple and right first.
//
// Design: one block per (batch item, tile of TT time steps). All 18 convs of
// the stage run on the tile in shared memory, so x is read and y written
// once per branch instead of once per conv. Each branch reads x with its own
// halo (k=11: 60 rows a side, k=7: 36, k=3: 12); every conv shrinks the live
// rows by its reach. Two buffers of (TT + 2 * max halo) rows suffice: A holds
// the residual stream h; conv1 reads lrelu(A) and writes lrelu(conv1) into B;
// conv2 reads B and adds into A in place (each element of A is read and then
// written by one thread). Rows outside [0, T) are zeroed after every conv and
// after every residual add, which reproduces per-conv zero padding at the
// sequence edges, and a tile's halo never reads a neighbouring batch item.
// Weights stream from global memory (L2) through shared memory one tap at
// a time: in chunks of 32 input channels on the CUDA-core path, as a whole
// (Cp x Cp) tap on the tensor-core path.
//
// Rounding, as in the TPU kernel and the plain version: f32 accumulation, the
// sum rounded to the working type once, then the bias added in that type; the
// leaky ReLU, the residual add and each step of the branch mean round to the
// working type. The branch mean is accumulated in y itself (each block owns
// its rows of y).
//
// Layout: x and y are (B, T, C) views given by element strides, so a
// (B, C, T) tensor from nn.ConvTranspose1d can be passed without a copy.
// Weights are packed by the wrapper: for branch b (branch-major), conv n in
// chain order [convs1_0, convs2_0, convs1_1, ...], a (k_b, Cp, Cp) block,
// [tap][c_in][c_out] in f32 (Cp = C rounded up to 8) and [tap][c_out][c_in]
// in bf16 (Cp = 16, 32, 64 or 128), zero past C; biases (Cp,) per conv in
// the same order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRM = 8;    // output rows per thread
constexpr int kCN = 8;    // output channels per thread
constexpr int kWCH = 32;  // input channels per shared weight chunk
constexpr int kMaxBranch = 4;
constexpr int kMaxDil = 4;
constexpr int kMaxC = 128;
constexpr float kSlope = 0.1f;

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

// Elements between activation rows: on the CUDA-core path rows are padded
// by one 32-bit word, so neighbouring rows start in neighbouring banks; on
// the tensor-core path by 16 bytes, so the rows of a fragment load do.
__host__ __device__ inline int act_stride(bool tc, int elem_bytes, int Cp) {
  return tc ? Cp + 8 : Cp + 4 / elem_bytes;
}

// Elements of the shared weight buffer: a chunk of kWCH input channels on
// the CUDA-core path, one whole (Cp x Cp) tap, padded rows, on the other.
__host__ __device__ inline long long wsm_elems(bool tc, int Cp) {
  return tc ? (long long)Cp * (Cp + 8) : (long long)kWCH * Cp;
}

__host__ __device__ inline long long smem_bytes(bool tc, int elem_bytes,
                                                int TT, int hmax, int Cp) {
  return (long long)elem_bytes *
         (wsm_elems(tc, Cp) +
          2LL * (TT + 2 * hmax) * act_stride(tc, elem_bytes, Cp));
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

// ---- bf16 on the tensor cores: mma.sync m16n8k16, f32 accumulation ----

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t lrelu_pair(uint32_t v) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  __nv_bfloat162 r = __floats2bfloat162_rn(lrelu<__nv_bfloat16>(f.x),
                                           lrelu<__nv_bfloat16>(f.y));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The same conv as conv_rows, in bf16 with Cp = 8 * NT channels (16..128),
// as a product of (rows x Cp) activations by one (Cp x Cp) tap at a time.
// Each warp owns a 16-row m-tile and all NT n-tiles of 8 output channels;
// the 8 warps of the block cover 128 rows per pass. A tap's weights sit in
// shared memory as [c_out][c_in] rows of WS = Cp + 8 elements, activation
// rows are RS = Cp + 8 elements apart: the 16-byte pad puts the 8 rows a
// fragment load touches in distinct banks. Fragment layouts are those of
// the PTX ISA for mma.m16n8k16 (.row A, .col B, f32 C): lane = 4 * g + t.
template <bool CONV1, int NT>
__device__ void conv_rows_tc(const __nv_bfloat16* __restrict__ in,
                             __nv_bfloat16* __restrict__ out,
                             __nv_bfloat16* __restrict__ wsm,
                             const __nv_bfloat16* __restrict__ wg,
                             const __nv_bfloat16* __restrict__ bg, int k,
                             int d, int olo, int ohi, int RS, int g0,
                             int Tlen) {
  constexpr int Cp = NT * 8;
  constexpr int WS = Cp + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int c = (k - 1) / 2;

  for (int p0 = olo; p0 < ohi; p0 += 16 * (kThreads / 32)) {
    const int r0 = p0 + warp * 16;
    const bool live = r0 < ohi;
    // rows past ohi repeat the last live row; their results are dropped
    const int ra = min(r0 + g, ohi - 1), rb = min(r0 + g + 8, ohi - 1);
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

    for (int j = 0; j < k; ++j) {
      __syncthreads();
      {
        const uint4* src = reinterpret_cast<const uint4*>(wg + (size_t)j * Cp * Cp);
        constexpr int kVec = Cp / 8;   // 16-byte vectors per weight row
        for (int e = threadIdx.x; e < Cp * kVec; e += kThreads)
          *reinterpret_cast<uint4*>(wsm + (e / kVec) * WS + (e % kVec) * 8) =
              src[e];
      }
      __syncthreads();
      if (live) {
        const int off = (j - c) * d;
        const __nv_bfloat16* pa = in + (ra + off) * RS + 2 * t;
        const __nv_bfloat16* pb = in + (rb + off) * RS + 2 * t;
        const __nv_bfloat16* pw = wsm + g * WS + 2 * t;
#pragma unroll 2
        for (int kk = 0; kk < Cp; kk += 16) {
          uint32_t a0 = ld_pair(pa + kk), a1 = ld_pair(pb + kk);
          uint32_t a2 = ld_pair(pa + kk + 8), a3 = ld_pair(pb + kk + 8);
          if (CONV1) {
            a0 = lrelu_pair(a0); a1 = lrelu_pair(a1);
            a2 = lrelu_pair(a2); a3 = lrelu_pair(a3);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const __nv_bfloat16* w = pw + nt * 8 * WS + kk;
            mma_bf16(acc[nt], a0, a1, a2, a3, ld_pair(w), ld_pair(w + 8));
          }
        }
      }
    }

    if (live) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = nt * 8 + 2 * t;
        const float b0 = __bfloat162float(bg[co]);
        const float b1 = __bfloat162float(bg[co + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + g + 8 * h;
          if (row >= ohi) continue;
          const int gt = g0 + row;
          const bool valid = gt >= 0 && gt < Tlen;
          using BF = __nv_bfloat16;
          const float y0 = round_to<BF>(round_to<BF>(acc[nt][2 * h]) + b0);
          const float y1 = round_to<BF>(round_to<BF>(acc[nt][2 * h + 1]) + b1);
          __nv_bfloat162* o =
              reinterpret_cast<__nv_bfloat162*>(out + row * RS + co);
          float v0 = 0.f, v1 = 0.f;
          if (valid) {
            if (CONV1) {
              v0 = lrelu<BF>(y0);
              v1 = lrelu<BF>(y1);
            } else {
              const float2 old = __bfloat1622float2(*o);
              v0 = old.x + y0;
              v1 = old.y + y1;
            }
          }
          *o = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// NT = 0: f32 on the CUDA cores, conv_rows; NT > 0: bf16 on the
// tensor cores with Cp = 8 * NT, conv_rows_tc.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
mrf_stage_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const T* __restrict__ w, const T* __restrict__ bias,
                 Plan plan, int Tlen, int C, int Cp, int TT, long long xsb,
                 long long xst, long long xsc, long long ysb, long long yst,
                 long long ysc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = TT + 2 * plan.hmax;
  const int RS = act_stride(NT > 0, (int)sizeof(T), Cp);
  T* wsm = reinterpret_cast<T*>(smem_raw);   // weights, 16-byte aligned rows
  T* A = wsm + wsm_elems(NT > 0, Cp);
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
      if constexpr (NT > 0) {
        conv_rows_tc<true, NT>(A, Bf, wsm, w1, b1, k, d, lo + c * d,
                               hi - c * d, RS, g0, Tlen);
      } else {
        conv_rows<T, true>(A, Bf, wsm, w1, b1, k, d, lo + c * d, hi - c * d,
                           Cp, RS, g0, Tlen);
      }
      lo += c * d;
      hi -= c * d;
      if constexpr (NT > 0) {
        conv_rows_tc<false, NT>(Bf, A, wsm, w2, b2, k, 1, lo + c, hi - c, RS,
                                g0, Tlen);
      } else {
        conv_rows<T, false>(Bf, A, wsm, w2, b2, k, 1, lo + c, hi - c, Cp, RS,
                            g0, Tlen);
      }
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

template <typename T, int NT>
cudaError_t launch(const void* x, void* y, const void* w, const void* bias,
                   const Plan& plan, int B, int Tlen, int C, int Cp, int TT,
                   long long xsb, long long xst, long long xsc, long long ysb,
                   long long yst, long long ysc, cudaStream_t stream) {
  const size_t smem =
      (size_t)smem_bytes(NT > 0, (int)sizeof(T), TT, plan.hmax, Cp);
  cudaError_t err = cudaFuncSetAttribute(
      mrf_stage_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tlen + TT - 1) / TT, B);
  mrf_stage_kernel<T, NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const T*>(w),
      static_cast<const T*>(bias), plan, Tlen, C, Cp, TT, xsb, xst, xsc, ysb,
      yst, ysc);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs; the wrapper picks TT with
// it. bf16 runs on the tensor cores, f32 on the CUDA cores.
extern "C" long long tk_mrf_smem_bytes(int is_bf16, int TT, int hmax, int Cp) {
  return smem_bytes(is_bf16 != 0, is_bf16 ? 2 : 4, TT, hmax, Cp);
}

// Returns a cudaError_t value: 0 on a successful launch.
extern "C" int tk_mrf_stage(const void* x, void* y, const void* w,
                            const void* bias, int is_bf16, int B, int Tlen,
                            int C, int Cp, int TT, int nb, const int* ks,
                            int nd, const int* dil, long long xsb,
                            long long xst, long long xsc, long long ysb,
                            long long yst, long long ysc, void* stream) {
  // f32: Cp a multiple of 8; bf16: Cp one of 16, 32, 64, 128 (n-tiles)
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
  using BF = __nv_bfloat16;
  cudaError_t err;
  if (!is_bf16)
    err = launch<float, 0>(x, y, w, bias, plan, B, Tlen, C, Cp, TT, xsb, xst,
                           xsc, ysb, yst, ysc, s);
  else if (Cp == 16)
    err = launch<BF, 2>(x, y, w, bias, plan, B, Tlen, C, Cp, TT, xsb, xst,
                        xsc, ysb, yst, ysc, s);
  else if (Cp == 32)
    err = launch<BF, 4>(x, y, w, bias, plan, B, Tlen, C, Cp, TT, xsb, xst,
                        xsc, ysb, yst, ysc, s);
  else if (Cp == 64)
    err = launch<BF, 8>(x, y, w, bias, plan, B, Tlen, C, Cp, TT, xsb, xst,
                        xsc, ysb, yst, ysc, s);
  else
    err = launch<BF, 16>(x, y, w, bias, plan, B, Tlen, C, Cp, TT, xsb, xst,
                         xsc, ysb, yst, ysc, s);
  return (int)err;
}

extern "C" const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
