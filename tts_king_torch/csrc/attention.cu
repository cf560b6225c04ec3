// Masked self-attention for the FastSpeech2 FFT blocks, inference only.
//
// Replaces: tts_king_tpu/ops/pallas/attention.py, fused_attention (kernel
// body _attn_kernel). Per (batch, head) it computes
//     softmax(where(key_pad, -1e9, (q * scale) @ k^T)) @ v
// with f32 scores, f32 softmax and f32 accumulation. As in the TPU kernel,
// q is scaled in its own type before the product (scale rounded to that
// type first), and the probabilities are rounded to v's type before P.V.
//
// What bounds it on an H100: at the shipped shapes (H=2, D=128, T<=1000)
// the work is 4*T*T*D operations per (b, h) against 4*T*D elements moved,
// about 250 operations per byte in bf16, so the tensor-core bound and the
// memory bound are of one order. This first kernel does its products on
// the CUDA cores in f32 (no mma/wgmma, no TMA), so it sits well above both
// bounds; it is written to be simple and right.
//
// Design: one block per (b, h, tile of 64 query rows). The block walks the
// keys in tiles of 64 with an online softmax (running row max m and row sum
// l in f32), so T is not bounded by shared memory. Keys past T are skipped
// (probability exactly 0); padded keys score -1e9, not -inf, so a row whose
// keys are all padded stays finite, as in the JAX package. Every query row
// in [0, T) is computed, padded ones included: they stay finite, and the
// caller zeroes them.
//
// Layout: q, k, v are (B, H, T, D) views given by element strides (sb, sh,
// st) with a unit stride over D, so the (B, T, H, D) output of a Linear can
// be passed without a copy. The output has its own strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 16 row groups x 16 column lanes
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e9f;

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

// Round a float to T's precision and keep it as a float.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const uint8_t* __restrict__ mask,
                 T* __restrict__ o, int H, int T_, int D, long long sb,
                 long long sh, long long st, long long osb, long long osh,
                 long long ost, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;  // odd row stride: column reads of K hit distinct banks
  float* Qs = smem;               // kBQ x DP
  float* Ks = Qs + kBQ * DP;      // kBK x DP
  float* Vs = Ks + kBK * DP;      // kBK x D
  float* Ps = Vs + kBK * D;       // kBQ x (kBK + 1)
  constexpr int PP = kBK + 1;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * sb + h * sh;
  const T* kb = k + b * sb + h * sh;
  const T* vb = v + b * sb + h * sh;
  T* ob = o + b * osb + h * osh;
  const uint8_t* mb = mask + (long long)b * T_;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // score columns tx + 16c, output columns tx + 16n

  // q * scale in q's type, with the scale itself rounded to that type first
  // (the TPU kernel's q * jnp.asarray(scale, q.dtype)).
  const float sc = round_to<T>(scale);
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int t = q0 + r;
    float val = 0.f;
    if (t < T_) val = round_to<T>(to_f<T>(qb[t * st + d]) * sc);
    Qs[r * DP + d] = val;
  }

  float m_i[4], l_i[4], acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = -1e30f;
    l_i[r] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[r][n] = 0.f;
  }

  for (int k0 = 0; k0 < T_; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int t = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (t < T_) {
        kv = to_f<T>(kb[t * st + d]);
        vv = to_f<T>(vb[t * st + d]);
      }
      Ks[j * DP + d] = kv;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = Qs[(ty * 4 + r) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kk[c] = Ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], kk[c], s[r][c]);
    }

    // Keys past T take no part (p = 0); padded keys score -1e9.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = k0 + tx + 16 * c;
      const bool out = t >= T_;
      const bool padded = !out && mb[t];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (out) s[r][c] = __int_as_float(0xff800000);  // -inf
        else if (padded) s[r][c] = kNegInf;
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // mx is finite: key k0 < T lies in this tile.
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = expf(m_i[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        sum += p;
        // probabilities enter P.V in v's type, as in the TPU kernel
        Ps[(ty * 4 + r) * PP + tx + 16 * c] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[r] = l_i[r] * alpha + sum;
      m_i[r] = m_new;
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[r][n] *= alpha;
    }
    __syncthreads();

    const int kn = min(kBK, T_ - k0);
    for (int j = 0; j < kn; ++j) {
      float pv[4], vv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty * 4 + r) * PP + j];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = tx + 16 * n;
        vv[n] = d < D ? Vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[r][n] = fmaf(pv[r], vv[n], acc[r][n]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + ty * 4 + r;
    if (t >= T_) continue;
    const float inv = 1.f / l_i[r];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = tx + 16 * n;
      if (d < D) ob[t * ost + d] = from_f<T>(acc[r][n] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, int B, int H, int T_, int D,
                   long long sb, long long sh, long long st, long long osb,
                   long long osh, long long ost, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                       (size_t)kBK * D + (size_t)kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_ + kBQ - 1) / kBQ, B * H);
  attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), H, T_, D, sb, sh,
      st, osb, osh, ost, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch.
extern "C" int tk_attention(const void* q, const void* k, const void* v,
                            const uint8_t* mask, void* o, int is_bf16, int B,
                            int H, int T_, int D, long long sb, long long sh,
                            long long st, long long osb, long long osh,
                            long long ost, float scale, void* stream) {
  if (D < 1 || D > kMaxD || T_ < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, mask, o, B, H, T_, D, sb, sh,
                                      st, osb, osh, ost, scale, s)
              : launch<float>(q, k, v, mask, o, B, H, T_, D, sb, sh, st, osb,
                              osh, ost, scale, s);
  return (int)err;
}

extern "C" const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
