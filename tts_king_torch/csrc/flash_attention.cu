// Flash attention with a key-padding mask, forward and backward, f32, for
// the FastSpeech2 FFT blocks in training.
//
// Replaces: tts_king_tpu/ops/pallas/attention.py, flash_attention_padmask,
// which wraps the stock Pallas TPU flash kernel (jax/experimental/pallas/
// ops/tpu/flash_attention.py: the forward pallas_call and the two backward
// ones, dK/dV and dQ). Per (batch, head) it computes
//     S = (q @ k^T) * scale,  S[:, j] = -1e9 where key j is padded,
//     P = softmax(S),  O = P @ v,  lse = logsumexp(S)  (per query row)
// and the gradients dQ, dK, dV of O, recomputing P from q, k and lse:
//     Delta_i = rowsum(dO_i * O_i),  dP = dO @ v^T,  dS = P * (dP - Delta),
//     dV = P^T @ dO,  dK = dS^T @ q * scale,  dQ = dS @ k * scale.
// Padded keys take P = exp(-1e9 - lse) = 0 whenever the row has a valid key,
// so dK and dV come out exactly 0 there. Padded query rows attend the valid
// keys like any other row (finite output); the caller zeroes them, and their
// upstream gradient is then 0. -1e9 is finite, so a row whose keys are all
// padded averages over the row instead of producing inf - inf.
//
// Three kernels, as in the TPU kernel: the forward; dQ, which also computes
// Delta once per query row and writes it out; dK/dV, which reads it. dQ and
// dK/dV each own their output tile, so no atomics are needed.
//
// What bounds it on an H100: at the training shape (B=16, H=2, T=640, D=128)
// the forward does 4*T*T*D operations per (b, h) and the backward 10*T*T*D
// (five products of T*T*D multiply-adds; the forward's two are recomputed in
// the backward's S and dP) against about 6*T*D floats of inputs, so both
// are bound by operations. The products run on the CUDA cores in exact f32
// (the training step is f32, and TF32 would change it), whose data-sheet
// peak is 67 TFLOP/s. This first version uses no mma/wgmma and no TMA: it
// is written to be simple and right, with every tile staged in shared memory.
//
// Design: one block of 256 threads per (b, h, tile of 64 rows); the forward
// and dQ walk the key tiles with the query tile resident, dK/dV walks the
// query tiles with the key tile resident. Within a tile product each thread
// owns a 4x4 patch of the 64x64 score tile (rows ty*4.., columns tx + 16c)
// or a 4x8 patch of a 64x128 output tile (rows ty*4.., columns tx + 16n).
// Shared-memory rows of width D are padded to D + 1 floats, so the column
// reads of the score products fall on distinct banks. Every score product
// sums over d in the same order, so the backward recomputes the forward's S
// bit for bit.
//
// Layout: q, k, v are (B, H, T, D) views given by element strides (sb, sh,
// st) with a unit stride over D, so the (B, T, H, D) output of a Linear is
// passed without a copy; o, dO, dQ, dK and dV share a second set of strides
// (osb, osh, ost); lse and Delta are contiguous (B, H, T).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e9f;
constexpr int PP = kBK + 1;    // row stride of a 64x64 score tile

// S tile: s[r][c] = sum_d A[ty*4+r][d] * B[tx+16c][d], A and B with row
// stride DP in shared memory.
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int D, int DP, int ty, int tx,
                                         float s[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty * 4 + r) * DP + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = Bm[(tx + 16 * c) * DP + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
  }
}

// Copy rows [t0, t0 + 64) of a strided (T, D) matrix into shared memory with
// row stride DP; rows past T are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int t0, int T_,
                                          int D, int DP, int tid) {
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int t = t0 + r;
    dst[r * DP + d] = t < T_ ? src[t * st + d] : 0.f;
  }
}

// The score of query row i against key j, given the raw product s.
__device__ __forceinline__ float masked_score(float s, bool padded,
                                              float scale) {
  return padded ? kNegInf : s * scale;
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ mask, float* __restrict__ o,
                 float* __restrict__ lse, int H, int T_, int D, long long sb,
                 long long sh, long long st, long long osb, long long osh,
                 long long ost, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Qs = smem;            // kBQ x DP
  float* Ks = Qs + kBQ * DP;   // kBK x DP
  float* Vs = Ks + kBK * DP;   // kBK x DP
  float* Ps = Vs + kBK * DP;   // kBQ x PP

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const float* kb = k + b * sb + h * sh;
  const float* vb = v + b * sb + h * sh;
  const uint8_t* mb = mask + (long long)b * T_;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile(Qs, q + b * sb + h * sh, st, q0, T_, D, DP, tid);

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
    load_tile(Ks, kb, st, k0, T_, D, DP, tid);
    load_tile(Vs, vb, st, k0, T_, D, DP, tid);
    __syncthreads();

    float s[4][4];
    tile_dot(Qs, Ks, D, DP, ty, tx, s);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = k0 + tx + 16 * c;
      const bool out = t >= T_;
      const bool padded = !out && mb[t];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s[r][c] = out ? __int_as_float(0xff800000)  // -inf: no part at all
                      : masked_score(s[r][c], padded, scale);
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
        Ps[(ty * 4 + r) * PP + tx + 16 * c] = p;
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
        vv[n] = d < D ? Vs[j * DP + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[r][n] = fmaf(pv[r], vv[n], acc[r][n]);
    }
  }

  float* ob = o + b * osb + h * osh;
  float* lb = lse + (long long)bh * T_;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + ty * 4 + r;
    if (t >= T_) continue;
    const float inv = 1.f / l_i[r];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = tx + 16 * n;
      if (d < D) ob[t * ost + d] = acc[r][n] * inv;
    }
    if (tx == 0) lb[t] = m_i[r] + logf(l_i[r]);
  }
}

// P and dS of one 64x64 tile, from the raw products s = Q.K and dp = dO.V,
// for the thread's 4x4 patch. Rows or keys past T get 0.
__device__ __forceinline__ void tile_p_ds(const float s[4][4],
                                          const float dp[4][4],
                                          const float* Ls, const float* Dls,
                                          const uint8_t* mb, int q0, int k0,
                                          int T_, int ty, int tx, float scale,
                                          float p[4][4], float ds[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int t = k0 + tx + 16 * c;
    const bool key_in = t < T_;
    const bool padded = key_in && mb[t];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      float pv = 0.f;
      if (key_in && q0 + row < T_)
        pv = expf(masked_score(s[r][c], padded, scale) - Ls[row]);
      p[r][c] = pv;
      ds[r][c] = pv * (dp[r][c] - Dls[row]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ o, const float* __restrict__ dO,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int H, int T_, int D, long long sb,
                    long long sh, long long st, long long osb, long long osh,
                    long long ost, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Qs = smem;              // kBQ x DP
  float* dOs = Qs + kBQ * DP;    // kBQ x DP
  float* Ks = dOs + kBQ * DP;    // kBK x DP
  float* Vs = Ks + kBK * DP;     // kBK x DP
  float* dSs = Vs + kBK * DP;    // kBQ x PP
  float* Ls = dSs + kBQ * PP;    // kBQ
  float* Dls = Ls + kBQ;         // kBQ

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const float* kb = k + b * sb + h * sh;
  const float* vb = v + b * sb + h * sh;
  const float* ob = o + b * osb + h * osh;
  const float* dob = dO + b * osb + h * osh;
  const uint8_t* mb = mask + (long long)b * T_;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  load_tile(Qs, q + b * sb + h * sh, st, q0, T_, D, DP, tid);
  load_tile(dOs, dob, ost, q0, T_, D, DP, tid);
  // Delta = rowsum(dO * O), one warp per row; written out for dK/dV.
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int t = q0 + r;
    float acc = 0.f;
    if (t < T_)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(dob[t * ost + d], ob[t * ost + d], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      Dls[r] = acc;
      Ls[r] = t < T_ ? lse[(long long)bh * T_ + t] : 0.f;
      if (t < T_) delta[(long long)bh * T_ + t] = acc;
    }
  }

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[r][n] = 0.f;

  for (int k0 = 0; k0 < T_; k0 += kBK) {
    __syncthreads();
    load_tile(Ks, kb, st, k0, T_, D, DP, tid);
    load_tile(Vs, vb, st, k0, T_, D, DP, tid);
    __syncthreads();

    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    tile_dot(Qs, Ks, D, DP, ty, tx, s);
    tile_dot(dOs, Vs, D, DP, ty, tx, dp);
    tile_p_ds(s, dp, Ls, Dls, mb, q0, k0, T_, ty, tx, scale, p, ds);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dSs[(ty * 4 + r) * PP + tx + 16 * c] = ds[r][c];
    __syncthreads();

    const int kn = min(kBK, T_ - k0);
    for (int j = 0; j < kn; ++j) {
      float a[4], kk[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = dSs[(ty * 4 + r) * PP + j];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = tx + 16 * n;
        kk[n] = d < D ? Ks[j * DP + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[r][n] = fmaf(a[r], kk[n], acc[r][n]);
    }
  }

  float* dqb = dq + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + ty * 4 + r;
    if (t >= T_) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = tx + 16 * n;
      if (d < D) dqb[t * ost + d] = acc[r][n] * scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int H,
                      int T_, int D, long long sb, long long sh, long long st,
                      long long osb, long long osh, long long ost,
                      float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Ks = smem;              // kBK x DP
  float* Vs = Ks + kBK * DP;     // kBK x DP
  float* Qs = Vs + kBK * DP;     // kBQ x DP
  float* dOs = Qs + kBQ * DP;    // kBQ x DP
  float* Ps = dOs + kBQ * DP;    // kBQ x PP
  float* dSs = Ps + kBQ * PP;    // kBQ x PP
  float* Ls = dSs + kBQ * PP;    // kBQ
  float* Dls = Ls + kBQ;         // kBQ

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kBK;
  const float* qb = q + b * sb + h * sh;
  const float* dob = dO + b * osb + h * osh;
  const uint8_t* mb = mask + (long long)b * T_;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile(Ks, k + b * sb + h * sh, st, k0, T_, D, DP, tid);
  load_tile(Vs, v + b * sb + h * sh, st, k0, T_, D, DP, tid);

  // the thread's key rows ty*4 + i, feature columns tx + 16n
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.f;

  for (int q0 = 0; q0 < T_; q0 += kBQ) {
    __syncthreads();
    load_tile(Qs, qb, st, q0, T_, D, DP, tid);
    load_tile(dOs, dob, ost, q0, T_, D, DP, tid);
    for (int r = tid; r < kBQ; r += kThreads) {
      const int t = q0 + r;
      Ls[r] = t < T_ ? lse[(long long)bh * T_ + t] : 0.f;
      Dls[r] = t < T_ ? delta[(long long)bh * T_ + t] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    tile_dot(Qs, Ks, D, DP, ty, tx, s);
    tile_dot(dOs, Vs, D, DP, ty, tx, dp);
    tile_p_ds(s, dp, Ls, Dls, mb, q0, k0, T_, ty, tx, scale, p, ds);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Ps[(ty * 4 + r) * PP + tx + 16 * c] = p[r][c];
        dSs[(ty * 4 + r) * PP + tx + 16 * c] = ds[r][c];
      }
    __syncthreads();

    const int qn = min(kBQ, T_ - q0);
    for (int r = 0; r < qn; ++r) {
      float pv[4], dsv[4], dov[8], qv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * PP + ty * 4 + i];
        dsv[i] = dSs[r * PP + ty * 4 + i];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = tx + 16 * n;
        dov[n] = d < D ? dOs[r * DP + d] : 0.f;
        qv[n] = d < D ? Qs[r * DP + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          dv_acc[i][n] = fmaf(pv[i], dov[n], dv_acc[i][n]);
          dk_acc[i][n] = fmaf(dsv[i], qv[n], dk_acc[i][n]);
        }
    }
  }

  float* dkb = dk + b * osb + h * osh;
  float* dvb = dv + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= T_) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = tx + 16 * n;
      if (d < D) {
        dkb[t * ost + d] = dk_acc[i][n] * scale;
        dvb[t * ost + d] = dv_acc[i][n];
      }
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int B, int H, int T_, int D) {
  return D < 1 || D > kMaxD || T_ < 1 || B < 1 || H < 1 || B * H > 65535;
}

}  // namespace

// Each entry point returns a cudaError_t value: 0 on a successful launch.

extern "C" int tk_flash_fwd(const float* q, const float* k, const float* v,
                            const uint8_t* mask, float* o, float* lse, int B,
                            int H, int T_, int D, long long sb, long long sh,
                            long long st, long long osb, long long osh,
                            long long ost, float scale, void* stream) {
  if (bad_shape(B, H, T_, D)) return (int)cudaErrorInvalidValue;
  const int DP = D + 1;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + 2 * kBK) * DP +
                                       (size_t)kBQ * PP);
  cudaError_t err = set_smem(flash_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_ + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, mask, o, lse, H, T_, D, sb, sh, st, osb, osh, ost, scale);
  return (int)cudaGetLastError();
}

// delta is (B, H, T) scratch that the dQ kernel fills and dK/dV reads.
extern "C" int tk_flash_bwd(const float* q, const float* k, const float* v,
                            const uint8_t* mask, const float* o,
                            const float* dO, const float* lse, float* delta,
                            float* dq, float* dk, float* dv, int B, int H,
                            int T_, int D, long long sb, long long sh,
                            long long st, long long osb, long long osh,
                            long long ost, float scale, void* stream) {
  if (bad_shape(B, H, T_, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int DP = D + 1;
  const size_t smem_dq = sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) * DP +
                                          (size_t)kBQ * PP + 2 * kBQ);
  const size_t smem_dkdv = sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) * DP +
                                            (size_t)2 * kBQ * PP + 2 * kBQ);
  cudaError_t err = set_smem(flash_bwd_dq_kernel, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = set_smem(flash_bwd_dkdv_kernel, smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_ + kBQ - 1) / kBQ, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, smem_dq, s>>>(
      q, k, v, mask, o, dO, lse, delta, dq, H, T_, D, sb, sh, st, osb, osh,
      ost, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<<<grid, kThreads, smem_dkdv, s>>>(
      q, k, v, mask, dO, lse, delta, dk, dv, H, T_, D, sb, sh, st, osb, osh,
      ost, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
