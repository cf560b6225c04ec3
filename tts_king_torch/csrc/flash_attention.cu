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
// dK/dV each own their output tile, so no atomics are needed and the result
// does not depend on the order the blocks run in.
//
// What bounds it on an H100: at the training shape (B=16, H=2, T=640, D=128)
// the forward does 4*D operations per (query row, valid key) and the
// backward 10*D (five products; the forward's two are recomputed in the
// backward's S and dP) against about 6*T*D floats of inputs per (b, h), so
// both are bound by operations. The training step is exact f32, so the
// products run as 3xTF32 on the tensor cores (three TF32 products per f32
// product, attention_mma.cuh): 3 * ops over 495 TFLOP/s, against 67 TFLOP/s
// for f32 on the CUDA cores.
//
// Design: the forward is attention_mma.cuh's attn_fwd_kernel with S scaled
// in f32 after the product and lse written out. dQ: one block of 4 warps
// per (b, h, 64 query rows), Q and dO resident in shared memory, K/V tiles
// of 32 keys through a two-stage cp.async ring; each warp recomputes S and
// dP for its 16 rows, forms dS in registers and adds dS K with dS as the A
// operand straight from the accumulators. dK/dV: one block per (b, h, 64
// keys), K and V resident, Q/dO tiles of 32 rows (with their lse and Delta)
// through the ring; each warp owns 16 keys and computes the transposed
// tiles S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T are A operands of
// dV += P^T dO and dK += dS^T Q without leaving the registers. S^T sums each
// element's terms in the forward's order (same k-steps, mma_pass<true>); the
// tensor core is not documented to give the transposed product bit for bit,
// and the tolerance of the checks covers it either way. Key tiles that hold
// only padded keys are skipped by the forward and dQ, and a dK/dV block
// whose 64 keys are all padded writes zeros and returns, when the item has
// a valid key; an item with no valid key runs every tile.
//
// bf16-probability mode (ModelConfig.attention_probs_bf16, the JAX
// package's XLA attention with its normalized probabilities stored in bf16;
// tk_flash_fwd_probs_bf16, tk_flash_bwd_probs_bf16): attention_round.cuh's
// kernels, whose forward writes P for the backward.
//
// Layout: q, k, v are (B, H, T, D) views given by element strides (sb, sh,
// st) with a unit stride over D, so the (B, T, H, D) output of a Linear is
// passed without a copy; o, dO, dQ, dK and dV share a second set of strides
// (osb, osh, ost); lse and Delta are contiguous (B, H, T). Rows and (b, h)
// bases start on 16 bytes; D is a multiple of 4, at most 128.

#include "attention_round.cuh"

namespace tk_attn {
namespace {

constexpr int kBwdKeys = 32;   // keys per streamed tile in dQ
constexpr int kBwdRows = 32;   // query rows per streamed tile in dK/dV

template <int DP> __host__ __device__ constexpr size_t dq_tile_bytes() {
  return sizeof(float) *
         ((size_t)(2 * kRows + 4 * kBwdKeys) * ld<float, DP>() + 2 * kRows);
}

// Q, dO, two stages of K and V, the rows' lse and Delta, the mask and the
// tile flags.
template <int DP> size_t dq_smem(int T_) {
  const int n_tiles = (T_ + kBwdKeys - 1) / kBwdKeys;
  return dq_tile_bytes<DP>() + ((T_ + 15) / 16) * 16 + 2 * n_tiles;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ o, const float* __restrict__ dO,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int H, int T_, int D, long long sb,
                    long long sh, long long st, long long osb, long long osh,
                    long long ost, float scale) {
  constexpr int LD = ld<float, DP>();
  constexpr int kNT = kBwdKeys / 8;
  constexpr int kDT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kRows * LD;
  float* KV = dOs + kRows * LD;   // [stage][K, V][kBwdKeys][LD]
  float* Ls = KV + 4 * kBwdKeys * LD;
  float* Dls = Ls + kRows;
  uint8_t* ms = smem + dq_tile_bytes<DP>();
  const int n_tiles = (T_ + kBwdKeys - 1) / kBwdKeys;
  uint8_t* live = ms + ((T_ + 15) / 16) * 16;
  uint8_t* mixed = live + n_tiles;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const float* kb = k + b * sb + h * sh;
  const float* vb = v + b * sb + h * sh;
  const float* ob = o + b * osb + h * osh;
  const float* dob = dO + b * osb + h * osh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  TK_PHASES

  auto load_kv = [&](int j, int stage) {
    float* Ks = KV + 2 * stage * kBwdKeys * LD;
    load_rows<float, kBwdKeys, DP>(Ks, kb, st, j * kBwdKeys, T_, D);
    load_rows<float, kBwdKeys, DP>(Ks + kBwdKeys * LD, vb, st, j * kBwdKeys,
                                   T_, D);
  };
  load_rows<float, kRows, DP>(Qs, q + b * sb + h * sh, st, q0, T_, D);
  load_rows<float, kRows, DP>(dOs, dob, ost, q0, T_, D);
  cp_async_commit();
  load_kv(0, 0);   // the first tile, before the mask says whether it runs
  cp_async_commit();
  const bool skip = scan_mask(mask + (long long)b * T_, T_, kBwdKeys, ms,
                              live, mixed, n_tiles);
  int j = next_tile(-1, skip, live, n_tiles);
  if (j != 0) {   // tile 0 is all padded: load the first tile that runs
    cp_async_wait<0>();
    __syncthreads();
    load_kv(j, 0);
    cp_async_commit();
  }

  // Delta = rowsum(dO * O) while tile j loads: dO from shared memory, O
  // from device memory; a warp's 16 rows, lane l on columns 4l..4l+3, eight
  // rows' loads in flight. Written out for dK/dV.
  cp_async_wait<1>();   // Q and dO have arrived
  __syncthreads();
  {
    const int c = 4 * lane;
    const bool col_in = c < D;
#pragma unroll
    for (int r0 = 0; r0 < 16; r0 += 8) {
      float4 ov[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = q0 + warp * 16 + r0 + u;
        ov[u] = col_in && t < T_
                    ? *reinterpret_cast<const float4*>(ob + t * ost + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int row = warp * 16 + r0 + u, t = q0 + row;
        const float4 dv = *reinterpret_cast<const float4*>(dOs + row * LD +
                                                           (col_in ? c : 0));
        float a = col_in ? dv.x * ov[u].x + dv.y * ov[u].y +
                               dv.z * ov[u].z + dv.w * ov[u].w
                         : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane == 0) {
          Dls[row] = a;
          Ls[row] = t < T_ ? lse[(long long)bh * T_ + t] : 0.f;
          if (t < T_) delta[(long long)bh * T_ + t] = a;
        }
      }
    }
  }
  __syncthreads();   // Ls and Dls are written

  const float* Qw = Qs + warp * 16 * LD;
  const float* dOw = dOs + warp * 16 * LD;
  float l_row[2], d_row[2];
  bool row_in[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    l_row[r] = Ls[row];
    d_row[r] = Dls[row];
    row_in[r] = q0 + row < T_;
  }
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
    cp_async_wait<1>();   // Q, dO and tile j have arrived
    __syncthreads();
    TK_MARK(1);
    const float* Ks = KV + 2 * stage * kBwdKeys * LD;
    const float* Vs = Ks + kBwdKeys * LD;
    const int k0 = j * kBwdKeys;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, Qw + a_off<float>(lane, LD) + kk * 8);
      const FragA aq = split_a(__uint_as_float(af[0]), __uint_as_float(af[1]),
                               __uint_as_float(af[2]), __uint_as_float(af[3]));
      ldsm_x4(af, dOw + a_off<float>(lane, LD) + kk * 8);
      const FragA ado = split_a(__uint_as_float(af[0]),
                                __uint_as_float(af[1]),
                                __uint_as_float(af[2]),
                                __uint_as_float(af[3]));
      FragB bk[kNT], bv[kNT];
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        ldsm_b2(bk[2 * p], bk[2 * p + 1],
                Ks + p * 16 * LD + b_off<float>(lane, LD) + kk * 8);
        ldsm_b2(bv[2 * p], bv[2 * p + 1],
                Vs + p * 16 * LD + b_off<float>(lane, LD) + kk * 8);
      }
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          mma_pass(pass, s[n], aq, bk[n]);
          mma_pass(pass, dp[n], ado, bv[n]);
        }
    }

    TK_MARK(2);
    // P from lse, dS = P (dP - Delta); rows or keys past T get 0
    const bool masked = mixed[j];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t4 + (e & 1);
        const int r = e / 2;
        float p = 0.f;
        if (row_in[r] && (!masked || key < T_)) {
          const float x = masked && ms[key] ? kMasked : s[n][e] * scale;
          p = ex2((x - l_row[r]) * kLog2e);
        }
        s[n][e] = p * (dp[n][e] - d_row[r]);
      }

    TK_MARK(3);
    // dQ += dS K, k = t standing for key 2t and k = t + 4 for key 2t + 1
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      const FragA a = split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const float* k2 = Ks + (kk * 8 + 2 * t4) * LD + g;
      constexpr int kChunk = kDT < 8 ? kDT : 8;
#pragma unroll
      for (int n0 = 0; n0 < kDT; n0 += kChunk) {
        FragB bk[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) bk[c] = lds_b(k2 + (n0 + c) * 8, LD);
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            mma_pass(pass, acc[n0 + c], a, bk[c]);
      }
    }
    TK_MARK(4);
    __syncthreads();   // the stage is free for the load two tiles on
    TK_MARK(5);
    j = jn;
  }
  cp_async_wait<0>();

  float* dqb = dq + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= T_) continue;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int d = n * 8 + 2 * t4;
      if (d < D)
        store2<float>(dqb + t * ost + d, acc[n][2 * r] * scale,
                      acc[n][2 * r + 1] * scale);
    }
  }
  TK_MARK(6);
  TK_PHASES_END();
}

template <int DP> __host__ __device__ constexpr size_t dkdv_smem() {
  return sizeof(float) *
         ((size_t)(2 * kRows + 4 * kBwdRows) * ld<float, DP>() +
          4 * kBwdRows);
}

template <int DP>
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
  constexpr int LD = ld<float, DP>();
  constexpr int kNT = kBwdRows / 8;
  constexpr int kDT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kRows * LD;
  float* ring = Vs + kRows * LD;   // [stage][Q, dO][kBwdRows][LD]
  float* vecs = ring + 4 * kBwdRows * LD;   // [stage][lse, Delta][kBwdRows]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const float* qb = q + b * sb + h * sh;
  const float* dob = dO + b * osb + h * osh;
  const uint8_t* mb = mask + (long long)b * T_;
  float* dkb = dk + b * osb + h * osh;
  float* dvb = dv + b * osb + h * osh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  TK_PHASES

  int mine = 0;   // a valid key in this block's tile
  const bool any = scan_keys(mb, T_, [&](int t, uint8_t m) {
    if (!m && t >= k0 && t < k0 + kRows) mine = 1;
  });
  if (skip_tile(any, __syncthreads_or(mine))) {
    // P is exactly 0 on the tile, so are dK and dV
    for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
      const int t = k0 + i / D, d = i % D;
      if (t < T_) dkb[t * ost + d] = dvb[t * ost + d] = 0.f;
    }
    TK_MARK(15);
    TK_PHASES_END();
    return;
  }

  load_rows<float, kRows, DP>(Ks, k + b * sb + h * sh, st, k0, T_, D);
  load_rows<float, kRows, DP>(Vs, v + b * sb + h * sh, st, k0, T_, D);
  auto load_q = [&](int i, int stage) {
    float* Qs = ring + 2 * stage * kBwdRows * LD;
    float* vs = vecs + 2 * stage * kBwdRows;
    const int t0 = i * kBwdRows;
    load_rows<float, kBwdRows, DP>(Qs, qb, st, t0, T_, D);
    load_rows<float, kBwdRows, DP>(Qs + kBwdRows * LD, dob, ost, t0, T_, D);
    load_vec(vs, lse + (long long)bh * T_, t0, kBwdRows, T_);
    load_vec(vs + kBwdRows, delta + (long long)bh * T_, t0, kBwdRows, T_);
  };
  load_q(0, 0);
  cp_async_commit();

  // the warp's keys warp*16 + g and + 8: padded (keys past T are never
  // written; they are scored as padded)
  bool key_pad[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = k0 + warp * 16 + g + 8 * r;
    key_pad[r] = t >= T_ || mb[t];
  }
  const float* Kw = Ks + warp * 16 * LD;
  const float* Vw = Vs + warp * 16 * LD;
  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int nq = (T_ + kBwdRows - 1) / kBwdRows;
  TK_MARK(8);
  for (int i = 0, stage = 0; i < nq; ++i, stage ^= 1) {
    if (i + 1 < nq) load_q(i + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // K, V and query tile i have arrived
    __syncthreads();
    TK_MARK(9);
    const float* Qs = ring + 2 * stage * kBwdRows * LD;
    const float* dOs = Qs + kBwdRows * LD;
    const float* Lq = vecs + 2 * stage * kBwdRows;
    const float* Dq = Lq + kBwdRows;
    const int t0 = i * kBwdRows;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, Kw + a_off<float>(lane, LD) + kk * 8);
      const FragA ak = split_a(__uint_as_float(af[0]), __uint_as_float(af[1]),
                               __uint_as_float(af[2]), __uint_as_float(af[3]));
      ldsm_x4(af, Vw + a_off<float>(lane, LD) + kk * 8);
      const FragA av = split_a(__uint_as_float(af[0]), __uint_as_float(af[1]),
                               __uint_as_float(af[2]), __uint_as_float(af[3]));
      FragB bq[kNT], bd[kNT];
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        ldsm_b2(bq[2 * p], bq[2 * p + 1],
                Qs + p * 16 * LD + b_off<float>(lane, LD) + kk * 8);
        ldsm_b2(bd[2 * p], bd[2 * p + 1],
                dOs + p * 16 * LD + b_off<float>(lane, LD) + kk * 8);
      }
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          mma_pass<true>(pass, s[n], ak, bq[n]);
          mma_pass<true>(pass, dp[n], av, bd[n]);
        }
    }

    TK_MARK(10);
    // P^T from lse, dS^T = P^T (dP^T - Delta); queries past T get 0
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * t4 + (e & 1);
        float p = 0.f;
        if (t0 + qi < T_) {
          const float x = key_pad[e / 2] ? kMasked : s[n][e] * scale;
          p = ex2((x - Lq[qi]) * kLog2e);
        }
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Dq[qi]);
      }

    TK_MARK(11);
    // dV += P^T dO and dK += dS^T Q, k = t standing for query 2t and k =
    // t + 4 for query 2t + 1
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      const FragA ap = split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const FragA ads = split_a(dp[kk][0], dp[kk][2], dp[kk][1], dp[kk][3]);
      const float* do2 = dOs + (kk * 8 + 2 * t4) * LD + g;
      const float* q2 = Qs + (kk * 8 + 2 * t4) * LD + g;
      constexpr int kChunk = kDT < 4 ? kDT : 4;
#pragma unroll
      for (int n0 = 0; n0 < kDT; n0 += kChunk) {
        FragB bd[kChunk], bq[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          bd[c] = lds_b(do2 + (n0 + c) * 8, LD);
          bq[c] = lds_b(q2 + (n0 + c) * 8, LD);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            mma_pass(pass, dv_acc[n0 + c], ap, bd[c]);
            mma_pass(pass, dk_acc[n0 + c], ads, bq[c]);
          }
      }
    }
    TK_MARK(12);
    __syncthreads();   // the stage is free for the load two tiles on
    TK_MARK(13);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = k0 + warp * 16 + g + 8 * r;
    if (t >= T_) continue;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const int d = n * 8 + 2 * t4;
      if (d < D) {
        store2<float>(dkb + t * ost + d, dk_acc[n][2 * r] * scale,
                      dk_acc[n][2 * r + 1] * scale);
        store2<float>(dvb + t * ost + d, dv_acc[n][2 * r],
                      dv_acc[n][2 * r + 1]);
      }
    }
  }
  TK_MARK(14);
  TK_PHASES_END();
}

template <int DP>
cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                       const uint8_t* mask, const float* o, const float* dO,
                       const float* lse, float* delta, float* dq, float* dk,
                       float* dv, int B, int H, int T_, int D, long long sb,
                       long long sh, long long st, long long osb,
                       long long osh, long long ost, float scale,
                       cudaStream_t s) {
  static const cudaError_t allowed_dq =
      allow_max_smem(flash_bwd_dq_kernel<DP>);
  static const cudaError_t allowed_dkdv =
      allow_max_smem(flash_bwd_dkdv_kernel<DP>);
  if (allowed_dq != cudaSuccess) return allowed_dq;
  if (allowed_dkdv != cudaSuccess) return allowed_dkdv;
  dim3 grid((T_ + kRows - 1) / kRows, B * H);
  flash_bwd_dq_kernel<DP><<<grid, kThreads, dq_smem<DP>(T_), s>>>(
      q, k, v, mask, o, dO, lse, delta, dq, H, T_, D, sb, sh, st, osb, osh,
      ost, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<DP><<<grid, kThreads, dkdv_smem<DP>(), s>>>(
      q, k, v, mask, dO, lse, delta, dk, dv, H, T_, D, sb, sh, st, osb, osh,
      ost, scale);
  return cudaGetLastError();
}

// dQ (which also writes Delta and round(dP)), then dK/dV, of the mode.
template <int DP>
cudaError_t launch_round_bwd_dp(const float* q, const float* k,
                                const float* v, const uint8_t* mask,
                                const float* dO, const float* p,
                                __nv_bfloat16* dp, float* delta, float* dq,
                                float* dk, float* dv, int B, int H, int T_,
                                int D, long long sb, long long sh,
                                long long st, long long osb, long long osh,
                                long long ost, long long ld, float scale,
                                cudaStream_t s) {
  static const cudaError_t allowed_dq = allow_max_smem(round_dq_kernel<DP>);
  static const cudaError_t allowed_dkdv =
      allow_max_smem(round_dkdv_kernel<DP>);
  if (allowed_dq != cudaSuccess) return allowed_dq;
  if (allowed_dkdv != cudaSuccess) return allowed_dkdv;
  dim3 grid_dq((T_ + kFqRows - 1) / kFqRows, B * H);
  round_dq_kernel<DP><<<grid_dq, kFqThreads, round_smem<DP>(T_), s>>>(
      k, v, mask, dO, p, dp, delta, dq, H, T_, D, sb, sh, st, osb, osh, ost,
      ld, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_kv((T_ + kRows - 1) / kRows, B * H);
  round_dkdv_kernel<DP><<<grid_kv, kKvThreads, round_dkdv_smem<DP>(), s>>>(
      q, mask, dO, p, dp, delta, dk, dv, H, T_, D, sb, sh, st, osb, osh, ost,
      ld, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tk_attn

// Each entry point returns a cudaError_t value: 0 on a successful launch.

extern "C" int tk_flash_fwd(const float* q, const float* k, const float* v,
                            const uint8_t* mask, float* o, float* lse, int B,
                            int H, int T_, int D, long long sb, long long sh,
                            long long st, long long osb, long long osh,
                            long long ost, float scale, void* stream) {
  using namespace tk_attn;
  if (bad_shape(B, H, T_, D, 4)) return (int)cudaErrorInvalidValue;
  return (int)launch_fwd<float, true>(q, k, v, mask, o, lse, B, H, T_, D, sb,
                                      sh, st, osb, osh, ost, scale,
                                      static_cast<cudaStream_t>(stream));
}

// delta is (B, H, T) scratch that the dQ kernel fills and dK/dV reads.
extern "C" int tk_flash_bwd(const float* q, const float* k, const float* v,
                            const uint8_t* mask, const float* o,
                            const float* dO, const float* lse, float* delta,
                            float* dq, float* dk, float* dv, int B, int H,
                            int T_, int D, long long sb, long long sh,
                            long long st, long long osb, long long osh,
                            long long ost, float scale, void* stream) {
  using namespace tk_attn;
  if (bad_shape(B, H, T_, D, 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int DP = padded_dim(D);
  auto launch = DP == 16   ? launch_bwd<16>
                : DP == 32 ? launch_bwd<32>
                : DP == 64 ? launch_bwd<64>
                           : launch_bwd<128>;
  return (int)launch(q, k, v, mask, o, dO, lse, delta, dq, dk, dv, B, H, T_,
                     D, sb, sh, st, osb, osh, ost, scale, s);
}

// The bf16-probability mode. p is (B, H, T, ld) f32 scratch (ld = T
// rounded up to 64): the forward leaves P in it for the backward.
extern "C" int tk_flash_fwd_probs_bf16(const float* q, const float* k,
                                       const float* v, const uint8_t* mask,
                                       float* o, float* lse, float* p, int B,
                                       int H, int T_, int D, long long sb,
                                       long long sh, long long st,
                                       long long osb, long long osh,
                                       long long ost, long long ld,
                                       float scale, void* stream) {
  using namespace tk_attn;
  return (int)launch_round_fwd(q, k, v, mask, o, lse, p, 1, B, H, T_, D, sb,
                               sh, st, osb, osh, ost, ld, scale,
                               static_cast<cudaStream_t>(stream));
}

// p as the forward left it; dp (B, H, T, ld) bf16 and delta (B, H, ld) f32
// are scratch that the dQ kernel fills and dK/dV reads.
extern "C" int tk_flash_bwd_probs_bf16(const float* q, const float* k,
                                       const float* v, const uint8_t* mask,
                                       const float* dO, const float* p,
                                       void* dp, float* delta, float* dq,
                                       float* dk, float* dv, int B, int H,
                                       int T_, int D, long long sb,
                                       long long sh, long long st,
                                       long long osb, long long osh,
                                       long long ost, long long ld,
                                       float scale, void* stream) {
  using namespace tk_attn;
  if (bad_round_shape(B, H, T_, D, ld)) return (int)cudaErrorInvalidValue;
  const int DP = round_dim(D);
  auto launch = DP == 32   ? launch_round_bwd_dp<32>
                : DP == 64 ? launch_round_bwd_dp<64>
                           : launch_round_bwd_dp<128>;
  return (int)launch(q, k, v, mask, dO, p,
                     static_cast<__nv_bfloat16*>(dp), delta, dq, dk, dv, B, H,
                     T_, D, sb, sh, st, osb, osh, ost, ld, scale,
                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
