// Masked self-attention for the FastSpeech2 FFT blocks, inference only.
//
// Replaces: tts_king_tpu/ops/pallas/attention.py, fused_attention (kernel
// body _attn_kernel). Per (batch, head) it computes
//     softmax(where(key_pad, -1e9, (q * scale) @ k^T)) @ v
// with f32 scores, f32 softmax and f32 accumulation. As in the TPU kernel,
// q is scaled in its own type before the product (scale rounded to that
// type first), and the probabilities are rounded to v's type before P.V.
//
// What bounds it on an H100: at the batched shape (B=32, H=2, T=1000,
// D=128, bf16) the work is 4*T*D operations per (query row, valid key)
// against 4*T*D elements moved per (b, h): about 250 operations per byte
// with every key valid, so the tensor-core bound and the memory bound are
// of one order. In f32 (speak, validation) the products are 3xTF32, three
// TF32 products per f32 product.
//
// Design (attention_mma.cuh, attn_fwd_kernel with FLASH = false): one block
// of 4 warps per (b, h, 64 query rows), 16 rows a warp. bf16: q * scale
// rounded to bf16 sits in registers; S = QK^T and O += PV run on
// mma.sync.m16n8k16 with an online softmax in registers and P reused from
// the S accumulators as the next A operand; V arrives by ldmatrix.trans.
// f32: the same loop on 3xTF32 mma.sync.m16n8k8. K/V tiles of 32 keys
// stream through a two-stage cp.async ring, the next tile loading while
// this one's products run; bf16 fits four blocks on an SM (Q shares the
// ring's second stage until it is in registers). Key tiles that hold only
// padded keys are skipped when the item has a valid key (their
// probabilities are exactly 0); an item with no valid key runs every tile,
// so its rows stay the uniform average over T. Keys past T take no part.
// Every query row in [0, T) is computed, padded ones included: they stay
// finite, and the caller zeroes them.
//
// bf16-probability mode (f32; tk_attention_probs_bf16): the XLA route of
// the JAX package's MultiHeadAttention (tts_king_tpu/models/layers.py,
// attention_probs_bf16), which scales S after the product and rounds the
// normalized probabilities to bf16 before P.V: attention_round.cuh's
// forward, with S kept in a scratch buffer between its two passes.
//
// Layout: q, k, v are (B, H, T, D) views given by element strides (sb, sh,
// st) with a unit stride over D, so the (B, T, H, D) output of a Linear can
// be passed without a copy; rows and the (b, h) bases start on 16 bytes. The
// output has its own strides. D is a multiple of 16 bytes (8 in bf16, 4 in
// f32; D = 4 and 8 are the goldens' widths), at most 128.

#include "attention_round.cuh"

// Returns a cudaError_t value: 0 on a successful launch.
extern "C" int tk_attention(const void* q, const void* k, const void* v,
                            const uint8_t* mask, void* o, int is_bf16, int B,
                            int H, int T_, int D, long long sb, long long sh,
                            long long st, long long osb, long long osh,
                            long long ost, float scale, void* stream) {
  using namespace tk_attn;
  if (bad_shape(B, H, T_, D, is_bf16 ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_fwd<__nv_bfloat16, false>(q, k, v, mask, o, nullptr, B,
                                                 H, T_, D, sb, sh, st, osb,
                                                 osh, ost, scale, s)
              : launch_fwd<float, false>(q, k, v, mask, o, nullptr, B, H, T_,
                                         D, sb, sh, st, osb, osh, ost, scale,
                                         s);
  return (int)err;
}

// The bf16-probability mode (f32; ModelConfig.attention_probs_bf16): S =
// (q k^T) * scale, O = round_bf16(P) V with P the normalized softmax.
// scratch is (B, H, T, ld) f32 with ld = T rounded up to 64.
extern "C" int tk_attention_probs_bf16(const float* q, const float* k,
                                       const float* v, const uint8_t* mask,
                                       float* o, float* scratch, int B, int H,
                                       int T_, int D, long long sb,
                                       long long sh, long long st,
                                       long long osb, long long osh,
                                       long long ost, long long ld,
                                       float scale, void* stream) {
  using namespace tk_attn;
  return (int)launch_round_fwd(q, k, v, mask, o, nullptr, scratch, 0, B, H,
                               T_, D, sb, sh, st, osb, osh, ost, ld, scale,
                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* tk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
