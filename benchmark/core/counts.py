"""Frozen work counts: the operations and bytes each kernel's function needs,
and FastSpeech2's FLOPs, from shapes alone (a vocoder's are its family's:
benchmark/reference/<family>.py, flops_per_frame).

The kernel counts are those of the port's kernel table (chip_smoke.py's
attention_timing_row, mrf_timing_row, flash_timing_row and fused_stages),
copied here so that the yardstick cannot move with the program. They count
the algorithm, not an implementation: a kernel that does more work than its
function needs reads lower against them, never higher.

Peaks are the H100 SXM data sheet's (peaks.json). Float32 is counted as
3xTF32 over the TF32 peak, the fastest way the card reaches float32
accuracy, so no float32 share can read above 100%.
"""

import json
import os

_PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "peaks.json")
_ELEMENT_BYTES = {"bf16": 2, "f32": 4}


def peaks():
    with open(_PEAKS_FILE) as f:
        return json.load(f)


def op_peak(dtype):
    """Operations a second at ``dtype`` ("bf16" or "f32")."""
    p = peaks()
    return {"bf16": p["bf16_ops_per_s"], "f32": p["f32_ops_per_s"]}[dtype]


def bound_s(ops, nbytes, dtype):
    """The least time for ``ops`` operations at ``dtype`` and ``nbytes``
    bytes of device memory traffic: the larger of the two times."""
    return max(ops / op_peak(dtype), nbytes / peaks()["hbm_bytes_per_s"])


# ------------------------------------------------------------ kernels

def attention_work(B, H, T, D, key_lens, dtype):
    """Row 1: masked attention of B items of T query rows over their valid
    keys (key_lens, one per item; padded key tiles are skipped). 4 D
    operations per query row and valid key and head; bytes: Q and O whole,
    K and V at the valid keys, the byte mask. Returns (ops, bytes)."""
    n_keys = float(sum(key_lens))
    ops = 4.0 * H * D * T * n_keys
    nbytes = _ELEMENT_BYTES[dtype] * (2.0 * B * H * T * D
                                      + 2.0 * H * D * n_keys) + B * T
    return ops, nbytes


def mrf_work(B, C, T, kernel_sizes, n_dilations, dtype):
    """Row 2 (bf16) and 2f (f32): one MRF stage over B x T time steps of C
    channels: per branch of kernel k, 2 convs a dilation of k taps, C x C;
    the branch mean. Bytes: x read and y written once, the taps and biases
    once. Returns (ops, bytes)."""
    convs = 2 * n_dilations
    ops = 2.0 * convs * sum(kernel_sizes) * C * C * T * B
    weights = convs * (sum(kernel_sizes) * C * C + len(kernel_sizes) * C)
    nbytes = _ELEMENT_BYTES[dtype] * (2.0 * B * T * C + weights)
    return ops, nbytes


def flash_work(B, H, T, D, key_lens):
    """Rows 3a-c: the training attention, f32, forward and backward (dQ,
    dK and dV, S and dP recomputed), over the valid keys. Forward 4 D
    operations per (row, valid key) and head, backward 10; bytes: each
    input read and each output written once, K and V at the valid keys,
    the log-sum-exp, the mask. Returns ((ops_fwd, bytes_fwd), (ops_bwd,
    bytes_bwd))."""
    n_keys = float(sum(key_lens))
    pairs = H * D * T * n_keys
    elems, kv = B * H * T * D, 2.0 * H * D * n_keys
    bytes_f = 4.0 * (2 * elems + kv + B * H * T) + B * T
    bytes_b = 4.0 * (6 * elems + kv + B * H * T) + B * T
    return (4.0 * pairs, bytes_f), (10.0 * pairs, bytes_b)


def fused_stages(vocoder, T_mel, max_channels=128):
    """(C, T) of the HiFi-GAN stages that run the MRF kernel at T_mel mel
    frames (the stages of at most ``max_channels`` channels)."""
    out, up = [], 1
    for i, u in enumerate(vocoder["upsample_rates"]):
        up *= u
        C = vocoder["upsample_initial_channel"] // 2 ** (i + 1)
        if C <= max_channels:
            out.append((C, T_mel * up))
    return out


# ------------------------------------------------------------ model FLOPs

def _fft_block_flops(tokens, d, heads, d_inner, kernels):
    """One FFT block over ``tokens`` tokens of one item, its attention over
    those tokens only."""
    d_k = d // heads
    per_token = (2 * d * 3 * heads * d_k + 2 * heads * d_k * d
                 + 2 * kernels[0] * d * d_inner + 2 * kernels[1] * d_inner * d)
    return per_token * tokens + 4.0 * heads * d_k * tokens * tokens


def fs2_flops(model, phonemes, frames):
    """FastSpeech2 inference of one item of ``phonemes`` phonemes and
    ``frames`` mel frames: encoder, three variance predictors, decoder,
    mel projection and postnet, at the item's own lengths."""
    t = model["transformer"]
    kernels = t["conv_kernel_size"]
    enc = t["encoder_layer"] * _fft_block_flops(
        phonemes, t["encoder_hidden"], t["encoder_head"],
        t["conv_filter_size"], kernels)
    vp = model["variance_predictor"]
    k, f, d = vp["kernel_size"], vp["filter_size"], t["encoder_hidden"]
    adaptor = 3 * phonemes * (2 * k * d * f + 2 * k * f * f + 2 * f)
    dec = t["decoder_layer"] * _fft_block_flops(
        frames, t["decoder_hidden"], t["decoder_head"],
        t["conv_filter_size"], kernels)
    n_mel, p = model["n_mel_channels"], model["postnet_dim"]
    chans = [n_mel] + [p] * 4 + [n_mel]
    postnet = sum(2 * 5 * a * b for a, b in zip(chans[:-1], chans[1:]))
    return enc + adaptor + dec + frames * (2 * t["decoder_hidden"] * n_mel
                                           + postnet)
