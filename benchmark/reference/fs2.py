"""Plain float32 FastSpeech2 inference of one sentence, the reference the
benchmark holds the program's FastSpeech2 to.

FastSpeech 2 (Ren et al., arXiv:2006.04558) as the ming024/FastSpeech2 code
computes it: a 4-block FFT encoder (post-LayerNorm self-attention and a
conv1d feed-forward of kernels 9 and 1, padded positions zeroed after each
sub-layer); the duration predictor on the encoder output, then the speaker
embedding added; pitch and energy predictors (2 x [conv k 3, ReLU,
LayerNorm] and a linear head), each followed by the embedding of its value
bucketized over 255 linear bins (left-sided search); the length regulator;
a 6-block FFT decoder; the mel projection; a 5-conv postnet (k 5, BatchNorm,
tanh but on the last) whose residual is added. Inference durations are
clamp(round(exp(log d) - 1) x control, 0).

Precision: float32 throughout; the caller turns TF32 off. Where the
configuration states its FastSpeech2 variables in bfloat16, every float
variable is rounded to bfloat16 and BatchNorm's multiplier rsqrt(var + eps)
is computed in bfloat16, as flax computes a BatchNorm on such variables.

The program's discrete choices (each phoneme's duration and its pitch and
energy bins) are read from the program's outputs, the way a served model's
tokens are, and the reference continues from them, so that one choice made
on a rounding edge does not shift every later frame. What is held instead
is what the choices are made from: the program's log-durations, pitches
and energies against the reference's own, and each duration against the
rounding of the program's own log-duration (exactly: both round the same
float32 value with the same operations).

The phoneme padding and the mel length the program ran at are read from its
outputs' shapes: the variance predictors' second conv sees one padded
position past the sentence, as the upstream model does, and the postnet
mel past the sentence's frames is the mel projection's bias.

Weights are a state dict keyed as the program's module; nothing of the
program is imported.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def stored(t, dtype_name):
    """A float variable as the configuration stores it (``dtype_name``),
    held in float32."""
    if dtype_name == "float32":
        return t.float()
    if dtype_name != "bfloat16":
        raise ValueError(dtype_name)
    return t.to(torch.bfloat16).float()


def round_variables(sd, dtype_name):
    """The state dict as the configuration stores it."""
    return {k: stored(v, dtype_name) for k, v in sd.items()}


def positions(n, d):
    """Sinusoid table (n, d): angle pos / 10000^(2 (i // 2) / d), sin on
    even channels, cos on odd; computed in float64, stored in float32."""
    pos = np.arange(n)[:, None]
    idx = np.arange(d)[None, :]
    angle = pos / np.power(10000, 2 * (idx // 2) / d)
    table = np.where(idx % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(table.astype(np.float32))


def bins(lo, hi, n_bins):
    return torch.from_numpy(np.linspace(lo, hi, n_bins - 1).astype(np.float32))


def conv(x, w, b, padding):
    """conv1d on (T, C) rows."""
    return F.conv1d(x.t()[None], w, b, padding=padding)[0].t()


def layer_norm(x, sd, p):
    return F.layer_norm(x, x.shape[-1:], sd[f"{p}.weight"], sd[f"{p}.bias"],
                        LN_EPS)


def attention_block(x, valid, sd, p, heads):
    L, d = x.shape
    dk = d // heads
    q, k, v = (F.linear(x, sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"])
               .view(L, heads, dk).transpose(0, 1)
               for n in ("w_qs", "w_ks", "w_vs"))
    s = q @ k.transpose(1, 2) / math.sqrt(dk)
    s = s.masked_fill(~valid[None, None, :], -1e9)
    o = (torch.softmax(s, dim=-1) @ v).transpose(0, 1).reshape(L, d)
    o = F.linear(o, sd[f"{p}.fc.weight"], sd[f"{p}.fc.bias"])
    return layer_norm(o + x, sd, f"{p}.layer_norm") * valid[:, None]


def fft_block(x, valid, sd, p, heads, kernels):
    x = attention_block(x, valid, sd, f"{p}.slf_attn", heads)
    h = F.relu(conv(x, sd[f"{p}.pos_ffn.w_1.weight"],
                    sd[f"{p}.pos_ffn.w_1.bias"], (kernels[0] - 1) // 2))
    h = conv(h, sd[f"{p}.pos_ffn.w_2.weight"], sd[f"{p}.pos_ffn.w_2.bias"],
             (kernels[1] - 1) // 2)
    return layer_norm(h + x, sd, f"{p}.pos_ffn.layer_norm") * valid[:, None]


def predictor_features(x, sd, p, k):
    """A variance predictor's features before its linear head."""
    h = layer_norm(F.relu(conv(x, sd[f"{p}.conv1d_1.weight"],
                               sd[f"{p}.conv1d_1.bias"], (k - 1) // 2)),
                   sd, f"{p}.layer_norm_1")
    return layer_norm(F.relu(conv(h, sd[f"{p}.conv1d_2.weight"],
                                  sd[f"{p}.conv1d_2.bias"], 1)),
                      sd, f"{p}.layer_norm_2")


def predictor(x, valid, sd, p, k):
    h = predictor_features(x, sd, p, k)
    out = F.linear(h, sd[f"{p}.linear_layer.weight"],
                   sd[f"{p}.linear_layer.bias"])[:, 0]
    return torch.where(valid, out, torch.zeros_like(out))


def batch_norm(x, sd, p, dtype_name):
    """Eval-mode BatchNorm on (T, C): (x - mean) * rsqrt(var + eps) * scale
    + shift, the multiplier computed in the variables' dtype."""
    mean, var = sd[f"{p}.running_mean"], sd[f"{p}.running_var"]
    if dtype_name == "bfloat16":
        bf = torch.bfloat16
        eps = float(torch.tensor(LN_EPS, dtype=bf))
        inv = torch.rsqrt((var + eps).to(bf).float()).to(bf).float()
        mul = inv * sd[f"{p}.weight"]
    else:
        mul = torch.rsqrt(var + LN_EPS) * sd[f"{p}.weight"]
    return (x - mean) * mul + sd[f"{p}.bias"]


def round_durations(log_d, control):
    """Inference durations: clamp(round(exp(log d) - 1) x control, 0),
    rounding half to even."""
    return torch.clamp(torch.round(torch.exp(log_d) - 1.0) * control, min=0.0)


def encode(sd, model, phonemes, length):
    """The encoder's output (Lp, d) and the valid-phoneme mask."""
    t = model["transformer"]
    Lp = phonemes.shape[0]
    valid = torch.arange(Lp, device=phonemes.device) < length
    emb = sd["encoder.src_word_emb.weight"][phonemes]
    x = torch.where((phonemes == 0)[:, None], torch.zeros_like(emb), emb)
    x = x + positions(Lp, t["encoder_hidden"]).to(phonemes.device)
    for i in range(t["encoder_layer"]):
        x = fft_block(x, valid, sd, f"encoder.layer_{i}", t["encoder_head"],
                      t["conv_kernel_size"])
    return x, valid


def duration_features(sd, model, phonemes, length):
    """The duration predictor's features before its head, at the
    sentence's valid phonemes: (length, filter)."""
    x, valid = encode(sd, model, phonemes, length)
    k = model["variance_predictor"]["kernel_size"]
    return predictor_features(x, sd, "variance_adaptor.duration_predictor",
                              k)[valid]


def fs2_sentence(sd, model, precision, stats, phonemes, length, speaker,
                 chosen, max_frames):
    """One sentence through the reference.

    sd: the state dict (float32 tensors on the device), already rounded by
    ``round_variables``; model: the configuration's "model" dict;
    precision: its precision's "acoustic_variables"; stats: pitch and
    energy [min, max]; phonemes: (Lp,) ids on the device, the sentence's
    ``length`` first, zeros after (Lp, the program's padding); speaker: the
    speaker id; chosen: the program's (Lp,) "log_duration" predictions,
    "duration" frame counts, "pitch" and "energy" predictions;
    max_frames: the program's mel length T.

    Returns the postnet mel (T, n_mel), its frame count, and ``errs``: the
    largest |program - reference| of the log-durations, pitches and
    energies over the sentence's phonemes, and the number of phonemes whose
    duration is not the rounding of the program's own log-duration.
    """
    t = model["transformer"]
    dev = phonemes.device
    x, valid = encode(sd, model, phonemes, length)
    k = model["variance_predictor"]["kernel_size"]
    va = "variance_adaptor"
    errs = {}

    def held(name, ref):
        errs[name] = float((chosen[name].float() - ref)[valid].abs().max())

    held("log_duration", predictor(x, valid, sd, f"{va}.duration_predictor",
                                   k))
    x = x + sd["speaker_emb.weight"][speaker]
    n_bins = model["variance_embedding"]["n_bins"]
    for kind in ("pitch", "energy"):
        held(kind, predictor(x, valid, sd, f"{va}.{kind}_predictor", k))
        edges = bins(*stats[kind][:2], n_bins).to(dev)
        pick = torch.searchsorted(edges, chosen[kind].float().contiguous())
        x = x + sd[f"{va}.{kind}_embedding.weight"][pick]
    frames = chosen["duration"].round().long()
    errs["duration_mismatch"] = int(
        (round_durations(chosen["log_duration"].float(), 1.0)
         != chosen["duration"].float()).sum())
    n = min(int(frames.sum()), max_frames)
    h = torch.repeat_interleave(x, frames, dim=0)[:n]
    h = h + positions(n, t["decoder_hidden"]).to(dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    for i in range(t["decoder_layer"]):
        h = fft_block(h, ones, sd, f"decoder.layer_{i}", t["decoder_head"],
                      t["conv_kernel_size"])
    mel = F.linear(h, sd["mel_linear.weight"], sd["mel_linear.bias"])
    p = mel
    for i in range(5):
        p = batch_norm(conv(p, sd[f"postnet.conv_{i}.weight"],
                            sd[f"postnet.conv_{i}.bias"], 2),
                       sd, f"postnet.bn_{i}", precision)
        if i < 4:
            p = torch.tanh(p)
    out = sd["mel_linear.bias"].expand(max_frames, -1).clone()
    out[:n] = p + mel
    return out, n, errs
