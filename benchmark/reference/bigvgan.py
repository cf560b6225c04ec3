"""BigVGAN-v2's plain reference: the generator, its FLOPs a mel frame, the
anti-aliased activation's work, its widths in the CPU tests and its weight
rules (benchmark/reference/vocoders.py says what a family's file gives).

BigVGAN-v2 (Lee et al., arXiv:2206.04658; NVIDIA/BigVGAN bigvgan.py,
activations.py, alias_free_activation/torch/{act,filter,resample}.py;
configs/bigvgan_v2_22khz_80band_256x.json): conv_pre (k 7) -> per upsample
stage [transposed conv (kernel k, stride u, padding (k - u) / 2), no
activation before it -> the mean of the AMPBlock1 branches, each 3 x
[act -> dilated conv -> act -> conv] with a residual add, an activation of
its own before each conv] -> act -> conv_post (k 7, no bias unless
use_bias_at_final) -> clamp to [-1, 1] (tanh with use_tanh_at_final).

``act`` is Activation1d(SnakeBeta) with log-scale parameters, per channel:
replicate-pad 5, depthwise conv_transpose1d (stride 2) with the 12-tap
filter, times 2, crop 15 a side; x + sin^2(x e^alpha) / (e^beta + 1e-9);
replicate-pad 5 and 6, depthwise conv1d (stride 2) with the same filter.
The filter is worked out here from the published formula
(kaiser_sinc_filter1d, cutoff 0.25, half-width 0.3, 12 taps). In
"bfloat16" every op of the activation is rounded as a bf16 module computes
it, the 2x signal and the filter buffer too; in "float8" the model's convs
take float8 and the activation, whose filter is fixed and not a learned
weight, stays in float32. Nothing of the program is imported.
"""

import math

import torch
import torch.nn.functional as F

from benchmark.reference.vocoders import _ops

TAPS = 12

# The CPU tests' widths: all six stages and all three branches, 128
# channels in (64 .. 2 in the stages). With one branch the seeded signal
# grows faster than at the published widths (no mean over branches): it
# clipped 11-66% of the samples and the port and the reference, which
# round in other orders, drifted 2-8e-5 apart; with three its loudness is
# the published widths' and they agree within 3.2e-6.
MICRO = {"upsample_initial_channel": 128}


def lowpass_filter(cutoff=0.25, half_width=0.3, taps=TAPS):
    """kaiser_sinc_filter1d: a Kaiser window (beta from the transition
    width: A = 2.285 (taps/2 - 1) pi 4 half_width + 7.95 = 51.02, beta =
    0.1102 (A - 8.7) = 4.6638) times 2 cutoff sinc(2 cutoff t) at t = -5.5
    .. 5.5, normalised to sum 1. f32, on the CPU."""
    half = taps // 2
    A = 2.285 * (half - 1) * math.pi * (4 * half_width) + 7.95
    beta = 0.1102 * (A - 8.7)
    window = torch.kaiser_window(taps, beta=beta, periodic=False)
    t = torch.arange(-half, half) + 0.5
    z = 2 * cutoff * t
    f = 2 * cutoff * window * (torch.sin(math.pi * z) / math.pi / z)
    return f / f.sum()


# conv_post's weight as core/weights.py draws it (N(0, 1/fan_in)) times
# this. Drawn so, the seeded generator's waveform before the clamp has an
# RMS near 10 at the published widths and three quarters of it clips; a
# clamped sample reads the same in the program and the reference whatever
# either computed. At an eightieth its RMS is 0.12-0.17, a trained model's
# loudness, and no sample of three seeds' sentences clipped.
CONV_POST_SCALE = 1 / 80

# Where the seeded draw does not fit (core/weights.py): SnakeBeta's
# log-scale alpha and beta start near their upstream value 0; a filter
# buffer, where a state dict holds one, takes the formula's fixed values
# (the program's holds none); conv_post as above.
WEIGHT_RULES = {
    r".*\.(alpha|beta)": lambda z: 0.1 * z,
    r".*filter": lambda z: lowpass_filter().to(z.device).expand_as(z).clone(),
    r"conv_post\.weight": lambda z: CONV_POST_SCALE * z / math.sqrt(
        z[0].numel()),
}


def _act(x, alpha, beta, r, f):
    """Activation1d(SnakeBeta(logscale)) of x (1, C, T), each op's result
    rounded by ``r``; f the filter as the module holds it."""
    C = x.shape[1]
    w = f.view(1, 1, TAPS).expand(C, 1, TAPS)
    u = F.pad(x, (5, 5), mode="replicate")
    u = r(2.0 * r(F.conv_transpose1d(u, w, stride=2, groups=C)))[..., 15:-15]
    a = r(torch.exp(alpha))[:, None]
    b = r(torch.exp(beta))[:, None]
    s = r(r(torch.sin(r(u * a))) ** 2)
    s = r(u + r(r(1.0 / r(b + 1e-9)) * s))
    s = F.pad(s, (5, 6), mode="replicate")
    return r(F.conv1d(s, w, stride=2, groups=C))


def generate(sd, v, mel, precision="float32"):
    """mel (T, n_mel) natural-log -> waveform (T * hop,) in [-1, 1]."""
    conv, convt, r = _ops(precision)
    g = {k: t.float() for k, t in sd.items()}
    f = r(lowpass_filter().to(mel.device))

    def act(x, p):
        return _act(x, g[f"{p}.alpha"], g[f"{p}.beta"], r, f)

    x = conv(r(mel.t()[None].float()), g["conv_pre.weight"],
             g["conv_pre.bias"], padding=3)
    n_k = len(v["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"],
                                   v["upsample_kernel_sizes"])):
        x = convt(x, g[f"ups_{i}.weight"], g[f"ups_{i}.bias"], stride=u,
                  padding=(k - u) // 2)
        acc = None
        for j, (rk, dil) in enumerate(zip(v["resblock_kernel_sizes"],
                                          v["resblock_dilation_sizes"])):
            p = f"resblocks_{i * n_k + j}"
            h = x
            for m, d in enumerate(dil):
                t = conv(act(h, f"{p}.activations_{2 * m}"),
                         g[f"{p}.convs1_{m}.weight"],
                         g[f"{p}.convs1_{m}.bias"], dilation=d,
                         padding=(rk * d - d) // 2)
                t = conv(act(t, f"{p}.activations_{2 * m + 1}"),
                         g[f"{p}.convs2_{m}.weight"],
                         g[f"{p}.convs2_{m}.bias"], padding=(rk - 1) // 2)
                h = r(t + h)
            acc = h if acc is None else r(acc + h)
        x = r(acc / n_k)
    w = g["conv_post.weight"]
    x = conv(act(x, "activation_post"), w,
             g.get("conv_post.bias", torch.zeros(1, device=w.device)),
             padding=3)
    if v.get("use_tanh_at_final", True):
        return torch.tanh(x)[0, 0]
    return torch.clamp(x, -1.0, 1.0)[0, 0]


def flops_per_frame(v):
    """Generator FLOPs per mel frame: the convs alone, as HiFi-GAN's count
    has them (conv_pre, per stage a transposed conv of k / u taps an output
    sample and the AMP branches' 2 convs a dilation, conv_post); the
    anti-aliased activations' ~50 operations an element are left out, as
    HiFi-GAN's count leaves out its leaky ReLUs. 1,803,718,656 at the
    published widths."""
    c = v["upsample_initial_channel"]
    flops, up = 2 * 7 * v["num_mels"] * c, 1
    for u, k in zip(v["upsample_rates"], v["upsample_kernel_sizes"]):
        up *= u
        c_out = c // 2
        flops += 2 * (k // u) * c * c_out * up
        flops += sum(2 * len(d) * 2 * kk * c_out * c_out * up
                     for kk, d in zip(v["resblock_kernel_sizes"],
                                      v["resblock_dilation_sizes"]))
        c = c_out
    return flops + 2 * 7 * c * up


def act_elements_per_frame(v):
    """Base-rate elements the anti-aliased activations take in a mel frame:
    per stage of C channels at ``up`` samples a frame, 2 per dilation per
    branch, and activation_post once. 614,400 at the published widths."""
    c, up, n = v["upsample_initial_channel"], 1, 0
    for u in v["upsample_rates"]:
        up *= u
        c //= 2
        n += c * up * sum(2 * len(d) for d in v["resblock_dilation_sizes"])
    return n + c * up


def act_work(v, frames, calls, element_bytes):
    """The activations' least work for ``frames`` real mel frames over
    ``calls`` generator calls: (operations, bytes). Each base-rate element
    is read once and written once, and each call reads every activation's
    alpha and beta (C values each); per element 24 multiply-adds (12 taps
    up for its two 2x samples, 12 down) and two sines, each 2x sample's
    snake four operations with its sine."""
    n = act_elements_per_frame(v) * float(frames)
    params = 2 * act_elements_per_frame(dict(
        v, upsample_rates=[1] * len(v["upsample_rates"])))
    return (n * (24 * 2 + 2 * 4),
            element_bytes * (2 * n + float(calls) * params))
