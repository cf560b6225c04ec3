"""Plain vocoder generators, the references the benchmark holds the
program's vocoders to, and the int16 cast of the waveform.

HiFi-GAN V1 (Kong et al., arXiv:2010.05646; jik876/hifi-gan models.py
Generator): conv_pre (k 7) -> per upsample stage [leaky_relu 0.1 ->
transposed conv (kernel k, stride u, padding (k - u) / 2) -> the mean of
the ResBlock1 branches, each 3 x [leaky_relu -> dilated conv -> leaky_relu
-> conv] with a residual add] -> leaky_relu 0.01 -> conv_post (k 7) ->
tanh. Every conv is a plain F.conv1d.

MelGAN (Kumar et al., arXiv:1910.06711; descriptinc/melgan-neurips
Generator, weight norm folded): reflect-padded conv (k 7) -> per ratio r
[leaky_relu 0.2 -> transposed conv (2r, stride r, padding r / 2 + r % 2)
-> residual layers j (leaky_relu -> reflect pad 3^j -> conv k 3 dilated 3^j
-> leaky_relu -> conv 1 x 1, plus a 1 x 1 shortcut)] -> leaky_relu 0.2 ->
reflect-padded conv (k 7) to one channel -> tanh. It takes log10 mels.

``precision`` is how the generator computes:
  "float32"   every op in float32 (TF32 off by the caller);
  "bfloat16"  as PyTorch computes a bfloat16 module: every tensor held in
              bfloat16 (the mel rounded on the way in, each op's result
              rounded), each conv's products of bfloat16 inputs and
              weights summed in float32 and rounded before its bias is
              added and rounded again; the tanh in float32;
  "float8"    the lower-precision control: each conv's input and weight
              rounded to float8 e4m3 with one scale per tensor, products
              summed in float32, the rest in float32.

Weights are a state dict keyed as the program's module; nothing of the
program is imported.
"""

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(t):
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _ops(precision):
    """(conv, transposed conv, rounding of every other op's result) in
    ``precision``; each conv takes (x, w, b, **conv kwargs)."""
    def make(fn, cast_in, cast_out):
        def conv(x, w, b, **k):
            y = fn(cast_in(x), cast_in(w), None, **k)
            return cast_out(cast_out(y) + cast_out(b)[:, None])
        return conv

    keep = lambda t: t
    if precision == "float32":
        cast_in, cast_out, r = keep, keep, keep
    elif precision == "bfloat16":
        cast_in, cast_out, r = _bf16, _bf16, _bf16
    elif precision == "float8":
        cast_in, cast_out, r = _fp8, keep, keep
    else:
        raise ValueError(precision)
    return (make(F.conv1d, cast_in, cast_out),
            make(F.conv_transpose1d, cast_in, cast_out), r)


def hifigan(sd, v, mel, precision="float32"):
    """mel (T, n_mel) natural-log -> waveform (T * hop,) in [-1, 1]."""
    conv, convt, r = _ops(precision)
    g = {k: t.float() for k, t in sd.items()}

    def lrelu(t, slope=0.1):
        return r(F.leaky_relu(t, slope))

    x = conv(r(mel.t()[None].float()), g["conv_pre.weight"],
             g["conv_pre.bias"], padding=3)
    n_k = len(v["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"],
                                   v["upsample_kernel_sizes"])):
        x = convt(lrelu(x), g[f"ups_{i}.weight"], g[f"ups_{i}.bias"],
                  stride=u, padding=(k - u) // 2)
        acc = None
        for j, (rk, dil) in enumerate(zip(v["resblock_kernel_sizes"],
                                          v["resblock_dilation_sizes"])):
            p = f"resblocks_{i * n_k + j}"
            h = x
            for m, d in enumerate(dil):
                t = conv(lrelu(h), g[f"{p}.convs1_{m}.weight"],
                         g[f"{p}.convs1_{m}.bias"], dilation=d,
                         padding=(rk * d - d) // 2)
                t = conv(lrelu(t), g[f"{p}.convs2_{m}.weight"],
                         g[f"{p}.convs2_{m}.bias"], padding=(rk - 1) // 2)
                h = r(t + h)
            acc = h if acc is None else r(acc + h)
        x = r(acc / n_k)
    x = conv(lrelu(x, 0.01), g["conv_post.weight"], g["conv_post.bias"],
             padding=3)
    return torch.tanh(x)[0, 0]


def melgan(sd, v, mel, precision="float32"):
    """mel (T, n_mel) natural-log -> waveform (T * hop,) in [-1, 1]."""
    conv, convt, r = _ops(precision)
    g = {k: t.float() for k, t in sd.items()}

    def lrelu(t):
        return r(F.leaky_relu(t, 0.2))

    def reflect(t, p):
        return F.pad(t, (p, p), mode="reflect")

    x = mel.t()[None].float()
    x = r(x / torch.full((), math.log(10.0), device=x.device))
    x = conv(reflect(x, 3), g["conv_in.weight"], g["conv_in.bias"])
    for i, u in enumerate(v["upsample_rates"]):
        x = convt(lrelu(x), g[f"up_{i}.weight"], g[f"up_{i}.bias"],
                  stride=u, padding=u // 2 + u % 2)
        if u % 2:
            x = F.pad(x, (0, 1))
        for j in range(v["n_residual_layers"]):
            p, d = f"res_{i}_{j}", 3 ** j
            h = conv(reflect(lrelu(x), d), g[f"{p}.block_conv.weight"],
                     g[f"{p}.block_conv.bias"], dilation=d)
            h = conv(lrelu(h), g[f"{p}.block_out.weight"],
                     g[f"{p}.block_out.bias"])
            x = r(conv(x, g[f"{p}.shortcut.weight"],
                       g[f"{p}.shortcut.bias"]) + h)
    x = conv(reflect(lrelu(x), 3), g["conv_out.weight"], g["conv_out.bias"])
    return torch.tanh(x)[0, 0]


VOCODERS = {"HiFi-GAN": hifigan, "MelGAN": melgan}


def to_int16(wav, max_wav_value):
    """Scale and cast f32 -> int32 -> int16: truncation toward zero, then
    the wrap of numpy's astype (+1.0 x 32768 -> -32768)."""
    return (wav * max_wav_value).to(torch.int32).to(torch.int16)

