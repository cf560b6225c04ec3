"""HiFi-GAN's plain reference: the generator, its FLOPs a mel frame, and its
widths in the CPU tests (benchmark/reference/vocoders.py says what a
family's file gives).

HiFi-GAN V1 (Kong et al., arXiv:2010.05646; jik876/hifi-gan models.py
Generator): conv_pre (k 7) -> per upsample stage [leaky_relu 0.1 ->
transposed conv (kernel k, stride u, padding (k - u) / 2) -> the mean of
the ResBlock1 branches, each 3 x [leaky_relu -> dilated conv -> leaky_relu
-> conv] with a residual add] -> leaky_relu 0.01 -> conv_post (k 7) ->
tanh. Every conv is a plain F.conv1d. Nothing of the program is imported.
"""

import torch
import torch.nn.functional as F

from benchmark.reference.vocoders import _ops

# The CPU tests' widths: the shipped layout with 16 channels and one branch.
MICRO = {"upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
         "resblock_dilation_sizes": [[1, 3, 5]]}


def generate(sd, v, mel, precision="float32"):
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


def flops_per_frame(v):
    """Generator FLOPs per mel frame: conv_pre (k 7), per stage a
    transposed conv (k / u taps per output sample) and the MRF (per branch
    of kernel k, 2 convs a dilation), conv_post (k 7)."""
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
