"""MelGAN's plain reference: the generator, its FLOPs a mel frame, and its
widths in the CPU tests (benchmark/reference/vocoders.py says what a
family's file gives).

MelGAN (Kumar et al., arXiv:1910.06711; descriptinc/melgan-neurips
Generator, weight norm folded): reflect-padded conv (k 7) -> per ratio r
[leaky_relu 0.2 -> transposed conv (2r, stride r, padding r / 2 + r % 2)
-> residual layers j (leaky_relu -> reflect pad 3^j -> conv k 3 dilated 3^j
-> leaky_relu -> conv 1 x 1, plus a 1 x 1 shortcut)] -> leaky_relu 0.2 ->
reflect-padded conv (k 7) to one channel -> tanh. It takes log10 mels.
Nothing of the program is imported.
"""

import math

import torch
import torch.nn.functional as F

from benchmark.reference.vocoders import _ops

# The CPU tests run MelGAN at its published widths (ngf 32 is small, and the
# program's MelGAN has no other).
MICRO = {}


def generate(sd, v, mel, precision="float32"):
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


def flops_per_frame(v):
    """Generator FLOPs per mel frame: conv_in (k 7), per ratio r a
    transposed conv (2 taps per output sample) and the residual layers
    (a dilated k 3 conv, a 1 x 1 conv and the 1 x 1 shortcut), conv_out."""
    c = v["ngf"] * 2 ** len(v["upsample_rates"])
    flops, up = 2 * 7 * v["num_mels"] * c, 1
    for r in v["upsample_rates"]:
        up *= r
        c_out = c // 2
        flops += 2 * 2 * c * c_out * up
        flops += v["n_residual_layers"] * (2 * 3 + 2 + 2) * c_out * c_out * up
        c = c_out
    return flops + 2 * 7 * c * up
