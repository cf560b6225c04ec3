"""MelGAN vocoder generator, inference only.

Port of tts_king_tpu/models/melgan.py (the descript MelGAN architecture
that the reference loads from torch.hub as its alternative vocoder,
fs_two/utils/model.py:52-61): reflect-pad conv7 (80 -> ngf * 2^n) -> per
upsample ratio r: leaky_relu(0.2) -> ConvTranspose1d(2r, stride r, padding
r // 2 + r % 2) -> n_residual_layers ResnetBlocks (dilation 3^j;
leaky_relu -> reflect-pad dilated conv3 -> leaky_relu -> conv1, plus a
1 x 1 shortcut) -> leaky_relu -> reflect-pad conv7 -> 1 channel -> tanh in
f32. Weight norm is folded at load (checkpoint.convert_melgan_state).

At an odd ratio the upstream module computes one more output sample
(output_padding = 1); the JAX package appends a zero sample instead
(melgan.py:95-96), and the port follows the JAX package. The shipped
ratios (8, 8, 2, 2) are even, where the two agree.

The model consumes log10 mels (pipeline.Vocoder divides natural-log mels by
ln 10). Activations are (B, C, T) inside; mel (B, T, 80) in, waveform
(B, T * prod(ratios)) out.
"""

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.2


def _reflect(x, pad):
    return F.pad(x, (pad, pad), mode="reflect")


class ResnetBlock(nn.Module):
    def __init__(self, dim, dilation=1):
        super().__init__()
        self.dilation = dilation
        self.block_conv = nn.Conv1d(dim, dim, 3, dilation=dilation)
        self.block_out = nn.Conv1d(dim, dim, 1)
        self.shortcut = nn.Conv1d(dim, dim, 1)

    def forward(self, x):
        h = _reflect(F.leaky_relu(x, LRELU_SLOPE), self.dilation)
        h = self.block_out(F.leaky_relu(self.block_conv(h), LRELU_SLOPE))
        return self.shortcut(x) + h


class MelGANGenerator(nn.Module):
    """(B, T, mel_channels) log10 mel -> (B, T * prod(ratios)) in [-1, 1]."""

    def __init__(self, mel_channels=80, ngf=32, n_residual_layers=3,
                 ratios=(8, 8, 2, 2)):
        super().__init__()
        self.ratios = tuple(ratios)
        self.n_residual_layers = n_residual_layers
        ch = ngf * 2 ** len(self.ratios)
        self.conv_in = nn.Conv1d(mel_channels, ch, 7)
        for i, r in enumerate(self.ratios):
            self.add_module(f"up_{i}", nn.ConvTranspose1d(
                ch, ch // 2, 2 * r, stride=r, padding=r // 2 + r % 2))
            ch //= 2
            for j in range(n_residual_layers):
                self.add_module(f"res_{i}_{j}", ResnetBlock(ch, 3 ** j))
        self.conv_out = nn.Conv1d(ch, 1, 7)

    def forward(self, mel):
        x = mel.to(self.conv_in.weight.dtype).transpose(1, 2)
        x = self.conv_in(_reflect(x, 3))
        for i, r in enumerate(self.ratios):
            x = getattr(self, f"up_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            if r % 2:
                x = F.pad(x, (0, 1))   # the JAX package's zero sample
            for j in range(self.n_residual_layers):
                x = getattr(self, f"res_{i}_{j}")(x)
        x = self.conv_out(_reflect(F.leaky_relu(x, LRELU_SLOPE), 3))
        return torch.tanh(x.float())[:, 0, :]
