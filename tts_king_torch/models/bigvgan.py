"""BigVGAN-v2 generator, inference only.

BigVGAN (Lee et al., arXiv:2206.04658; NVIDIA/BigVGAN bigvgan.py,
activations.py, alias_free_activation/torch/), the layout of
``configs/bigvgan_v2_22khz_80band_256x.json`` and of every BigVGAN-v2
config (config.BIGVGAN_V2: log-scale SnakeBeta, a clamp and no final bias;
the widths come from VocoderModelConfig). The JAX package has no BigVGAN.

  conv_pre (k 7) -> per upsample stage [transposed conv (kernel k, stride
  u, padding (k - u) / 2), with no activation before it -> the mean of the
  AMPBlock1 branches] -> anti-aliased SnakeBeta -> conv_post (k 7, no bias)
  -> in f32, a clamp to [-1, 1].

AMPBlock1 is HiFi-GAN's ResBlock1 with each leaky ReLU replaced by an
anti-aliased SnakeBeta of its own: for each dilation d, x = conv2(act2(
conv1_d(act1(x)))) + x, six activations a block. The activation
(``AntiAliasedSnakeBeta``, ops/kernels/amp_act.py) is the fused kernel on
the card and its plain version on the CPU; each call runs under the span
``vocoder.act``. Each of the block's convs (``amp_conv``) runs under the
span ``vocoder.amp_conv``, without its bias: the activation that reads the
conv's output adds the bias, and the next residual too, x + conv2(...) +
bias, summed in f32 and rounded once, which it also writes out as the
block's next x. The block's last sum is left to the stage: ``amp_mean``
takes each block's parts (its last conv's raw output, that conv's bias,
its running x) and writes the stage's mean in one pass, summed in f32.
The dilated convs that cuDNN would run on CUDA cores run as a
dilation-free conv over time folded by the dilation (ops/dilated_conv.py,
whose ``folds`` picks them); ``amp_conv_calls`` counts the convs run and
``amp_conv_folded`` those folded. Convs and activations compute in the module's dtype (weights
and activations bf16 or f32; the activation works in f32 inside).

Layout, by dtype (``dilated_conv.channels_last_for``): in bf16 every signal
from conv_pre to conv_post lies in (B, T, C) memory (logical (B, C, T),
channels-last), every conv weight too, so cuDNN reads and writes them as
they lie and the activation's tile kernel reads rows of channels; in f32
they lie as (B, C, T), for cuDNN's NCHW f32 convs and the activation's row
kernel. The weights are laid out whenever the module's dtype or device is
set (``_apply``, which ``to`` goes through; names and shapes as a
Conv1d's).

State-dict names follow the HiFi-GAN Generator's (``ups_<i>``,
``resblocks_<n>.convs1_<j>``, ``convs2_<j>``) with
``resblocks_<n>.activations_<m>.{alpha,beta}`` and
``activation_post.{alpha,beta}``; the low-pass filter is a constant
(``amp_act.lowpass_filter``), no buffer. ``checkpoint.
convert_bigvgan_checkpoint`` maps NVIDIA's published layout onto these.

Mel (B, T, num_mels) natural-log in, waveform (B, T * prod(upsample_rates))
out.
"""

import torch
from torch import nn

from tts_king_torch.config import VocoderModelConfig
from tts_king_torch.models.hifigan import get_padding
from tts_king_torch.ops.dilated_conv import (conv1d, conv_transpose1d,
                                             dilated_conv1d, folds, lay_out_)
from tts_king_torch.ops.kernels import _build
from tts_king_torch.ops.kernels.amp_act import REACH, amp_act, amp_mean
from tts_king_torch.ops.streaming import generator_receptive_field
from tts_king_torch.utils.profiling import span

amp_conv_calls = 0    # AMP block convs run
amp_conv_folded = 0   # of them, run folded by their dilation


class AntiAliasedSnakeBeta(nn.Module):
    """Activation1d(SnakeBeta(channels, alpha_logscale=True)): 2x up,
    x + sin^2(x e^alpha) / (e^beta + 1e-9), 2x down; alpha and beta start
    at 0 (upstream's log-scale initialisation)."""

    def __init__(self, channels):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x, bias=None, residual=None):
        """The activation of x + bias + residual (``amp_act``): y, or (the
        sum, y) where a residual is given."""
        with span("vocoder.act"):
            if bias is None and residual is None:
                return amp_act(x, self.alpha, self.beta)
            if getattr(amp_act, "fuses_prologue", False):
                return amp_act(x, self.alpha, self.beta, bias, residual)
            # a stand-in of (x, alpha, beta), such as an activation without
            # anti-aliasing, gets the sum
            s = x if bias is None else x + bias[:, None]
            s = s if residual is None else s + residual
            y = amp_act(s, self.alpha, self.beta)
            return y if residual is None else (s, y)


def amp_conv(conv, x):
    """``conv(x)`` without its bias, for one of an AMP block's convs (an
    nn.Conv1d, stride 1, one group) on x in its dtype's layout, folded by its
    dilation where ``folds`` says, under the span ``vocoder.amp_conv``."""
    d = conv.dilation[0]
    fold = folds(conv.in_channels, conv.kernel_size[0], d, x.dtype)
    _build.count_launch(globals(), "amp_conv_calls")
    if fold:
        _build.count_launch(globals(), "amp_conv_folded")
    with span("vocoder.amp_conv"):
        if fold:
            return dilated_conv1d(x, conv.weight, None, d, conv.padding[0])
        return conv1d(x, conv.weight, None, conv.padding[0], d)


class AMPBlock1(nn.Module):
    """3 x [act -> dilated conv -> act -> conv] + skip, an activation of its
    own before each conv (bigvgan.py AMPBlock1)."""

    def __init__(self, channels, kernel_size=3, dilation=(1, 3, 5)):
        super().__init__()
        self.dilation = tuple(dilation)
        for i, d in enumerate(self.dilation):
            self.add_module(f"convs1_{i}", nn.Conv1d(
                channels, channels, kernel_size, dilation=d,
                padding=get_padding(kernel_size, d)))
            self.add_module(f"convs2_{i}", nn.Conv1d(
                channels, channels, kernel_size,
                padding=get_padding(kernel_size, 1)))
        for m in range(2 * len(self.dilation)):
            self.add_module(f"activations_{m}", AntiAliasedSnakeBeta(channels))

    def forward(self, x):
        """The block's output as its parts (a, bias, x): a its last conv's
        raw output, bias that conv's bias, x the running residual; the
        output is a + bias + x (``amp_mean`` adds them)."""
        # a: the last conv2's raw output, whose bias and residual x the next
        # activation adds (and returns the sum of, the next x)
        a = bias = None
        for i in range(len(self.dilation)):
            act1 = getattr(self, f"activations_{2 * i}")
            if a is None:
                xt = act1(x)
            else:
                x, xt = act1(a, bias, x)
            conv1 = getattr(self, f"convs1_{i}")
            xt = getattr(self, f"activations_{2 * i + 1}")(
                amp_conv(conv1, xt), conv1.bias)
            conv2 = getattr(self, f"convs2_{i}")
            a, bias = amp_conv(conv2, xt), conv2.bias
        return a, bias, x


class BigVGAN(nn.Module):
    """Mel (B, T, num_mels) -> waveform (B, T * prod(upsample_rates)) in
    [-1, 1]. Takes resblock "1" (every published BigVGAN-v2 config)."""

    def __init__(self, config: VocoderModelConfig):
        super().__init__()
        h = config
        if h.resblock != "1":
            raise ValueError(f"BigVGAN: resblock {h.resblock!r}; the port "
                             "runs AMPBlock1 (resblock '1')")
        self.config = h
        self.num_kernels = len(h.resblock_kernel_sizes)
        ch = h.upsample_initial_channel
        self.conv_pre = nn.Conv1d(h.num_mels, ch, 7, padding=3)
        for i, (u, k) in enumerate(zip(h.upsample_rates,
                                       h.upsample_kernel_sizes)):
            self.add_module(f"ups_{i}", nn.ConvTranspose1d(
                ch, ch // 2, k, stride=u, padding=(k - u) // 2))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(h.resblock_kernel_sizes,
                                             h.resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i * self.num_kernels + j}",
                                AMPBlock1(ch, rk, tuple(rd)))
        self.activation_post = AntiAliasedSnakeBeta(ch)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=False)
        lay_out_(self)

    def _apply(self, fn, recurse=True):
        """``nn.Module._apply`` (``to``, ``cuda``, ``bfloat16``,
        ``to_empty``), then each conv weight laid out for its new dtype."""
        return lay_out_(super()._apply(fn, recurse))

    @staticmethod
    def receptive_field(config):
        """One-sided receptive field in mel frames, with the filters' reach."""
        return generator_receptive_field(config, act_reach=REACH)

    def forward(self, mel, frames=None):
        """mel (B, T, num_mels) -> waveform (B, T * hop). frames (each
        item's real mel frames) is taken as the HiFi-GAN Generator takes
        it; every sample is computed all the same."""
        pre = self.conv_pre
        x = conv1d(mel.to(pre.weight.dtype).transpose(1, 2), pre.weight,
                   pre.bias, pre.padding[0])
        for i in range(len(self.config.upsample_rates)):
            ups = getattr(self, f"ups_{i}")
            x = conv_transpose1d(x, ups.weight, ups.bias, ups.stride[0],
                                 ups.padding[0])
            x = amp_mean([getattr(self, f"resblocks_{i * self.num_kernels + j}"
                                  )(x) for j in range(self.num_kernels)])
        x = conv1d(self.activation_post(x), self.conv_post.weight, None,
                   self.conv_post.padding[0]).float()
        return torch.clamp(x, -1.0, 1.0)[:, 0, :]
