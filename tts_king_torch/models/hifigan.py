"""HiFi-GAN generator, inference only.

Port of the Generator of tts_king_tpu/models/hifigan.py (reference
hifi/models.py:146-201): conv_pre(k=7) -> per upsample stage [leaky_relu(0.1)
-> transposed-conv upsample -> mean of the MRF ResBlocks] -> leaky_relu with
torch's default slope 0.01 (hifi/models.py:197) -> conv_post(k=7) -> tanh in
f32. Weight normalization is folded into plain weights at conversion time.

The JAX package packs narrow stages space-to-depth for the TPU's 128-lane
matrix unit; that is a TPU lowering, and the port computes the unpacked
function. Every ResBlock1 stage of at most 128 channels (with one dilation
schedule shared by its branches) runs as one fused MRF stage
(ops/kernels/mrf.py): the CUDA kernel on the card, its plain version on the
CPU. Wider stages run their ResBlocks as plain nn.Conv1d, as the JAX package
leaves them to XLA convs.

Activations are (B, C, T) inside; the public layout is mel (B, T, 80) in,
waveform (B, T * prod(upsample_rates)) out.
"""

import torch
import torch.nn.functional as F
from torch import nn

from tts_king_torch.config import VocoderModelConfig
from tts_king_torch.ops.kernels.mrf import (MAX_CHANNELS, MrfStageWeights,
                                            mrf_stage)

LRELU_SLOPE = 0.1


def get_padding(kernel_size, dilation=1):
    """Same-padding helper (hifi/vocoder/utils.py:33-36)."""
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    """MRF residual stack: 3x [lrelu -> dilated conv -> lrelu -> conv(d=1)]
    + skip (hifi/models.py:12-101)."""

    def __init__(self, channels, kernel_size=3, dilation=(1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        for i, d in enumerate(self.dilation):
            self.add_module(f"convs1_{i}", nn.Conv1d(
                channels, channels, kernel_size, dilation=d,
                padding=get_padding(kernel_size, d)))
            self.add_module(f"convs2_{i}", nn.Conv1d(
                channels, channels, kernel_size,
                padding=get_padding(kernel_size, 1)))

    def chain(self):
        """Conv modules in chain order [convs1_0, convs2_0, convs1_1, ...]."""
        return [getattr(self, f"convs{g}_{i}")
                for i in range(len(self.dilation)) for g in (1, 2)]

    def forward(self, x):
        for i in range(len(self.dilation)):
            xt = getattr(self, f"convs1_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            xt = getattr(self, f"convs2_{i}")(F.leaky_relu(xt, LRELU_SLOPE))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    """Lighter variant: 2x [lrelu -> dilated conv] + skip
    (hifi/models.py:104-143)."""

    def __init__(self, channels, kernel_size=3, dilation=(1, 3)):
        super().__init__()
        self.dilation = tuple(dilation)
        for i, d in enumerate(self.dilation):
            self.add_module(f"convs_{i}", nn.Conv1d(
                channels, channels, kernel_size, dilation=d,
                padding=get_padding(kernel_size, d)))

    def forward(self, x):
        for i in range(len(self.dilation)):
            x = getattr(self, f"convs_{i}")(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class Generator(nn.Module):
    """Mel (B, T, num_mels) -> waveform (B, T * prod(upsample_rates)) in [-1, 1].

    mrf_backend: "fused" runs eligible stages as one fused MRF stage;
    "fused_int8" (int8-quantized stages) is not ported yet.
    """

    def __init__(self, config: VocoderModelConfig, mrf_backend="fused"):
        super().__init__()
        if mrf_backend == "fused_int8":
            raise NotImplementedError(
                "mrf_backend='fused_int8' is not ported yet; it comes in a "
                "later slice of the port")
        if mrf_backend != "fused":
            raise ValueError(f"unknown mrf_backend {mrf_backend!r}")
        h = config
        self.config = h
        self.num_kernels = len(h.resblock_kernel_sizes)
        resblock_cls = ResBlock1 if h.resblock == "1" else ResBlock2
        ch0 = h.upsample_initial_channel
        self.conv_pre = nn.Conv1d(h.num_mels, ch0, 7, padding=3)
        for i, (u, k) in enumerate(zip(h.upsample_rates,
                                       h.upsample_kernel_sizes)):
            ch = ch0 // (2 ** (i + 1))
            self.add_module(f"ups_{i}", nn.ConvTranspose1d(
                ch0 // (2 ** i), ch, k, stride=u, padding=(k - u) // 2))
            for j, (rk, rd) in enumerate(zip(h.resblock_kernel_sizes,
                                             h.resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i * self.num_kernels + j}",
                                resblock_cls(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch0 // (2 ** len(h.upsample_rates)), 1, 7,
                                   padding=3)

    def _fused_stage(self, blocks, channels):
        """The stage's weights for mrf_stage, or None when it is not fused."""
        dil0 = tuple(blocks[0].dilation)
        if (self.config.resblock != "1" or channels > MAX_CHANNELS
                or any(tuple(b.dilation) != dil0 for b in blocks)):
            return None
        chains = [b.chain() for b in blocks]
        return MrfStageWeights(
            kernel_sizes=[b.kernel_size for b in blocks], dilations=dil0,
            weights=[[c.weight for c in ch] for ch in chains],
            biases=[[c.bias for c in ch] for ch in chains])

    def forward(self, mel):
        dtype = self.conv_pre.weight.dtype
        x = self.conv_pre(mel.to(dtype).transpose(1, 2))
        for i in range(len(self.config.upsample_rates)):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            blocks = [getattr(self, f"resblocks_{i * self.num_kernels + j}")
                      for j in range(self.num_kernels)]
            stage = self._fused_stage(blocks, x.shape[1])
            if stage is not None:
                x = mrf_stage(x.transpose(1, 2), stage).transpose(1, 2)
            else:
                acc = None
                for b in blocks:
                    out = b(x)
                    acc = out if acc is None else acc + out
                x = acc / self.num_kernels
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x.float())[:, 0, :]
