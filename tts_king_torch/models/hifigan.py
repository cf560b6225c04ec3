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
leaves them to XLA convs. The fused stages' taps and biases are packed once
into the kernel's layout (buffers ``mrf_<i>_{taps,biases}``, out of the
state dict): when the Generator is built, after every load_state_dict and
after every move or cast (the layout depends on the dtype); after changing
the weights in place, call ``repack()``.

mrf_backend="fused_int8" runs the same stages through the int8 MRF stage
(ops/kernels/mrf_int8.py) instead. Its taps, weight scales and biases are
quantized once from the f32 weights, when the Generator is built and after
every load_state_dict, into buffers in the kernel's layout that stay out of
the state dict (an int8 Generator loads exactly the checkpoints a fused one
does) and keep their dtypes through ``module.to(dtype)``. Load the weights
before casting the Generator; after changing them in place, call
``requantize()``. The packing factor r of each stage (which fixes the
quantization windows) depends on T and is computed at call time.

Activations are (B, C, T) inside; the public layout is mel (B, T, 80) in,
waveform (B, T * prod(upsample_rates)) out.
"""

import torch
import torch.nn.functional as F
from torch import nn

from tts_king_torch.config import VocoderModelConfig
from tts_king_torch.ops.kernels.mrf import (MAX_CHANNELS, MrfStagePacked,
                                            MrfStageWeights, mrf_stage,
                                            pack_stage)
from tts_king_torch.ops.kernels.mrf_int8 import (MrfStageInt8, mrf_stage_int8,
                                                 pack_factor,
                                                 quantize_mrf_stage)

LRELU_SLOPE = 0.1


# An int8 stage's buffers, in MrfStageInt8's field order.
_INT8_BUFFERS = ("taps", "scales", "biases", "kernel_taps")


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
    "fused_int8" runs them as one int8-quantized MRF stage.
    """

    def __init__(self, config: VocoderModelConfig, mrf_backend="fused"):
        super().__init__()
        if mrf_backend not in ("fused", "fused_int8"):
            raise ValueError(f"unknown mrf_backend {mrf_backend!r}")
        h = config
        self.config = h
        self.mrf_backend = mrf_backend
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
        if mrf_backend == "fused_int8":
            self.register_load_state_dict_post_hook(
                lambda module, _: module.requantize())
            self.requantize()
        else:
            self.register_load_state_dict_post_hook(
                lambda module, _: module.repack())
            self.repack()

    def _stage_blocks(self, i):
        return [getattr(self, f"resblocks_{i * self.num_kernels + j}")
                for j in range(self.num_kernels)]

    def _stage_channels(self, i):
        return self.config.upsample_initial_channel // (2 ** (i + 1))

    @torch.no_grad()
    def requantize(self):
        """Quantize every fused stage's f32 weights into the int8 buffers
        ``mrf_int8_<i>_{taps,scales,biases,kernel_taps}`` (the taps in the
        plain version's layout and in the CUDA kernel's), not part of the
        state dict. Raises for weights of another dtype: the quantization is
        defined on the f32 weights, so load them before casting the
        Generator."""
        for i in range(len(self.config.upsample_rates)):
            stage = self._fused_stage(self._stage_blocks(i),
                                      self._stage_channels(i))
            if stage is None:
                continue
            if any(w.dtype != torch.float32 for ws in stage.weights
                   for w in ws):
                raise TypeError("Generator(mrf_backend='fused_int8') "
                                "quantizes f32 weights: load the weights "
                                "before casting it")
            q = quantize_mrf_stage(stage)
            for name in _INT8_BUFFERS:
                self.register_buffer(f"mrf_int8_{i}_{name}", getattr(q, name),
                                     persistent=False)

    @torch.no_grad()
    def repack(self):
        """Pack every fused stage's weights, in their dtype and on their
        device, into the buffers ``mrf_<i>_{taps,biases}`` that the fused
        forward reads (not part of the state dict). Weights on the meta
        device are packed once they are materialized."""
        for i in range(len(self.config.upsample_rates)):
            stage = self._fused_stage(self._stage_blocks(i),
                                      self._stage_channels(i))
            if stage is None or stage.weights[0][0].is_meta:
                continue
            p = pack_stage(stage)
            self.register_buffer(f"mrf_{i}_taps", p.taps, persistent=False)
            self.register_buffer(f"mrf_{i}_biases", p.biases,
                                 persistent=False)

    def _packed_stage(self, i, stage: MrfStageWeights):
        """Stage i's packed buffers as an MrfStagePacked."""
        return MrfStagePacked(stage.kernel_sizes, stage.dilations,
                              self._stage_channels(i),
                              getattr(self, f"mrf_{i}_taps"),
                              getattr(self, f"mrf_{i}_biases"))

    def _int8_stage(self, i, stage: MrfStageWeights):
        """Stage i's int8 buffers as an MrfStageInt8."""
        return MrfStageInt8(stage.kernel_sizes, stage.dilations,
                            self._stage_channels(i),
                            *(getattr(self, f"mrf_int8_{i}_{name}")
                              for name in _INT8_BUFFERS))

    def _apply(self, fn, recurse=True):
        # nn.Module.to(dtype) casts every floating-point buffer; the int8
        # stages' f32 scales and biases keep their dtype and values and only
        # follow the module's device.
        keep = {n: b for n, b in self.named_buffers(recurse=False)
                if n.startswith("mrf_int8_") and b.is_floating_point()}
        super()._apply(fn, recurse)
        for n, b in keep.items():
            new = getattr(self, n)
            if new.dtype != b.dtype:
                setattr(self, n, b.to(new.device))
        if self.mrf_backend == "fused":
            self.repack()   # the packed layout depends on the dtype
        return self

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
            blocks = self._stage_blocks(i)
            stage = self._fused_stage(blocks, x.shape[1])
            if stage is not None and self.mrf_backend == "fused_int8":
                r = pack_factor(x.shape[1], x.shape[2])
                x = mrf_stage_int8(x.transpose(1, 2),
                                   self._int8_stage(i, stage),
                                   r).transpose(1, 2)
            elif stage is not None:
                x = mrf_stage(x.transpose(1, 2),
                              self._packed_stage(i, stage)).transpose(1, 2)
            else:
                acc = None
                for b in blocks:
                    out = b(x)
                    acc = out if acc is None else acc + out
                x = acc / self.num_kernels
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x.float())[:, 0, :]
