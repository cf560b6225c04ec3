"""HiFi-GAN: the Generator, for inference and for GAN training, and the
discriminators and losses of GAN training.

Port of tts_king_tpu/models/hifigan.py (reference hifi/models.py:146-407).
Generator: conv_pre(k=7) -> per upsample stage [leaky_relu(0.1) ->
transposed-conv upsample -> mean of the MRF ResBlocks] -> leaky_relu with
torch's default slope 0.01 (hifi/models.py:197) -> conv_post(k=7) -> tanh in
f32.

mrf_backend selects how the MRF stages run:

  * "fused" (the default, inference): every ResBlock1 stage of at most 128
    channels (with one dilation schedule shared by its branches) runs as one
    fused MRF stage (ops/kernels/mrf.py): the CUDA kernel on the card, its
    plain version on the CPU. Wider stages run their ResBlocks as plain
    nn.Conv1d, as the JAX package leaves them to XLA convs. The fused
    stages' taps and biases are packed once into the kernel's layout
    (buffers ``mrf_<i>_{taps,biases}``, out of the state dict): when the
    Generator is built, after every load_state_dict and after every move or
    cast (the layout depends on the dtype); after changing the weights in
    place, call ``repack()``.
  * "fused_int8" (inference): the same stages through the int8 MRF stage
    (ops/kernels/mrf_int8.py). Its taps, weight scales and biases are
    quantized once from the f32 weights, when the Generator is built and
    after every load_state_dict, into buffers in the kernel's layout that
    stay out of the state dict (an int8 Generator loads exactly the
    checkpoints a fused one does) and keep their dtypes through
    ``module.to(dtype)``. Load the weights before casting the Generator;
    after changing them in place, call ``requantize()``. The packing factor
    r of each stage (which fixes the quantization windows) depends on T and
    is computed at call time.
  * "plain" (training): every stage's ResBlocks as convs that autograd
    differentiates, the counterpart of the JAX package's "xla" backend, the
    only one it trains on. No packed buffers: an optimizer may change the
    weights in place.

``weight_norm=True`` (GAN training; only with "plain") keeps every conv as
the JAX package's weight-norm pair (WNConv, WNConvTranspose1d): parameters
v and g, kernel = g * v / sqrt(sum v^2 + 1e-12), one g per output channel of
a conv and per input channel of a transposed conv. ``compute_dtype`` (with
weight_norm) is the dtype the convs run in: the parameters and the fold stay
f32, x and the folded kernel are cast for each conv, tanh runs in f32.
``train.vocoder.export_inference_params`` folds the pairs into the state
dict of an inference Generator. The JAX package packs narrow stages
space-to-depth (``pack_small_channels``) for the TPU's 128-lane matrix unit;
that is a TPU lowering of the same function, and the port computes the
unpacked one.

Discriminators (GAN training): the multi-period discriminator (periods 2, 3,
5, 7, 11, weight-normed 2-D (k, 1) convs) and the 3-scale multi-scale
discriminator (scale 1 spectral-normed, scales 2-3 weight-normed, an
average-pool pyramid), with exactly the JAX call semantics: ``pair_batched``
runs each discriminator once on cat([y, y_hat]) (one power iteration per
call on the spectral-normed scale), else twice, d(y) then d(y_hat). Grouped
convs use native ``groups=``; the JAX package's block-diagonal lowering of
them is a TPU lowering of the same function. Layout is NCHW where the JAX
package's is NHWC: an MPD input is (B, 1, T/p, p), a feature map (B, C, H,
W). Each conv runs in the compute dtype, outputs are cast to f32 and
``feature_loss`` sums in f32.

Activations are (B, C, T) inside; the public layout is mel (B, T, 80) in,
waveform (B, T * prod(upsample_rates)) out.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from tts_king_torch.config import VocoderModelConfig
from tts_king_torch.ops.kernels.mrf import (MAX_CHANNELS, MrfStagePacked,
                                            MrfStageWeights, host_counts,
                                            mrf_stage, pack_stage)
from tts_king_torch.ops.kernels.mrf_int8 import (MrfStageInt8, mrf_stage_int8,
                                                 pack_factor,
                                                 quantize_mrf_stage)
from tts_king_torch.ops.streaming import generator_receptive_field

LRELU_SLOPE = 0.1


# An int8 stage's buffers, in MrfStageInt8's field order.
_INT8_BUFFERS = ("taps", "scales", "biases", "kernel_taps")


def get_padding(kernel_size, dilation=1):
    """Same-padding helper (hifi/vocoder/utils.py:33-36)."""
    return (kernel_size * dilation - dilation) // 2


WN_EPS = 1e-12


def fold_weight_norm(v, g):
    """g * v / sqrt(sum v^2 + 1e-12), the norm over every axis but the
    first (torch layout: a conv's output channels, a transposed conv's
    input channels), as the JAX package folds it."""
    axes = tuple(range(1, v.dim()))
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True) + WN_EPS)
    return g.view(-1, *[1] * (v.dim() - 1)) * v / norm


def _conv_nd(x, weight, bias, stride, padding, dilation, groups):
    """F.conv1d or F.conv2d by the weight's rank, in x's dtype."""
    conv = F.conv1d if weight.dim() == 3 else F.conv2d
    return conv(x, weight.to(x.dtype), bias.to(x.dtype), stride, padding,
                dilation, groups)


class WNConv(nn.Module):
    """A 1-D or 2-D conv (by the length of ``kernel_size``) with the weight
    norm of the JAX package's TorchConv1d(weight_norm=True) and WNConv:
    parameters v (torch layout (out, in / groups, *k)), g (out,) and bias;
    the kernel is ``fold_weight_norm(v, g)``, folded in the parameters'
    dtype. The conv runs in x's dtype (the compute dtype)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1):
        super().__init__()
        kernel_size = tuple(kernel_size)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.v = nn.Parameter(torch.empty(out_channels,
                                          in_channels // groups,
                                          *kernel_size))
        self.g = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    @property
    def weight(self):
        return fold_weight_norm(self.v, self.g)

    def forward(self, x):
        return _conv_nd(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class WNConvTranspose1d(nn.Module):
    """ConvTranspose1d with the JAX package's weight norm
    (TorchConvTranspose1d(weight_norm=True)): v in torch layout (Cin, Cout,
    k), one g per *input* channel. Runs in x's dtype."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.v = nn.Parameter(torch.empty(in_channels, out_channels,
                                          kernel_size))
        self.g = nn.Parameter(torch.ones(in_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    @property
    def weight(self):
        return fold_weight_norm(self.v, self.g)

    def forward(self, x):
        return F.conv_transpose1d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.stride,
                                  self.padding)


def _conv1d_factory(weight_norm):
    """(in, out, k, dilation=, padding=) -> a Conv1d or a WNConv."""
    if not weight_norm:
        return nn.Conv1d
    return lambda i, o, k, dilation=1, padding=0: WNConv(
        i, o, (k,), padding=padding, dilation=dilation)


class ResBlock1(nn.Module):
    """MRF residual stack: 3x [lrelu -> dilated conv -> lrelu -> conv(d=1)]
    + skip (hifi/models.py:12-101)."""

    def __init__(self, channels, kernel_size=3, dilation=(1, 3, 5),
                 weight_norm=False):
        super().__init__()
        conv = _conv1d_factory(weight_norm)
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        for i, d in enumerate(self.dilation):
            self.add_module(f"convs1_{i}", conv(
                channels, channels, kernel_size, dilation=d,
                padding=get_padding(kernel_size, d)))
            self.add_module(f"convs2_{i}", conv(
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

    def __init__(self, channels, kernel_size=3, dilation=(1, 3),
                 weight_norm=False):
        super().__init__()
        conv = _conv1d_factory(weight_norm)
        self.dilation = tuple(dilation)
        for i, d in enumerate(self.dilation):
            self.add_module(f"convs_{i}", conv(
                channels, channels, kernel_size, dilation=d,
                padding=get_padding(kernel_size, d)))

    def forward(self, x):
        for i in range(len(self.dilation)):
            x = getattr(self, f"convs_{i}")(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


def needed_rows(config, frames, rate, T):
    """Per item, the rows of a stage at ``rate`` rows a frame (T rows) that
    samples [0, frames[b] * hop) depend on: those below (frames[b] + R) *
    rate. R (Generator.receptive_field) is the whole generator's one-sided
    reach in frames, so the layers after the stage carry a row's value less
    than R frames back: whatever a row past the bound holds (zeros, or what
    later rows make of such rows), no delivered sample changes."""
    R = Generator.receptive_field(config)
    return [min(T, (f + R) * rate) for f in frames]


class Generator(nn.Module):
    """Mel (B, T, num_mels) -> waveform (B, T * prod(upsample_rates)) in [-1, 1].

    mrf_backend: "fused" runs eligible stages as one fused MRF stage;
    "fused_int8" runs them as one int8-quantized MRF stage; "plain" runs
    every stage's ResBlocks as differentiable convs (training).
    weight_norm (with "plain" only): every conv as a (v, g) weight-norm
    pair. compute_dtype (with weight_norm only): the dtype the convs run in,
    the parameters' by default.
    """

    @staticmethod
    def receptive_field(config):
        """One-sided receptive field in mel frames (leaky ReLUs: no reach)."""
        return generator_receptive_field(config, act_reach=0)

    def __init__(self, config: VocoderModelConfig, mrf_backend="fused",
                 weight_norm=False, compute_dtype=None):
        super().__init__()
        if mrf_backend not in ("fused", "fused_int8", "plain"):
            raise ValueError(
                f"unknown mrf_backend {mrf_backend!r}: 'fused' or "
                "'fused_int8' (inference, the MRF kernels) or 'plain' (the "
                "differentiable route that GAN training runs, the JAX "
                "package's 'xla')")
        if weight_norm and mrf_backend != "plain":
            raise ValueError(
                "weight_norm=True trains on mrf_backend='plain'; fold the "
                "weights (train.vocoder.export_inference_params) into a "
                f"Generator(mrf_backend={mrf_backend!r}) for inference")
        if compute_dtype is not None and not weight_norm:
            raise ValueError("compute_dtype is a setting of the weight-norm "
                             "Generator; cast an inference Generator instead")
        h = config
        self.config = h
        self.mrf_backend = mrf_backend
        self.weight_norm = weight_norm
        self.compute_dtype = compute_dtype
        self.num_kernels = len(h.resblock_kernel_sizes)
        resblock_cls = ResBlock1 if h.resblock == "1" else ResBlock2
        conv = _conv1d_factory(weight_norm)
        up_conv = WNConvTranspose1d if weight_norm else nn.ConvTranspose1d
        ch0 = h.upsample_initial_channel
        self.conv_pre = conv(h.num_mels, ch0, 7, padding=3)
        for i, (u, k) in enumerate(zip(h.upsample_rates,
                                       h.upsample_kernel_sizes)):
            ch = ch0 // (2 ** (i + 1))
            self.add_module(f"ups_{i}", up_conv(
                ch0 // (2 ** i), ch, k, stride=u, padding=(k - u) // 2))
            for j, (rk, rd) in enumerate(zip(h.resblock_kernel_sizes,
                                             h.resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i * self.num_kernels + j}",
                                resblock_cls(ch, rk, tuple(rd),
                                             weight_norm=weight_norm))
        self.conv_post = conv(ch0 // (2 ** len(h.upsample_rates)), 1, 7,
                              padding=3)
        if mrf_backend == "fused_int8":
            self.register_load_state_dict_post_hook(
                lambda module, _: module.requantize())
            self.requantize()
        elif mrf_backend == "fused":
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
        if (self.mrf_backend == "plain" or self.config.resblock != "1"
                or channels > MAX_CHANNELS
                or any(tuple(b.dilation) != dil0 for b in blocks)):
            return None
        chains = [b.chain() for b in blocks]
        return MrfStageWeights(
            kernel_sizes=[b.kernel_size for b in blocks], dilations=dil0,
            weights=[[c.weight for c in ch] for ch in chains],
            biases=[[c.bias for c in ch] for ch in chains])

    def forward(self, mel, frames=None):
        """mel (B, T, num_mels) -> waveform (B, T * hop). frames: None, or
        each item's real mel frames as host integers (a list, numpy or a
        CPU tensor). With frames the fused bf16 MRF stages compute only the
        rows that samples [0, frames[b] * hop) depend on: those samples are
        exactly as without frames, the ones past them are not."""
        if frames is not None:
            frames = host_counts(frames, mel.shape[0], mel.shape[1],
                                 "Generator: frames")
        dtype = (self.compute_dtype
                 or next(self.conv_pre.parameters()).dtype)
        x = self.conv_pre(mel.to(dtype).transpose(1, 2))
        rate = 1
        for i, u in enumerate(self.config.upsample_rates):
            rate *= u
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            blocks = self._stage_blocks(i)
            stage = self._fused_stage(blocks, x.shape[1])
            if stage is not None and self.mrf_backend == "fused_int8":
                r = pack_factor(x.shape[1], x.shape[2])
                x = mrf_stage_int8(x.transpose(1, 2),
                                   self._int8_stage(i, stage),
                                   r).transpose(1, 2)
            elif stage is not None:
                rows = (None if frames is None else needed_rows(
                    self.config, frames, rate, x.shape[2]))
                x = mrf_stage(x.transpose(1, 2), self._packed_stage(i, stage),
                              rows).transpose(1, 2)
            else:
                acc = None
                for b in blocks:
                    out = b(x)
                    acc = out if acc is None else acc + out
                x = acc / self.num_kernels
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x.float())[:, 0, :]


# ------------------------------------------------------------ discriminators


class SNConv(nn.Module):
    """A 1-D or 2-D conv with torch's spectral_norm(dim=0) as the JAX
    package's SNConv reproduces it (n_power_iterations=1, eps=1e-12):
    parameters weight_orig (torch layout (out, in / groups, *k)) and bias;
    persistent buffers u (out,) and v (fan_in,), the power iteration's
    vectors, which an optimizer never touches.

    With ``update``, one power iteration under no_grad on the matrix
    ``weight_orig.reshape(out, -1)``: v <- W^T u / max(||W^T u||, eps),
    u <- W v / max(||W v||, eps), written into the buffers; then (with or
    without it) sigma = u^T (W v), differentiable in W, and the kernel is
    weight_orig / sigma. The conv runs in x's dtype; the iteration in the
    parameters'."""

    EPS = 1e-12

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1):
        super().__init__()
        kernel_size = tuple(kernel_size)
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight_orig = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        fan_in = (in_channels // groups) * math.prod(kernel_size)
        self.register_buffer("u", torch.empty(out_channels))
        self.register_buffer("v", torch.empty(fan_in))

    def forward(self, x, update=False):
        w = self.weight_orig
        mat = w.reshape(w.shape[0], -1)
        if update:
            with torch.no_grad():
                v = mat.t() @ self.u
                v = v / torch.clamp(torch.linalg.vector_norm(v), min=self.EPS)
                u = mat @ v
                u = u / torch.clamp(torch.linalg.vector_norm(u), min=self.EPS)
                self.u.copy_(u)
                self.v.copy_(v)
        else:
            # copies: a later update writes the buffers in place, and
            # autograd keeps these for the backward
            u, v = self.u.clone(), self.v.clone()
        sigma = u @ (mat @ v)
        return _conv_nd(x, w / sigma, self.bias, self.stride, self.padding,
                        1, self.groups)


class DiscriminatorP(nn.Module):
    """Period discriminator (hifi/models.py:213-282): the waveform reflect-
    padded to a multiple of the period and folded to (B, 1, T/p, p), then
    weight-normed (k, 1) convs. Returns (scores (B, n) in f32, feature
    maps in the compute dtype)."""

    def __init__(self, period, kernel_size=5, stride=3,
                 channels=(32, 128, 512, 1024, 1024), compute_dtype=None):
        super().__init__()
        self.period = period
        self.compute_dtype = compute_dtype
        self.n_convs = len(channels)
        in_ch = 1
        for i, ch in enumerate(channels):
            last = i == len(channels) - 1
            self.add_module(f"convs_{i}", WNConv(
                in_ch, ch, (kernel_size, 1),
                stride=(1, 1) if last else (stride, 1), padding=(2, 0)))
            in_ch = ch
        self.conv_post = WNConv(in_ch, 1, (3, 1), padding=(1, 0))

    def forward(self, x):
        B, T = x.shape
        if T % self.period:
            n_pad = self.period - T % self.period
            x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
            T += n_pad
        x = x.reshape(B, 1, T // self.period, self.period)
        x = x.to(self.compute_dtype or x.dtype)
        fmap = []
        for i in range(self.n_convs):
            x = F.leaky_relu(getattr(self, f"convs_{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(B, -1).float(), fmap


# DiscriminatorS's convs: (channels at width 1, kernel, stride, groups,
# padding), hifi/models.py:313-340.
_MSD_SPECS = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
              (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20),
              (1024, 41, 1, 16, 20), (1024, 5, 1, 1, 2))


class DiscriminatorS(nn.Module):
    """Scale discriminator (hifi/models.py:313-340). ``width`` divides every
    channel count (narrow test configurations; a group count is cut to the
    gcd of itself and the conv's channel counts). The first MSD scale is
    spectral-normed on every conv, the pooled ones weight-normed
    (hifi/models.py:317,349)."""

    def __init__(self, width=1, use_spectral_norm=False, compute_dtype=None):
        super().__init__()
        self.use_spectral_norm = use_spectral_norm
        self.compute_dtype = compute_dtype
        conv = SNConv if use_spectral_norm else WNConv
        in_ch = 1
        for i, (ch, k, s, g, p) in enumerate(_MSD_SPECS):
            ch //= width
            g = math.gcd(g, math.gcd(in_ch, ch))
            self.add_module(f"convs_{i}", conv(in_ch, ch, (k,), stride=s,
                                               padding=p, groups=g))
            in_ch = ch
        self.conv_post = conv(in_ch, 1, (3,), padding=1)

    def _conv(self, conv, h, update_sn):
        return conv(h, update=update_sn) if self.use_spectral_norm else conv(h)

    def forward(self, x, update_sn=False):
        h = x[:, None].to(self.compute_dtype or x.dtype)
        fmap = []
        for i in range(len(_MSD_SPECS)):
            h = F.leaky_relu(self._conv(getattr(self, f"convs_{i}"), h,
                                        update_sn), LRELU_SLOPE)
            fmap.append(h)
        h = self._conv(self.conv_post, h, update_sn)
        fmap.append(h)
        return h.reshape(h.shape[0], -1).float(), fmap


def _call_pair(d, y, y_hat, pair_batched, **kw):
    """(score_r, score_g, fmap_r, fmap_g) of one discriminator: one call on
    cat([y, y_hat]) when ``pair_batched``, else d(y) then d(y_hat)."""
    if pair_batched:
        B = y.shape[0]
        o, fmaps = d(torch.cat([y, y_hat], 0), **kw)
        return o[:B], o[B:], [f[:B] for f in fmaps], [f[B:] for f in fmaps]
    r, fmap_r = d(y, **kw)
    g, fmap_g = d(y_hat, **kw)
    return r, g, fmap_r, fmap_g


def _collect(results):
    """Per-discriminator 4-tuples -> (rs, gs, fmap_rs, fmap_gs) lists."""
    return tuple(list(col) for col in zip(*results))


class MultiPeriodDiscriminator(nn.Module):
    """DiscriminatorP per period, modules ``disc_p<p>``. forward(y, y_hat)
    -> (scores of y, scores of y_hat, fmaps of y, fmaps of y_hat), one entry
    per period; ``pair_batched`` runs each once on cat([y, y_hat])."""

    def __init__(self, periods=(2, 3, 5, 7, 11),
                 channels=(32, 128, 512, 1024, 1024), compute_dtype=None):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"disc_p{p}", DiscriminatorP(
                p, channels=tuple(channels), compute_dtype=compute_dtype))

    def forward(self, y, y_hat, pair_batched=False):
        return _collect(_call_pair(getattr(self, f"disc_p{p}"), y, y_hat,
                                   pair_batched) for p in self.periods)


class MultiScaleDiscriminator(nn.Module):
    """DiscriminatorS per scale, modules ``disc_s<i>``: scale 0 on the
    waveform, spectral-normed; each later one on the previous scale's input
    average-pooled (4, 2, 2), weight-normed (hifi/models.py:343-374).
    ``update_sn`` runs the spectral-normed scale's power iteration once per
    call: once per forward when pair-batched, else on d(y) then on
    d(y_hat)."""

    def __init__(self, n_scales=3, width=1, compute_dtype=None):
        super().__init__()
        self.n_scales = n_scales
        for i in range(n_scales):
            self.add_module(f"disc_s{i}", DiscriminatorS(
                width=width, use_spectral_norm=(i == 0),
                compute_dtype=compute_dtype))

    def forward(self, y, y_hat, update_sn=False, pair_batched=False):
        out = []
        for i in range(self.n_scales):
            if i:
                y, y_hat = avg_pool1d(y), avg_pool1d(y_hat)
            out.append(_call_pair(getattr(self, f"disc_s{i}"), y, y_hat,
                                  pair_batched, update_sn=update_sn))
        return _collect(out)


def avg_pool1d(x, kernel=4, stride=2, padding=2):
    """torch AvgPool1d(count_include_pad=True) over (B, T), the JAX
    package's _avg_pool1d."""
    return F.avg_pool1d(x[:, None], kernel, stride, padding,
                        count_include_pad=True)[:, 0]


def feature_loss(fmap_r, fmap_g):
    """L1 feature matching x 2 (hifi/models.py:377-383), summed in f32
    whatever the discriminators' compute dtype."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.float() - gl.float()))
    return loss * 2.0


def discriminator_loss(disc_real, disc_gen):
    """LSGAN discriminator loss (hifi/models.py:386-397): (total, the real
    terms, the generated terms)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r = torch.mean((1.0 - dr) ** 2)
        g = torch.mean(dg ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LSGAN generator loss (hifi/models.py:400-407): (total, per term)."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        term = torch.mean((1.0 - dg) ** 2)
        gen_losses.append(term)
        loss = loss + term
    return loss, gen_losses
