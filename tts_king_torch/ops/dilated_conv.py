"""Convs over time on BigVGAN's (B, C, T) signals, laid out in memory by
their dtype, and a dilated conv1d run as a dilation-free conv over time
folded by the dilation.

Layout (``channels_last_for``). bf16 signals lie channels-last: logical
shape (B, C, T), strides (S, 1, C) with S >= T C (a batch stride past T C
leaves rows unused, as a compacted fold does). A conv over time is then a
(1, k) conv2d on the 4-D view (B, C, 1, T), which PyTorch takes as
channels-last (NHWC with H = 1, W = T), so cuDNN reads and writes the
signals as they lie, with no NCHW<->NHWC transposes around it; the weight
lies channels-last too, (C_out, k, C_in) memory for a conv and (C_in, k,
C_out) for a transposed conv. f32 signals and weights lie as (B, C, T)
(contiguous), and the convs are F.conv1d's: cuDNN's f32 convs are NCHW
kernels, which transpose channels-last tensors around each call.
``lay_out_`` sets a module's conv weights in their dtype's layout; any
other weight is copied to it at each call.

Fold. A conv over time with kernel k, dilation d and padding p = P d reads
``x[t + d j - p]`` for tap j. Write t = q d + r: then ``y[q d + r] =
sum_j w[j] x[(q + j - P) d + r]``, for each phase r a dilation-free conv
over q. In (B, T, C) memory, (B, T' / d, d, C) is a view: NHWC with H = T'
/ d and W = d, so the same sums, in the same dtype, run as a (k, 1) conv2d
with padding (P, 0) over that view, the weight viewed as (C_out, C_in, k,
1), with no copy of either (``dilated_conv1d``). Where T is no multiple of
d the input is padded with zeros to T' = ceil(T / d) d (past T the dilated
conv reads zeros too, so every kept output is the same sum); the first
outputs are kept, a prefix of each item's rows in this layout, so no copy.

cuDNN runs some dilated convs on a CUDA-core GEMM and their folds on tensor
cores; which convs fold is ``folds``' rule, from the conv's shape and dtype
alone (``scripts/probe_bigvgan.py`` times each way).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def folds(channels, kernel_size, dilation, dtype):
    """Whether a conv with ``channels`` in and out, ``kernel_size`` taps and
    ``dilation`` runs faster folded (``dilated_conv1d``) than as the dilated
    conv it is, each in its dtype's layout.

    In bf16, cuDNN's channels-last kernels run a conv whose taps span 31
    samples or more at 192 channels or more 350-1,100x slower than the
    folded conv at B 32, T_mel 1000 (1,078-3,366 ms against 1.5-4.8), and
    ~20-30x slower at 192 channels in a B-1 streaming window, where the
    fold loses 0.1-0.2 ms at 384-768 channels; below 192 channels, and
    below 31 samples, they run on tensor cores unfolded. In f32 every
    dilated conv runs as fast as its undilated sibling, NCHW as
    channels-last, and folding gains nothing (PERF.md's probe table)."""
    return (dtype == torch.bfloat16 and channels >= 192
            and (kernel_size - 1) * dilation + 1 >= 31)


def channels_last(x):
    """(B, C, T) ``x`` in (B, T, C) memory: ``x`` itself where it lies so
    (any batch stride), else a copy."""
    if x.stride(1) == 1 and (x.shape[2] < 2 or x.stride(2) == x.shape[1]):
        return x
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def channels_last_for(dtype):
    """Whether BigVGAN's signals and conv weights of ``dtype`` lie in (B, T,
    C) memory (else (B, C, T)): bf16 only. In bf16, cuDNN's channels-last
    convs need no transposes and the activation's tile kernel reads rows of
    channels; in f32, cuDNN's convs are NCHW kernels that transpose a
    channels-last signal in and out (91 ms of a B-32 call), and the
    activation's row kernel on (B, C, T) runs 4x faster than the tile
    kernel (PERF.md's probe table)."""
    return dtype == torch.bfloat16


def laid_out(x):
    """(B, C, T) ``x`` (or a conv weight) in its dtype's layout
    (``channels_last_for``): ``x`` itself where it lies so, else a copy."""
    return channels_last(x) if channels_last_for(x.dtype) else x.contiguous()


def lay_out_(module):
    """Lay every Conv1d and ConvTranspose1d weight in ``module`` out in its
    dtype's layout, in place (shapes, names and values unchanged;
    ``load_state_dict`` keeps the layout). Returns ``module``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            m.weight.data = laid_out(m.weight.data)
    return module


def conv1d(x, weight, bias=None, padding=0, dilation=1):
    """``F.conv1d(x, weight, bias, padding=padding, dilation=dilation)``
    (stride 1, one group) on ``x`` in its dtype's layout: channels-last, a
    (1, k) conv2d on the 4-D view; the output lies as ``x``'s dtype
    says."""
    if not channels_last_for(x.dtype):
        return F.conv1d(x.contiguous(), weight.contiguous(), bias,
                        padding=padding, dilation=dilation)
    return F.conv2d(channels_last(x).unsqueeze(2),
                    channels_last(weight).unsqueeze(2), bias,
                    padding=(0, padding), dilation=(1, dilation)).squeeze(2)


def conv_transpose1d(x, weight, bias, stride, padding):
    """``F.conv_transpose1d(x, weight, bias, stride, padding)`` on ``x`` in
    its dtype's layout: channels-last, a (1, k) transposed conv2d on the
    4-D view; the output lies as ``x``'s dtype says."""
    if not channels_last_for(x.dtype):
        return F.conv_transpose1d(x.contiguous(), weight.contiguous(), bias,
                                  stride=stride, padding=padding)
    return F.conv_transpose2d(channels_last(x).unsqueeze(2),
                              channels_last(weight).unsqueeze(2), bias,
                              stride=(1, stride),
                              padding=(0, padding)).squeeze(2)


def dilated_conv1d(x, weight, bias, dilation, padding):
    """``F.conv1d(x, weight, bias, padding=padding, dilation=dilation)``
    (stride 1, one group) computed as a dilation-free (k, 1) conv2d over
    time folded by ``dilation``, channels-last; the output lies as
    ``x``'s dtype says, channels-last with a batch stride of the folded
    length. ``padding`` must be a multiple of ``dilation``."""
    d = dilation
    if padding % d:
        raise ValueError(f"dilated_conv1d: padding {padding} is no multiple "
                         f"of the dilation {d}")
    B, C, T = x.shape
    k = weight.shape[-1]
    t_out = T + 2 * padding - d * (k - 1)
    q = math.ceil(T / d)
    xt = channels_last(x).transpose(1, 2)           # (B, T, C)
    if q * d != T:
        xt = F.pad(xt, (0, 0, 0, q * d - T))
    y = F.conv2d(xt.reshape(B, q, d, C).permute(0, 3, 1, 2),
                 channels_last(weight).unsqueeze(-1), bias,
                 padding=(padding // d, 0))
    y = y.permute(0, 2, 3, 1)                       # (B, q_out, d, C_out)
    y = y.reshape(B, -1, y.shape[-1]).transpose(1, 2)
    return laid_out(y[..., :t_out])
