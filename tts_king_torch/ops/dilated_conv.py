"""A dilated conv1d run as a dilation-free conv over time folded by the
dilation.

A conv over time with kernel k, dilation d and padding p = P d reads
``x[t + d j - p]`` for tap j. Write t = q d + r: then ``y[q d + r] =
sum_j w[j] x[(q + j - P) d + r]``, for each phase r a dilation-free conv
over q. So the same sums, in the same dtype, run as a (k, 1) conv2d with
padding (P, 0) over x (B, C, T') viewed as (B, C, T' / d, d), the weight
viewed as (C_out, C_in, k, 1), with no copy of either (``dilated_conv1d``).

Where T is no multiple of d the input is padded with zeros to T' = ceil(T
/ d) d and the first outputs kept (compacted into a contiguous tensor):
past T the dilated conv reads zeros too, so every kept output is the same
sum.

cuDNN runs the dilated convs whose taps span many samples on a CUDA-core
GEMM (implicit_convolve_sgemm) and the folded ones on tensor cores; which
convs fold is ``folds``' rule, from the conv's shape and dtype alone
(``scripts/probe_bigvgan.py`` times each both ways).
"""

import math

import torch
import torch.nn.functional as F


def folds(channels, kernel_size, dilation, dtype):
    """Whether a conv with ``channels`` in and out, ``kernel_size`` taps and
    ``dilation`` runs faster folded (``dilated_conv1d``) than as the dilated
    conv it is.

    In bf16, cuDNN runs a conv whose taps span 31 samples or more at 192
    channels or more on its CUDA-core GEMM, 9.5-15.5x slower than the folded
    conv on tensor cores; below 192 channels it picks a tensor-core kernel
    itself, and a conv that spans fewer samples runs on tensor cores. In
    f32 every dilated conv runs on the same f32 GEMM as the undilated ones,
    and folding gains nothing where it matters (PERF.md's probe table)."""
    return (dtype == torch.bfloat16 and channels >= 192
            and (kernel_size - 1) * dilation + 1 >= 31)


def dilated_conv1d(x, weight, bias, dilation, padding):
    """``F.conv1d(x, weight, bias, padding=padding, dilation=dilation)``
    (stride 1, one group) computed as a dilation-free (k, 1) conv2d over
    time folded by ``dilation``. ``padding`` must be a multiple of
    ``dilation``."""
    d = dilation
    if padding % d:
        raise ValueError(f"dilated_conv1d: padding {padding} is no multiple "
                         f"of the dilation {d}")
    B, C, T = x.shape
    k = weight.shape[-1]
    t_out = T + 2 * padding - d * (k - 1)
    q = math.ceil(T / d)
    if q * d != T:
        x = F.pad(x, (0, q * d - T))
    y = F.conv2d(x.view(B, C, q, d), weight.unsqueeze(-1), bias,
                 padding=(padding // d, 0))
    y = y.view(B, -1, y.shape[2] * d)
    # the kept outputs compacted here, a copy only where T is no multiple of
    # d: the next op (the activation kernel) reads a contiguous tensor
    return y[..., :t_out].contiguous()
