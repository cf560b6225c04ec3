"""BigVGAN's anti-aliased SnakeBeta activation: the CUDA kernel
(``csrc/amp_act.cu``) and its plain PyTorch version.

No kernel of the JAX package computes it (the JAX package has no BigVGAN);
BigVGAN-v2 (arXiv:2206.04658; NVIDIA/BigVGAN activations.py and
alias_free_activation/torch/{act,filter,resample}.py) defines it, per
channel of a (B, C, T) tensor:

  up 2x    replicate-pad 5 on each side, depthwise conv_transpose1d with
           stride 2 and the 12-tap ``lowpass_filter()``, times 2, crop 15
           on each side: length 2T;
  snake    s = u + sin^2(u e^alpha) / (e^beta + 1e-9), alpha and beta one
           log-scale value each per channel;
  down 2x  replicate-pad 5 on the left and 6 on the right, depthwise conv1d
           with the same filter, stride 2: length T.

The wrapper (``amp_act``) also takes the activation's input as a sum: a
conv's raw output, the conv's bias and a residual, summed in f32 (the AMP
block's convs run without their bias, and its residual adds ride on the
activation that follows them). Signals lie in memory as BigVGAN holds them,
by dtype (``dilated_conv.channels_last_for``): bf16 in (B, T, C), f32 in
(B, C, T). It dispatches on where x lies: CPU tensors go to
``amp_act_plain`` on the sum; CUDA tensors launch the kernel for their
dtype's layout (bf16 the tile kernel, f32 the row kernel), or raise.
``launches`` counts the kernel's launches, ``elements`` the base-rate
elements they took in (B x C x T each), ``bias_in`` the launches that took
a bias and ``residual_in`` those that took a residual; a CPU call or an
empty tensor launches nothing and counts nothing.
"""

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from tts_king_torch.ops.dilated_conv import channels_last_for, laid_out
from tts_king_torch.ops.kernels import _build

TAPS = 12
CUTOFF = 0.25       # 0.5 / ratio, ratio 2
HALF_WIDTH = 0.3    # 0.6 / ratio
EPS = 1e-9          # SnakeBeta's no_div_by_zero
REACH = 5           # the filters' one-sided reach: y[t] reads x[t-5 .. t+5]
launches = 0
elements = 0
bias_in = 0         # launches that added a conv's bias
residual_in = 0     # launches that added a residual (and stored the sum)
mean_launches = 0   # amp_mean's launches


def kaiser_beta():
    """The Kaiser window's beta (kaiser_sinc_filter1d's rule for A > 50):
    A = 2.285 (taps/2 - 1) pi 4 half_width + 7.95 = 51.02, beta = 0.1102
    (A - 8.7) = 4.6638."""
    A = 2.285 * (TAPS // 2 - 1) * math.pi * 4 * HALF_WIDTH + 7.95
    return 0.1102 * (A - 8.7)


@functools.lru_cache(maxsize=None)
def _taps():
    """The filter's taps as Python floats (the f32 values), worked out once:
    2 cutoff x a symmetric Kaiser window x sinc(2 cutoff t) at t = -5.5 ..
    5.5 (sinc normalised), divided by its sum; upstream's
    ``kaiser_sinc_filter1d(0.25, 0.3, 12)`` in its order of operations."""
    window = torch.kaiser_window(TAPS, beta=kaiser_beta(), periodic=False)
    z = 2 * CUTOFF * (torch.arange(-(TAPS // 2), TAPS // 2) + 0.5)
    f = 2 * CUTOFF * window * (torch.sin(math.pi * z) / math.pi / z)
    return tuple((f / f.sum()).tolist())


def lowpass_filter():
    """The 12 taps, f32 on the CPU."""
    return torch.tensor(_taps(), dtype=torch.float32)


def amp_act_plain(x, alpha, beta):
    """The activation in PyTorch ops, f32 inside; x (B, C, T) in any float
    dtype, alpha and beta (C,) log-scale. Returns x's shape and dtype."""
    h = x.float()
    C = h.shape[1]
    w = lowpass_filter().to(h.device).view(1, 1, TAPS).expand(C, 1, TAPS)
    u = F.pad(h, (5, 5), mode="replicate")
    u = 2.0 * F.conv_transpose1d(u, w, stride=2, groups=C)[..., 15:-15]
    a = torch.exp(alpha.float())[:, None]
    ib = 1.0 / (torch.exp(beta.float())[:, None] + EPS)
    s = u + ib * torch.sin(u * a) ** 2
    s = F.pad(s, (5, 6), mode="replicate")
    return F.conv1d(s, w, stride=2, groups=C).to(x.dtype)


def amp_act(x, alpha, beta, bias=None, residual=None):
    """The activation of ``x + bias + residual``: x and residual (B, C, T),
    bias, alpha and beta (C,), the sum taken in f32 and the activation
    read from it (``amp_act_plain``'s math). Returns y, or (the sum rounded
    to x's dtype, y) where a residual is given; both in x's dtype's layout
    (``dilated_conv.laid_out``).

    CPU tensors take ``amp_act_plain`` on the sum. On CUDA: f32 or bf16,
    every tensor on x's device in x's dtype; x and the residual are read
    in their dtype's layout (a copy is made of any other)."""
    if x.dim() != 3 or tuple(alpha.shape) != (x.shape[1],) \
            or alpha.shape != beta.shape \
            or (bias is not None and bias.shape != alpha.shape) \
            or (residual is not None and residual.shape != x.shape):
        raise ValueError(
            f"amp_act: x (B, C, T), alpha, beta and bias (C,), residual like "
            f"x; got {tuple(x.shape)}, {tuple(alpha.shape)}, "
            f"{tuple(beta.shape)}, "
            f"{None if bias is None else tuple(bias.shape)}, "
            f"{None if residual is None else tuple(residual.shape)}")
    if x.device.type == "cpu":
        s = x.float()
        if bias is not None:
            s = s + bias.float()[:, None]
        if residual is not None:
            s = s + residual.float()
        y = laid_out(amp_act_plain(s, alpha, beta).to(x.dtype))
        return y if residual is None else (laid_out(s.to(x.dtype)), y)
    if x.device.type != "cuda":
        raise ValueError(f"amp_act: unsupported device {x.device}")
    return _launch(x, alpha, beta, bias, residual)


# the wrapper adds the bias and the residual itself (models/bigvgan.py asks,
# so that a stand-in of (x, alpha, beta) still gets the sum)
amp_act.fuses_prologue = True


def _empty(shape, dtype, device):
    """An uninitialised (B, C, T) tensor laid out for ``dtype``."""
    B, C, T = shape
    if channels_last_for(dtype):
        return torch.empty((B, T, C), dtype=dtype,
                           device=device).transpose(1, 2)
    return torch.empty((B, C, T), dtype=dtype, device=device)


def _launch(x, alpha, beta, bias, residual):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"amp_act: dtype {x.dtype} (float32 or bfloat16)")
    for t in (alpha, beta, bias, residual):
        if t is not None and (t.device != x.device or t.dtype != x.dtype):
            raise ValueError("amp_act: alpha, beta, bias and residual must be "
                             "on x's device in x's dtype")
    B, C, T = x.shape
    tiles = channels_last_for(x.dtype)
    x = laid_out(x)
    alpha, beta = alpha.contiguous(), beta.contiguous()
    y = _empty((B, C, T), x.dtype, x.device)
    s = None
    if residual is not None:
        residual = laid_out(residual)
        s = torch.empty_like(y)
    if bias is not None:
        bias = bias.contiguous()
    if y.numel() == 0:
        return y if s is None else (s, y)
    # a batch of one may carry any batch stride: the kernels read none
    strides = [t.stride(0) if B > 1 else T * C
               for t in (x, x if residual is None else residual)]
    ptrs = [t.data_ptr() for t in (x, y, alpha, beta, bias, residual, s)
            if t is not None]
    vec = int((C if tiles else T) % 8 == 0
              and all(p % 16 == 0 for p in ptrs)
              and all(st % 8 == 0 for st in strides))
    taps = (ctypes.c_float * TAPS)(*_taps())
    lib = _build.load("amp_act")
    err = lib.tk_amp_act(
        x.data_ptr(), None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        None if s is None else s.data_ptr(), y.data_ptr(), alpha.data_ptr(),
        beta.data_ptr(), int(x.dtype == torch.bfloat16), B, C, T, strides[0],
        strides[1], vec, taps, _build.current_stream(x.device))
    _build.check(lib, err, "amp_act")
    _build.count_launch(globals())
    _build.count_launch(globals(), "elements", x.numel())
    if bias is not None:
        _build.count_launch(globals(), "bias_in")
    if residual is not None:
        _build.count_launch(globals(), "residual_in")
    return y if s is None else (s, y)


def _dense(t):
    """``t`` (B, C, T) laid out for its dtype with no batch stride past T C
    (a copy of any other layout)."""
    t = laid_out(t)
    B, C, T = t.shape
    if B < 2 or t.stride(0) == T * C:
        return t
    return t.transpose(1, 2).contiguous().transpose(1, 2)   # channels-last


def amp_mean(parts):
    """The mean of an upsampling stage's AMP blocks, each given as its
    parts (a, bias, x), the block's output a + bias + x: a its last conv's
    raw output and x its running residual, (B, C, T), bias (C,). Returns
    sum_j (a_j + bias_j + x_j) / n, summed in f32 in that order and
    rounded once to the parts' dtype, in its layout
    (``dilated_conv.laid_out``): one pass over memory (the kernel
    ``tk_amp_mean`` on CUDA, counted in ``mean_launches``; PyTorch in f32
    elsewhere)."""
    a0 = parts[0][0]
    if a0.device.type != "cuda":
        s = 0
        for a, b, x in parts:
            s = s + ((a.float() + b.float()[:, None]) + x.float())
        return laid_out((s / len(parts)).to(a0.dtype))
    if not 1 <= len(parts) <= 4:
        raise ValueError(f"amp_mean: 1 to 4 parts, got {len(parts)}")
    B, C, T = a0.shape
    parts = [(_dense(a), b.contiguous(), _dense(x)) for a, b, x in parts]
    for t in (t for part in parts for t in part):
        if t.device != a0.device or t.dtype != a0.dtype \
                or t.shape not in (a0.shape, (C,)):
            raise ValueError("amp_mean: every part on one device in one "
                             "dtype, a and x (B, C, T), bias (C,)")
    y = _empty((B, C, T), a0.dtype, a0.device)
    if y.numel() == 0:
        return y
    tiles = channels_last_for(a0.dtype)
    vec = int((C if tiles else T) % 8 == 0 and y.data_ptr() % 16 == 0
              and all(t.data_ptr() % 16 == 0 for part in parts for t in part))
    ptrs = [(ctypes.c_void_p * len(parts))(*[part[i].data_ptr()
                                             for part in parts])
            for i in range(3)]
    lib = _build.load("amp_act")
    err = lib.tk_amp_mean(ptrs[0], ptrs[1], ptrs[2], len(parts), y.data_ptr(),
                          int(a0.dtype == torch.bfloat16), y.numel(), C,
                          1 if tiles else T, vec,
                          _build.current_stream(a0.device))
    _build.check(lib, err, "amp_mean")
    _build.count_launch(globals(), "mean_launches")
    return y
