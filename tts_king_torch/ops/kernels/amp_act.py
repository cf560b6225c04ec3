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

The wrapper dispatches on where x lies: CPU tensors go to
``amp_act_plain``; CUDA tensors launch the kernel, or raise. ``launches``
counts the kernel's launches, and ``elements`` the base-rate elements they
took in (B x C x T each); a CPU call or an empty tensor launches nothing and
counts nothing.
"""

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from tts_king_torch.ops.kernels import _build

TAPS = 12
CUTOFF = 0.25       # 0.5 / ratio, ratio 2
HALF_WIDTH = 0.3    # 0.6 / ratio
EPS = 1e-9          # SnakeBeta's no_div_by_zero
REACH = 5           # the filters' one-sided reach: y[t] reads x[t-5 .. t+5]
launches = 0
elements = 0


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


def amp_act(x, alpha, beta):
    """The activation; same contract as ``amp_act_plain``. On CUDA: f32 or
    bf16, alpha and beta on x's device in x's dtype; x is read as a
    contiguous (B, C, T) tensor (a copy is made of any other layout)."""
    if x.dim() != 3 or tuple(alpha.shape) != (x.shape[1],) \
            or alpha.shape != beta.shape:
        raise ValueError(f"amp_act: x (B, C, T) and alpha, beta (C,); got "
                         f"{tuple(x.shape)}, {tuple(alpha.shape)}, "
                         f"{tuple(beta.shape)}")
    if x.device.type == "cpu":
        return amp_act_plain(x, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"amp_act: unsupported device {x.device}")
    return _launch(x, alpha, beta)


def _launch(x, alpha, beta):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"amp_act: dtype {x.dtype} (float32 or bfloat16)")
    for t in (alpha, beta):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("amp_act: alpha and beta must be on x's device "
                             "in x's dtype")
    B, C, T = x.shape
    x = x.contiguous()
    alpha, beta = alpha.contiguous(), beta.contiguous()
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    aligned = int(T % 8 == 0 and x.data_ptr() % 16 == 0
                  and y.data_ptr() % 16 == 0)
    taps = (ctypes.c_float * TAPS)(*_taps())
    lib = _build.load("amp_act")
    err = lib.tk_amp_act(x.data_ptr(), y.data_ptr(), alpha.data_ptr(),
                         beta.data_ptr(), int(x.dtype == torch.bfloat16),
                         B * C, C, T, aligned, taps,
                         _build.current_stream(x.device))
    _build.check(lib, err, "amp_act")
    _build.count_launch(globals())
    _build.count_launch(globals(), "elements", x.numel())
    return y
