"""Continuous wavelet transform of log-F0 contours.

Port of tts_king_tpu/ops/cwt.py. Forward transform: FFT-domain Mexican-hat
(DOG m=2) CWT with the reference's fixed parameters (dt=0.005, dj=1,
s0=0.01, J=10 -> 11 scales; see fs_two/cwt/cwt_utils.py:14-24, which
delegates to pycwt): ifft(fft(x) * conj(psi_hat(s*omega))) per scale, as
batched FFTs on the input's device, in complex64.

Inverse recomposition matches inverse_batch_cwt (fs_two/cwt/cwt_utils.py:
54-66): f0 = sum_i coef_i * (i + 3.5)^-2.5 over the first 10 scales, then
standardized over the *batch* axis (the reference's TorchStandardScaler
quirk, kept): with one row the result is exactly 0. Both run in float32
whatever the input's dtype and return that dtype.
"""

import math

import numpy as np
import torch

from tts_king_torch.parallel.comm import Axis, sum_over

CWT_DT = 0.005
CWT_DJ = 1.0
CWT_S0 = 2 * CWT_DT  # 0.01
CWT_J = 10  # J+1 = 11 scales


def cwt_scales(s0=CWT_S0, dj=CWT_DJ, J=CWT_J):
    return s0 * 2.0 ** (np.arange(0, J + 1) * dj)


def _mexican_hat_ft(f):
    """Fourier transform of the DOG(m=2) wavelet: f^2/sqrt(gamma(2.5)) e^{-f^2/2}."""
    return (f ** 2) / math.sqrt(math.gamma(2.5)) * torch.exp(-(f ** 2) / 2.0)


def transform_cwt(lf0, dt=CWT_DT, dj=CWT_DJ, s0=CWT_S0, J=CWT_J,
                  device=None):
    """Mexican-hat CWT of a (batched) signal.

    Args:
      lf0: (T,) or (B, T) standardized log-F0, a tensor or an array.
      device: where an array goes (default: the CPU; a tensor stays where it
        is).
    Returns:
      (T, J+1) or (B, T, J+1) float32 real wavelet coefficients (scales
      last), the layout the training features use, on the input's device.
    """
    x = torch.as_tensor(lf0, dtype=torch.float32, device=device)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    n0 = x.shape[-1]
    # Pad to the next power of two, like pycwt's fft_kwargs.
    N = int(2 ** math.ceil(math.log2(max(n0, 2))))
    scales = torch.as_tensor(cwt_scales(s0, dj, J), dtype=torch.float32,
                             device=x.device)                     # (S,)
    x_ft = torch.fft.fft(x, n=N, dim=-1)                          # (B, N)
    ftfreqs = 2.0 * np.pi * torch.from_numpy(
        np.fft.fftfreq(N, dt).astype(np.float32)).to(x.device)    # (N,)
    # Energy-normalized wavelet at each scale: sqrt(s * domega * N) * psi_hat
    norm = torch.sqrt(scales * ftfreqs[1] * N)                    # (S,)
    psi_bar = norm[:, None] * _mexican_hat_ft(scales[:, None]
                                              * ftfreqs[None, :])
    W = torch.fft.ifft(x_ft[:, None, :] * psi_bar[None], dim=-1)[..., :n0]
    out = W.real.transpose(1, 2)                                  # (B, T, S)
    return out[0] if squeeze else out


def _recompose(coefs, num_scales):
    """sum_i coefs[..., i] * (i + 3.5)^-2.5 over the first num_scales, f32."""
    weights = (torch.arange(num_scales, dtype=torch.float32,
                            device=coefs.device) + 1 + 2.5) ** (-2.5)
    return torch.sum(coefs[..., :num_scales].float() * weights, dim=-1)


def inverse_cwt(coefs, num_scales=10):
    """Single-utterance recomposition + per-utterance standardization
    (inverse_cwt, fs_two/cwt/cwt_utils.py:27-33): (T, >=num_scales) -> (T,).
    """
    rec = _recompose(coefs, num_scales)
    std = torch.std(rec, correction=0)
    return ((rec - rec.mean()) / torch.clamp(std, min=1e-12)).to(coefs.dtype)


def inverse_batch_cwt(coefs, num_scales=10, dp: Axis = Axis()):
    """Batched recomposition, standardized over the batch axis with the
    population std + 1e-12 (the reference's quirk, cwt_utils.py:54-66):
    (B, T, >=num_scales) -> (B, T). ``dp`` (a mesh axis) makes the batch
    the global one: the mean and the squared deviations are summed over
    every rank's rows (parallel.comm.sum_over), in two passes as
    torch.std's."""
    rec = _recompose(coefs, num_scales)
    n = rec.shape[0] * dp.size
    mean = sum_over(rec.sum(dim=0, keepdim=True), dp) / n
    std = torch.sqrt(sum_over(((rec - mean) ** 2).sum(
        dim=0, keepdim=True), dp) / n)
    return ((rec - mean) / (std + 1e-12)).to(coefs.dtype)
