"""Batched fundamental-frequency (F0) estimation.

Port of tts_king_tpu/ops/f0.py: a vectorized YIN estimator
(cumulative-mean-normalized difference function with parabolic
interpolation, de Cheveigne & Kawahara 2002), one F0 value per mel frame
(hop-aligned, T//hop + 1 frames, as pyworld at the reference's frame
period), 0 where unvoiced, on the device of its input. It replaces the
reference's per-utterance pyworld dio+stonemask calls
(fs_two/preprocessor/preprocessor.py:206-215); the FFT-based difference
function keeps it O(B * frames * W log W).

Its decisions are thresholds (the first dip below ``threshold``, the argmin
in a 32-lag window, voiced at CMNDF < 0.3, the floor and the ceiling), so an
ulp of FFT difference between devices can flip a frame next to one.
"""

import numpy as np
import torch

from tts_king_torch.ops.stft import frame_signal, reflect_pad

DEFAULT_F0_FLOOR = 71.0   # pyworld default
DEFAULT_F0_CEIL = 800.0   # pyworld default
_LOCAL_MIN_WINDOW = 32


def yin_f0(y, sampling_rate=22050, hop_length=256, frame_length=2048,
           f0_floor=DEFAULT_F0_FLOOR, f0_ceil=DEFAULT_F0_CEIL, threshold=0.15):
    """Estimate F0 contours for a batch of waveforms.

    Args:
      y: (B, T) float waveforms in [-1, 1] (a tensor, or an array for the
        CPU).
    Returns:
      (B, n_frames) float32 F0 in Hz on y's device, 0 where unvoiced;
      n_frames = T//hop + 1.
    """
    y = torch.as_tensor(y, dtype=torch.float32)
    tau_min = max(2, int(sampling_rate / f0_ceil))
    tau_max = min(frame_length // 2, int(sampling_rate / f0_floor) + 1)
    W = frame_length
    N = W - tau_max  # correlation support

    pad = W // 2
    frames = frame_signal(reflect_pad(y, pad, pad - (1 if W % 2 else 0)), W,
                          hop_length)                       # (B, F, W)

    # Difference function d[tau] = sum_{j<N} (x[j] - x[j+tau])^2 via FFT
    # autocorrelation.
    fft_len = int(2 ** np.ceil(np.log2(W + N)))
    f_full = torch.fft.rfft(frames, n=fft_len, dim=-1)
    f_head = torch.fft.rfft(frames[..., :N], n=fft_len, dim=-1)
    corr = torch.fft.irfft(f_full * torch.conj(f_head), n=fft_len,
                           dim=-1)[..., :tau_max + 1]

    csum = torch.cumsum(frames * frames, dim=-1)
    e_head = csum[..., N - 1 : N]                      # sum x[0:N]^2
    # e_tail[tau] = sum_{j=tau}^{tau+N-1} x[j]^2; csum0[k] = sum x[0:k]^2
    csum0 = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    e_tail = csum0[..., N : N + tau_max + 1] - csum0[..., : tau_max + 1]

    d = torch.clamp(e_head + e_tail - 2.0 * corr, min=0.0)  # (B, F, tau_max+1)

    # Cumulative-mean normalization: d'[tau] = d[tau] * tau / sum_{1..tau} d.
    taus = torch.arange(1, tau_max + 1, device=y.device, dtype=torch.float32)
    dsum = torch.cumsum(d[..., 1:], dim=-1)
    cmndf = torch.cat([torch.ones_like(d[..., :1]),
                       d[..., 1:] * taus / torch.clamp(dsum, min=1e-12)],
                      dim=-1)

    # Candidate in [tau_min, tau_max]: the first dip below threshold (argmax
    # of a bool picks the first True), else the global minimum.
    search = cmndf[..., tau_min:]
    below = search < threshold
    first_below = torch.argmax(below.to(torch.uint8), dim=-1)
    any_below = below.any(dim=-1)
    tau_rel = torch.where(any_below, first_below, torch.argmin(search, dim=-1))

    # Walk a below-threshold pick to the minimum of the 32 lags from it
    # (indices clamped at the end; the first minimum wins).
    offs = torch.arange(_LOCAL_MIN_WINDOW, device=y.device)
    win = torch.clamp(tau_rel[..., None] + offs, max=search.shape[-1] - 1)
    local = tau_rel + torch.argmin(torch.gather(search, -1, win), dim=-1)
    tau = torch.where(any_below, local, tau_rel) + tau_min

    # Parabolic interpolation around tau on the CMNDF.
    def at(t):
        return torch.gather(cmndf, -1, t[..., None])[..., 0]

    y0 = at(torch.clamp(tau - 1, 0, tau_max))
    y1 = at(tau)
    y2 = at(torch.clamp(tau + 1, 0, tau_max))
    denom = y0 - 2.0 * y1 + y2
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (y0 - y2) / denom,
                        torch.zeros_like(denom))
    period = tau.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)

    f0 = sampling_rate / torch.clamp(period, min=1.0)
    voiced = (y1 < 0.3) & (f0 >= f0_floor) & (f0 <= f0_ceil)
    return torch.where(voiced, f0, torch.zeros_like(f0))


def interpolate_unvoiced(f0):
    """Linearly interpolate F0 across unvoiced (zero) frames, numpy, one utt.

    Mirrors the reference's interp1d step (preprocessor.py:224-233): constant
    extrapolation with the first/last voiced values.
    """
    f0 = np.asarray(f0, dtype=np.float64)
    nonzero = np.nonzero(f0)[0]
    if len(nonzero) == 0:
        return f0
    out = np.interp(np.arange(len(f0)), nonzero, f0[nonzero])
    return out
