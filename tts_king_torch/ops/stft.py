"""Batched STFT / mel-spectrogram / energy extraction.

Port of tts_king_tpu/ops/stft.py. Numerical parity targets:
  * TacotronSTFT path (fs_two/audio/stft.py:57-90,145-193): reflect-pad by
    n_fft//2 on both sides, periodic Hann window, |rfft| magnitudes, Slaney
    mel projection, log dynamic-range compression (clip 1e-5), per-frame L2
    energy. An rfft over strided frames is the same linear map as the
    reference's conv1d against a DFT basis;
  * HiFi-GAN path (hifi/meldataset.py:45-74): reflect-pad by (n_fft-hop)//2,
    center=False, sqrt(|.|^2 + 1e-9) magnitudes, same mel + log.

Everything runs on the device of its input. The mel projection feeds the
training targets and HiFi-GAN's mel loss (weighted 45), so it runs in exact
f32 (``exact_f32``), forward and backward: TF32 would move the log-mels by
~1e-3.
"""

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from tts_king_torch.ops.mel import mel_filterbank


@contextlib.contextmanager
def exact_f32():
    """f32 matmuls in full precision inside the block (no TF32), whatever
    the process's setting; the setting is restored after."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


@functools.lru_cache(maxsize=None)
def _hann_window(win_length, n_fft):
    """Periodic Hann, zero-padded centrally to n_fft (scipy get_window +
    librosa pad_center semantics)."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        w = np.pad(w, (pad, n_fft - win_length - pad))
    return w.astype(np.float32)


def _window(win_length, n_fft, device):
    return torch.from_numpy(_hann_window(win_length, n_fft)).to(device)


def frame_signal(y, n_fft, hop_length):
    """(..., T) -> (..., n_frames, n_fft), n_frames = 1 + (T - n_fft)//hop
    (a strided view)."""
    return y.unfold(-1, n_fft, hop_length)


def reflect_pad(y, left, right):
    """Reflect-pad the last axis of (..., T) (F.pad's reflect mode wants a
    batch and a channel axis)."""
    shape = y.shape
    out = F.pad(y.reshape(-1, 1, shape[-1]), (left, right), mode="reflect")
    return out.reshape(*shape[:-1], out.shape[-1])


def stft_magnitude(y, n_fft=1024, hop_length=256, win_length=1024,
                   center_pad="tacotron", mag_eps=0.0):
    """Batched magnitude spectrogram.

    y: (B, T) waveform in [-1, 1].
    center_pad: 'tacotron' (reflect n_fft//2, reference STFT.transform) or
      'hifigan' (reflect (n_fft-hop)//2, meldataset.mel_spectrogram).
    Returns (B, n_frames, 1 + n_fft//2).
    """
    if center_pad == "tacotron":
        pad = n_fft // 2
    elif center_pad == "hifigan":
        pad = (n_fft - hop_length) // 2
    else:
        raise ValueError(center_pad)
    y = reflect_pad(y, pad, pad)
    frames = frame_signal(y, n_fft, hop_length)
    spec = torch.fft.rfft(frames * _window(win_length, n_fft, y.device),
                          dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.sqrt(power + mag_eps)


def dynamic_range_compression(x, C=1.0, clip_val=1e-5):
    """log(clamp(x, 1e-5) * C) — fs_two/audio/audio_processing.py:85-91."""
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x, C=1.0):
    return torch.exp(x) / C


class _MelProject(torch.autograd.Function):
    """mag @ basis^T with the product of the backward (grad @ basis) in
    exact f32 too: autograd's own backward would run under the process's
    TF32 setting. The basis is a constant."""

    @staticmethod
    def forward(ctx, mag, basis):
        ctx.save_for_backward(basis)
        with exact_f32():
            return torch.matmul(mag, basis.t())

    @staticmethod
    def backward(ctx, grad):
        (basis,) = ctx.saved_tensors
        with exact_f32():
            return torch.matmul(grad, basis), None


def _mel_project(mag, basis):
    """(B, T, F) @ (M, F)^T in exact f32, forward and backward."""
    return _MelProject.apply(mag, basis)


@functools.lru_cache(maxsize=None)
def _mel_basis(sampling_rate, n_fft, num_mels, fmin, fmax, device):
    """The mel filterbank as a tensor on ``device``, made once per setting
    and device (a constant: no caller writes to it)."""
    return torch.from_numpy(mel_filterbank(
        sampling_rate, n_fft, num_mels, fmin, fmax)).to(device)


class MelExtractor:
    """Precomputed-basis mel+energy extractor (TacotronSTFT equivalent)."""

    def __init__(self, filter_length=1024, hop_length=256, win_length=1024,
                 n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
                 mel_fmax=8000.0):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.mel_basis = torch.from_numpy(
            mel_filterbank(sampling_rate, filter_length, n_mel_channels,
                           mel_fmin, mel_fmax))
        self._basis_on = {}   # its copy per device

    def _basis(self, device):
        basis = self._basis_on.get(device)
        if basis is None:
            basis = self._basis_on[device] = self.mel_basis.to(device)
        return basis

    def mel_and_energy(self, y):
        """(B, T) wav -> ((B, n_frames, n_mels) log-mel, (B, n_frames)
        energy), on y's device.

        Mel is log-compressed; energy is the per-frame L2 norm of the linear
        magnitudes (fs_two/audio/stft.py:174-193).
        """
        mag = stft_magnitude(y, self.filter_length, self.hop_length,
                             self.win_length, center_pad="tacotron")
        mel = dynamic_range_compression(
            _mel_project(mag, self._basis(y.device)))
        energy = torch.linalg.vector_norm(mag, dim=-1)
        return mel, energy


def hifigan_mel(y, n_fft=1024, num_mels=80, sampling_rate=22050, hop_size=256,
                win_size=1024, fmin=0.0, fmax=8000.0):
    """HiFi-GAN training mel (hifi/meldataset.py:45-74): (B, T) -> (B, frames, mels)."""
    mag = stft_magnitude(y, n_fft, hop_size, win_size, center_pad="hifigan",
                         mag_eps=1e-9)
    basis = _mel_basis(sampling_rate, n_fft, num_mels, fmin, fmax,
                       torch.device(y.device))
    return dynamic_range_compression(_mel_project(mag, basis))


def griffin_lim(magnitudes, n_iters=30, n_fft=1024, hop_length=256,
                win_length=1024, generator=None):
    """Griffin-Lim phase reconstruction fallback
    (fs_two/audio/audio_processing.py:66-82), batched.

    magnitudes: (B, n_frames, 1+n_fft//2) linear magnitudes -> (B, T) wav.
    The initial phases are uniform in [-pi, pi) from ``generator`` (default:
    a generator seeded with 0 on the magnitudes' device, where the JAX
    package uses PRNGKey(0)).
    """
    if generator is None:
        generator = torch.Generator(device=magnitudes.device).manual_seed(0)
    angles = (torch.rand(magnitudes.shape, generator=generator,
                         device=magnitudes.device) * 2.0 - 1.0) * np.pi
    spec = magnitudes * torch.exp(1j * angles)
    signal = istft(spec, n_fft, hop_length, win_length)
    window = _window(win_length, n_fft, magnitudes.device)
    for _ in range(n_iters):
        padded = reflect_pad(signal, n_fft // 2, n_fft // 2)
        full = torch.fft.rfft(frame_signal(padded, n_fft, hop_length) * window,
                              dim=-1)
        phase = full / torch.clamp(full.abs(), min=1e-8)
        spec = magnitudes[:, : phase.shape[1]] * phase
        signal = istft(spec, n_fft, hop_length, win_length)
    return signal


def istft(spec, n_fft=1024, hop_length=256, win_length=1024):
    """Inverse STFT with window-sum-square normalization (overlap-add)."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)   # (B, n_frames, n_fft)
    window = _hann_window(win_length, n_fft)
    frames = frames * torch.from_numpy(window).to(frames.device)
    B, n_frames, _ = frames.shape
    T = n_fft + hop_length * (n_frames - 1)
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(n_fft)[None, :]).reshape(-1)
    out = frames.new_zeros((B, T))
    out.index_add_(1, torch.from_numpy(idx).to(frames.device),
                   frames.reshape(B, -1))
    # window sum-square envelope
    wss = np.zeros(T, dtype=np.float32)
    w2 = window ** 2
    for i in range(n_frames):
        wss[i * hop_length : i * hop_length + n_fft] += w2
    out = out / torch.from_numpy(np.maximum(wss, 1e-10)).to(frames.device)
    return out[:, n_fft // 2 : -(n_fft // 2)]
