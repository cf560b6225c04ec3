"""Mel filterbank construction (librosa parity, no librosa dependency).

Port of tts_king_tpu/ops/mel.py, the same numpy code, so the filterbank is
bit-equal to the JAX package's. It reimplements librosa.filters.mel with its
defaults (Slaney mel scale, 'slaney' area normalization), which both
reference feature pipelines use (fs_two/audio/stft.py:160-163,
hifi/meldataset.py:57). The filterbank is a constant (n_mels, 1 + n_fft//2)
matrix, so the mel projection is one matmul.
"""

import numpy as np

_MIN_LOG_HZ = 1000.0
_F_SP = 200.0 / 3.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies):
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asanyarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels):
    m = np.asanyarray(mels, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(
        log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), freqs)
    return freqs


def mel_filterbank(sampling_rate, n_fft, n_mels, fmin=0.0, fmax=None):
    """(n_mels, 1 + n_fft//2) float32 triangular filterbank, Slaney-normalized."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sampling_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]

    weights = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalization (constant energy per channel).
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)
