"""Offline feature-extraction pipeline (prepare_data equivalent).

Port of tts_king_tpu/data/features.py. Produces the same artifact layout as
the reference Preprocessor (fs_two/preprocessor/preprocessor.py:69-179):
per-utterance .npy families (mel, energy, duration, pitch, cwt-pitch,
pitch-mean, pitch-std, and frame-pitch, the raw frame F0), speakers.json,
stats.json, shuffled train/val split, with the semantics the training code
depends on:
  * MFA TextGrid -> phones + frame durations with leading/trailing-silence
    trimming (get_alignment, preprocessor.py:313-349);
  * F0 at hop period, zeros for unvoiced, linear interpolation across
    unvoiced gaps, phoneme-level averaging (preprocessor.py:206-243);
  * per-utterance log-pitch standardization with saved mean/std
    (preprocessor.py:244-252), CWT of the standardized contour;
  * corpus-level scaler over outlier-trimmed values, then a second pass
    rewriting pitch/energy files and collecting global min/max into
    stats.json (preprocessor.py:119-160,361-377).

As in the JAX package, and unlike the reference:
  * wavs are normalized in memory, never rewritten in place (the reference's
    wav_rescale mutates the corpus, preprocessor.py:24-27,98);
  * mel, energy and YIN F0 run as batches over length buckets on the
    device (``Preprocessor(device=...)``), the mel projection in exact f32;
    the native DIO backend runs on the host's threads;
  * speaker ids come from the sorted directory listing (deterministic).
The host side (phoneme averaging, outlier trimming, the Welford scaler, the
normalization pass, the split) is the JAX package's numpy code, in its
dtypes, so the metadata is identical and the features agree to rounding.
"""

import functools
import json
import os
import random
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from tts_king_torch import native
from tts_king_torch.config import PreprocessConfig
from tts_king_torch.data.textgrid import read_textgrid
from tts_king_torch.ops.cwt import transform_cwt
from tts_king_torch.ops.f0 import interpolate_unvoiced, yin_f0
from tts_king_torch.ops.stft import MelExtractor
from tts_king_torch.text import text_to_sequence

SIL_PHONES = ["sil", "sp", "spn"]
WAV_BUCKET_STEP = 32768  # samples; bucket quantum for batched extraction
PITCH_BACKENDS = ("pyworld", "native", "native_yin", "yin")


def load_wav(path: str, target_sr: int) -> np.ndarray:
    """Read + resample + peak-normalize a wav to float32 in [-1, 1]."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if sr != target_sr:
        from math import gcd

        g = gcd(sr, target_sr)
        wav = resample_poly(wav, target_sr // g, sr // g).astype(np.float32)
    peak = np.max(np.abs(wav))
    if peak > 0:
        wav = wav / peak  # the reference's rescale-to-max_wav_value net effect
    return wav


def get_alignment(tier, sampling_rate: int, hop_length: int):
    """TextGrid phone tier -> (phones, frame durations, start, end), with the
    reference's silence trimming (preprocessor.py:313-349)."""
    phones: List[str] = []
    durations: List[int] = []
    start_time = end_time = 0.0
    end_idx = 0
    for iv in tier.intervals:
        s, e, p = iv.start_time, iv.end_time, iv.text
        if not phones:
            if p in SIL_PHONES:
                continue
            start_time = s
        if p not in SIL_PHONES:
            phones.append(p)
            end_time = e
            end_idx = len(phones)
        else:
            phones.append(p)
        durations.append(int(np.round(e * sampling_rate / hop_length)
                             - np.round(s * sampling_rate / hop_length)))
    return phones[:end_idx], durations[:end_idx], start_time, end_time


@functools.lru_cache(maxsize=None)
def _phone_ok(phone: str) -> bool:
    return len(text_to_sequence("{" + phone + "}", [])) == 1


def _invalid_phones(phones) -> set:
    """Phones that do NOT map to exactly one symbol ID in the brace path."""
    return {p for p in phones if not _phone_ok(p)}


def _phoneme_average(values: np.ndarray, durations) -> np.ndarray:
    """Average frame-level values into phoneme bins (preprocessor.py:236-243)."""
    out = np.zeros(len(durations), dtype=np.float64)
    pos = 0
    for i, d in enumerate(durations):
        out[i] = np.mean(values[pos : pos + d]) if d > 0 else 0.0
        pos += d
    return out


def remove_outlier(values: np.ndarray) -> np.ndarray:
    """IQR-trim (preprocessor.py:351-359)."""
    values = np.asarray(values)
    if values.size == 0:
        return values
    p25, p75 = np.percentile(values, [25, 75])
    lower = p25 - 1.5 * (p75 - p25)
    upper = p75 + 1.5 * (p75 - p25)
    return values[np.logical_and(values > lower, values < upper)]


@dataclass
class _Pending:
    speaker: str
    basename: str
    wav: np.ndarray
    phones: List[str]
    durations: List[int]
    raw_text: str


def resolve_pitch_backend(name: str) -> str:
    """The F0 backend to run: ``"auto"`` keeps the JAX package's order
    (pyworld if importable, bit-exact with the reference's dio+stonemask,
    preprocessor.py:207-213; else the native DIO when its library builds;
    else YIN on the device). A backend asked for by name that cannot run
    raises; it never falls back to another."""
    if name == "auto":
        try:
            import pyworld  # noqa: F401

            return "pyworld"
        except ImportError:
            return "native" if native.available() else "yin"
    if name not in PITCH_BACKENDS:
        raise ValueError(f"pitch_backend {name!r}: one of "
                         f"{('auto',) + PITCH_BACKENDS}")
    if name == "pyworld":
        try:
            import pyworld  # noqa: F401
        except ImportError as e:
            raise RuntimeError("pitch_backend='pyworld' needs the pyworld "
                               "package") from e
    elif name.startswith("native") and not native.available():
        raise RuntimeError(f"pitch_backend={name!r}: the native library "
                           f"does not build here: {native.build_error()}")
    return name


class Preprocessor:
    """Corpus -> training features. See module docstring.

    ``device`` runs the mel, energy, YIN and CWT work (default the card,
    which raises without CUDA; the CPU only when asked for);
    ``pitch_backend`` is resolved once (``resolve_pitch_backend``) and kept
    as ``self.pitch_backend``.
    """

    def __init__(self, config: PreprocessConfig, batch_size: int = 8,
                 pitch_backend: str = "auto", device="cuda"):
        from tts_king_torch.pipeline import resolve_device

        self.device = resolve_device(device)
        self.cfg = config
        self.in_dir = config.raw_path
        self.out_dir = config.preprocessed_path
        self.sr = config.audio.sampling_rate
        self.hop = config.stft.hop_length
        self.batch_size = batch_size
        self.val_size = config.val_size
        self.pitch_avg = config.pitch.feature == "phoneme_level"
        self.energy_avg = config.energy.feature == "phoneme_level"
        self.pitch_norm = config.pitch.normalization
        self.energy_norm = config.energy.normalization

        self.mel = MelExtractor(
            config.stft.filter_length, config.stft.hop_length,
            config.stft.win_length, config.mel.n_mel_channels,
            self.sr, config.mel.mel_fmin, config.mel.mel_fmax)

        self.pitch_backend = resolve_pitch_backend(pitch_backend)

    # ---------------- batched device extraction ----------------

    def _extract_batch(self, wavs: List[np.ndarray]):
        """Pad a bucket of wavs with zeros to a multiple of WAV_BUCKET_STEP
        (so an utterance's last frames see zeros, as in the JAX package)
        and run mel/energy (and YIN) on the device as one batch."""
        n = max(len(w) for w in wavs)
        n = ((n + WAV_BUCKET_STEP - 1) // WAV_BUCKET_STEP) * WAV_BUCKET_STEP
        batch = np.zeros((len(wavs), n), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : len(w)] = w
        x = torch.from_numpy(batch).to(self.device)
        mels, energies = self.mel.mel_and_energy(x)
        mels, energies = mels.cpu().numpy(), energies.cpu().numpy()
        if self.pitch_backend == "yin":
            f0s = yin_f0(x, self.sr, self.hop).cpu().numpy()
        elif self.pitch_backend == "pyworld":
            f0s = [self._pyworld_f0(w) for w in wavs]
        elif self.pitch_backend == "native":
            f0s = native.dio_f0_batch(wavs, self.sr, self.hop)
        elif self.pitch_backend == "native_yin":
            f0s = native.yin_f0_batch(wavs, self.sr, self.hop)
        out = []
        for i, w in enumerate(wavs):
            frames = len(w) // self.hop + 1
            out.append((mels[i, :frames], energies[i, :frames],
                        np.asarray(f0s[i])[:frames]))
        return out

    def _pyworld_f0(self, wav):
        import pyworld as pw

        w = wav.astype(np.float64)
        f0, t = pw.dio(w, self.sr, frame_period=self.hop / self.sr * 1000)
        return pw.stonemask(w, f0, t, self.sr)

    # ---------------- per-utterance finalize ----------------

    def _finalize(self, p: _Pending, mel, energy, f0):
        total = sum(p.durations)
        f0 = f0[:total]
        if np.sum(f0 != 0) <= 1:
            return None
        mel = mel[:total]
        energy = energy[:total]

        pitch = f0
        if self.pitch_avg:
            pitch = interpolate_unvoiced(pitch)
            pitch = _phoneme_average(pitch, p.durations)
        # log + per-utterance standardize (preprocessor.py:244-252)
        with np.errstate(divide="ignore"):
            pitch = np.log(pitch)
        pitch_mean = float(np.mean(pitch))
        pitch_std = float(np.std(pitch))
        if pitch_std == 0 or not np.isfinite(pitch_mean):
            return None
        pitch = (pitch - pitch_mean) / pitch_std
        cwt_pitch = transform_cwt(pitch.astype(np.float32),
                                  device=self.device).cpu().numpy()

        if self.energy_avg:
            energy = _phoneme_average(energy, p.durations)

        text = "{" + " ".join(p.phones) + "}"
        base = f"{p.speaker}-{{}}-{p.basename}.npy"
        np.save(self._path("duration", base), np.asarray(p.durations))
        np.save(self._path("pitch", base, "pitch"), pitch)
        # Frame-level raw F0 (Hz, 0 = unvoiced), untouched by normalization:
        # the objective evaluation metrics (train/metrics.py — F0-RMSE and
        # V/UV F1 on free-running synthesis) need it. The reference discards
        # it after phoneme averaging (preprocessor.py:224-266).
        np.save(self._path("pitch", base, "frame-pitch"),
                f0.astype(np.float32))
        # ascontiguousarray: the CWT's (T, S) comes back as a transposed
        # view, which np.save would record as fortran_order; keep on-disk
        # features uniformly C-order
        np.save(self._path("pitch", base, "cwt-pitch"),
                np.ascontiguousarray(cwt_pitch))
        np.save(self._path("pitch", base, "pitch-mean"), pitch_mean)
        np.save(self._path("pitch", base, "pitch-std"), pitch_std)
        np.save(self._path("energy", base), np.ascontiguousarray(energy))
        np.save(self._path("mel", base), np.ascontiguousarray(mel))
        return ("|".join([p.basename, p.speaker, text, p.raw_text]),
                remove_outlier(pitch), remove_outlier(energy), mel.shape[0])

    def _path(self, subdir, base, kind=None):
        return os.path.join(self.out_dir, subdir,
                            base.format(kind or subdir))

    # ---------------- main entry ----------------

    def build_from_path(self, seed: int = 1234):
        for sub in ("mel", "pitch", "energy", "duration"):
            os.makedirs(os.path.join(self.out_dir, sub), exist_ok=True)

        speakers: Dict[str, int] = {}
        out: List[str] = []
        n_frames = 0
        pitch_acc, energy_acc = _Welford(), _Welford()

        pending: List[_Pending] = []

        def flush():
            nonlocal n_frames
            if not pending:
                return
            results = self._extract_batch([p.wav for p in pending])
            for p, (mel, energy, f0) in zip(pending, results):
                r = self._finalize(p, mel, energy, f0)
                if r is None:
                    continue
                info, pitch_v, energy_v, frames = r
                out.append(info)
                if len(pitch_v):
                    pitch_acc.update(pitch_v)
                if len(energy_v):
                    energy_acc.update(energy_v)
                n_frames += frames
            pending.clear()

        speaker_dirs = sorted(
            d for d in os.listdir(self.in_dir)
            if os.path.isdir(os.path.join(self.in_dir, d)))
        if self.cfg.speakers_filter:
            allowed = set(self.cfg.speakers_filter)
            speaker_dirs = [d for d in speaker_dirs if d in allowed]

        for i, speaker in enumerate(speaker_dirs):
            speakers[speaker] = i
            sdir = os.path.join(self.in_dir, speaker)
            for wav_name in sorted(os.listdir(sdir)):
                if not wav_name.endswith(".wav"):
                    continue
                basename = wav_name[: -len(".wav")]
                tg_path = os.path.join(sdir, basename + ".TextGrid")
                if not os.path.exists(tg_path):
                    continue
                tg = read_textgrid(tg_path)
                phones, durations, start, end = get_alignment(
                    tg.get_tier_by_name("phones"), self.sr, self.hop)
                if start >= end or not phones:
                    continue
                bad = _invalid_phones(phones)
                if bad:
                    # Fail loudly: text_to_sequence silently DROPS symbols
                    # it doesn't know (keithito parser semantics the
                    # reference inherits), which would misalign the phoneme
                    # sequence against the per-phone duration/pitch/energy
                    # targets saved below — a silent training-data
                    # corruption, not a recoverable condition.
                    raise ValueError(
                        f"{tg_path}: phones {sorted(bad)} are not in the "
                        "symbol table (text/symbols.py); they would be "
                        "silently dropped by text_to_sequence and misalign "
                        "text vs duration targets")
                wav = load_wav(os.path.join(sdir, wav_name), self.sr)
                wav = wav[int(self.sr * start) : int(self.sr * end)]
                lab_path = os.path.join(sdir, basename + ".lab")
                raw_text = ""
                if os.path.exists(lab_path):
                    with open(lab_path, encoding="utf-8") as f:
                        raw_text = f.readline().strip("\n")
                pending.append(_Pending(speaker, basename, wav, phones,
                                        durations, raw_text))
                if len(pending) >= self.batch_size:
                    flush()
        flush()

        # Corpus normalization (second pass over written files).
        pitch_mean, pitch_std = ((pitch_acc.mean, pitch_acc.std)
                                 if self.pitch_norm else (0.0, 1.0))
        energy_mean, energy_std = ((energy_acc.mean, energy_acc.std)
                                   if self.energy_norm else (0.0, 1.0))
        pitch_min, pitch_max = self._normalize_dir("pitch", pitch_mean, pitch_std)
        energy_min, energy_max = self._normalize_dir("energy", energy_mean,
                                                     energy_std)

        with open(os.path.join(self.out_dir, "speakers.json"), "w") as f:
            json.dump(speakers, f)
        with open(os.path.join(self.out_dir, "stats.json"), "w") as f:
            json.dump({
                "pitch": [float(pitch_min), float(pitch_max),
                          float(pitch_mean), float(pitch_std)],
                "energy": [float(energy_min), float(energy_max),
                           float(energy_mean), float(energy_std)],
            }, f)

        rng = random.Random(seed)
        rng.shuffle(out)
        val_size = min(self.val_size, max(len(out) // 10, 1))
        with open(os.path.join(self.out_dir, "train.txt"), "w",
                  encoding="utf-8") as f:
            for m in out[val_size:]:
                f.write(m + "\n")
        with open(os.path.join(self.out_dir, "val.txt"), "w",
                  encoding="utf-8") as f:
            for m in out[:val_size]:
                f.write(m + "\n")

        hours = n_frames * self.hop / self.sr / 3600
        print(f"Processed {len(out)} utterances, {hours:.2f} hours")
        return out

    def _normalize_dir(self, subdir, mean, std):
        """(x - mean)/std rewrite of every value file; returns global
        min/max (preprocessor.py:361-377; skips cwt/mean/std files)."""
        d = os.path.join(self.out_dir, subdir)
        vmin, vmax = np.finfo(np.float64).max, np.finfo(np.float64).min
        for fname in os.listdir(d):
            if ("std" in fname or "mean" in fname or "cwt" in fname
                    or "frame" in fname):
                continue
            path = os.path.join(d, fname)
            values = (np.load(path) - mean) / std
            np.save(path, values)
            if values.size:
                vmin = min(vmin, values.min())
                vmax = max(vmax, values.max())
        return vmin, vmax


class _Welford:
    """Streaming mean/std (sklearn StandardScaler.partial_fit equivalent)."""

    def __init__(self):
        self.n = 0
        self._mean = 0.0
        self._m2 = 0.0

    def update(self, values):
        values = np.asarray(values, np.float64).ravel()
        for chunk_mean, chunk_var, m in [(values.mean(), values.var(),
                                          len(values))]:
            if m == 0:
                continue
            delta = chunk_mean - self._mean
            tot = self.n + m
            self._mean += delta * m / tot
            self._m2 += chunk_var * m + delta ** 2 * self.n * m / tot
            self.n = tot

    @property
    def mean(self):
        return float(self._mean)

    @property
    def std(self):
        return float(np.sqrt(self._m2 / self.n)) if self.n else 1.0
