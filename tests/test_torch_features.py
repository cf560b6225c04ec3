"""The port's data-preparation path on the CPU against the JAX package: the
signal ops (STFT, mel, ISTFT, Griffin-Lim, the CWT), YIN, the native copy
(YIN, DIO, the .npy batch loader), the Preprocessor on a seeded synthetic
corpus with both the native DIO and the YIN backend, the committed golden
of the JAX Preprocessor, the dataset's native loader, the F0 metrics, the
corpus tools and the CLI. tests/test_signal.py, tests/test_native.py,
tests/test_f0_parity.py, tests/test_data_pipeline.py,
tests/test_metrics.py and tests/test_corpus_tools.py are mirrored on the
port.

YIN's decisions are thresholds that an ulp of FFT difference can flip
(ops/f0.py), so YIN is held to the JAX one by voicing agreement and by F0 on
the frames both voice, never elementwise."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import tests.conftest as cf
from chip_smoke import (GOLDEN_FEATURES, compare_feature_trees, feature_tree,
                        port_model_no_dropout)
from tests.oracle_util import run_oracle
from tests.test_data_pipeline import _make_corpus
from tests.test_torch_cwt import cwt_variables
from tests.test_torch_train import TINY_MODEL, _jax_model
from tts_king_torch import native
from tts_king_torch.data import corpus_tools as ct

SR, HOP = 22050, 256


# ------------------------------------------------------------ signal ops


@pytest.fixture(scope="module")
def stft_golden():
    rng = np.random.RandomState(0)
    y = (0.5 * np.sin(2 * np.pi * 220 * np.arange(4096) / 22050)
         + 0.1 * rng.randn(4096)).astype(np.float32)
    y = np.stack([y, np.roll(y, 17)])
    return y, run_oracle("torch_stft", dict(y=y, n_fft=1024, hop=256,
                                            win=1024))


@pytest.mark.skipif(not cf.oracle_available(),
                    reason="no reference and no oracle recordings")
@pytest.mark.parametrize("center_pad", ["tacotron", "hifigan"])
def test_stft_magnitude_matches_oracle(stft_golden, center_pad):
    from tts_king_torch.ops.stft import stft_magnitude

    y, golden = stft_golden
    got = stft_magnitude(torch.from_numpy(y), 1024, 256, 1024,
                         center_pad=center_pad,
                         mag_eps=1e-9 if center_pad == "hifigan" else 0.0)
    want = golden[f"{center_pad}_mag"].transpose(0, 2, 1)  # torch (B, F, T)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.skipif(not cf.oracle_available(),
                    reason="no reference and no oracle recordings")
def test_tacotron_energy_matches_oracle(stft_golden):
    from tts_king_torch.ops.stft import MelExtractor

    y, golden = stft_golden
    _, energy = MelExtractor().mel_and_energy(torch.from_numpy(y))
    np.testing.assert_allclose(energy.numpy(), golden["tacotron_energy"],
                               rtol=1e-3, atol=1e-3)


def test_mel_filterbank_equals_jax():
    """Bit-equal to the JAX package's, with librosa's structure: shape,
    non-negativity, Slaney area normalization, monotonic peaks."""
    from tts_king_torch.ops.mel import hz_to_mel, mel_filterbank, mel_to_hz
    from tts_king_tpu.ops.mel import mel_filterbank as jax_filterbank

    fb = mel_filterbank(22050, 1024, 80, 0.0, 8000.0)
    np.testing.assert_array_equal(fb, jax_filterbank(22050, 1024, 80, 0.0,
                                                     8000.0))
    assert fb.shape == (80, 513) and (fb >= 0).all()
    assert (np.diff(fb.argmax(axis=1)) >= 0).all()
    df = 22050 / 2 / 512
    areas = fb.sum(axis=1) * df
    assert np.all(areas[5:-1] > 0.5) and np.all(areas[5:-1] < 1.5)
    f = np.array([0.0, 200.0, 999.0, 1000.0, 4000.0, 8000.0])
    np.testing.assert_allclose(mel_to_hz(hz_to_mel(f)), f, rtol=1e-6,
                               atol=1e-6)


def test_mel_and_hifigan_mel_match_jax():
    from tts_king_torch.ops import stft
    from tts_king_tpu.ops import stft as jstft

    rng = np.random.RandomState(1)
    y = (0.3 * rng.randn(2, 6000)).astype(np.float32)
    mel, energy = stft.MelExtractor().mel_and_energy(torch.from_numpy(y))
    jmel, jenergy = jstft.MelExtractor().mel_and_energy(y)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(energy.numpy(), np.asarray(jenergy),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(stft.hifigan_mel(torch.from_numpy(y)).numpy(),
                               np.asarray(jstft.hifigan_mel(y)), rtol=1e-4,
                               atol=1e-4)


def test_mel_matches_float64_stft(golden_corpus):
    """The bound of chip_smoke.compare_feature_trees on the mel: the port's
    and the JAX package's f32 log-mels of a corpus utterance (bucket-padded
    as the Preprocessor pads it) against a float64 numpy STFT, in the
    linear domain at rtol MEL_RTOL plus MEL_FRAME_ATOL of the frame's
    largest bin. Near the 1e-5 clip either f32 log-mel is several 1e-4 off
    the float64 one, so a flat log-mel atol of 1e-4 cannot hold."""
    from chip_smoke import MEL_FRAME_ATOL, MEL_RTOL
    from tts_king_torch.data.features import WAV_BUCKET_STEP, load_wav
    from tts_king_torch.ops.mel import mel_filterbank
    from tts_king_torch.ops.stft import MelExtractor, _hann_window
    from tts_king_tpu.ops.stft import MelExtractor as JaxMelExtractor

    wav = load_wav(os.path.join(golden_corpus[0], "spk_00", "utt0001.wav"),
                   SR)
    n = -(-len(wav) // WAV_BUCKET_STEP) * WAV_BUCKET_STEP
    x = np.zeros((1, n), np.float32)
    x[0, : len(wav)] = wav
    y = np.pad(x[0].astype(np.float64), (512, 512), mode="reflect")
    idx = (np.arange(1 + (len(y) - 1024) // HOP)[:, None] * HOP
           + np.arange(1024)[None])
    mag = np.abs(np.fft.rfft(y[idx] * _hann_window(1024, 1024), axis=-1))
    want = np.maximum(mag @ mel_filterbank(SR, 1024, 80, 0.0, 8000.0
                                           ).astype(np.float64).T, 1e-5)
    bound = MEL_RTOL * want + MEL_FRAME_ATOL * want.max(-1, keepdims=True)
    port = MelExtractor().mel_and_energy(torch.from_numpy(x))[0].numpy()[0]
    jax_mel = np.asarray(JaxMelExtractor().mel_and_energy(x)[0])[0]
    for name, got in (("port", port), ("jax", jax_mel)):
        assert (np.abs(np.exp(got) - want) <= bound).all(), name
        print(f"{name}: log-mel max error {np.abs(got - np.log(want)).max()}"
              f" against float64")


def test_istft_round_trip():
    from tts_king_torch.ops.stft import (_hann_window, frame_signal, istft,
                                         reflect_pad)

    t = np.arange(8192) / 22050
    y = torch.from_numpy(
        (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)[None])
    window = torch.from_numpy(_hann_window(1024, 1024))
    spec = torch.fft.rfft(frame_signal(reflect_pad(y, 512, 512), 1024, 256)
                          * window, dim=-1)
    rec = istft(spec, 1024, 256, 1024).numpy()
    n = min(rec.shape[1], y.shape[1])
    # interior matches closely (edges lose energy to windowing)
    np.testing.assert_allclose(rec[0, 1024 : n - 1024],
                               y.numpy()[0, 1024 : n - 1024], atol=5e-3)


def test_griffin_lim_recovers_tone():
    from tts_king_torch.ops.stft import griffin_lim, stft_magnitude

    t = np.arange(8192) / 22050
    y = torch.from_numpy(
        (0.6 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)[None])
    rec = griffin_lim(stft_magnitude(y, 1024, 256, 1024), n_iters=8).numpy()
    spec = np.abs(np.fft.rfft(rec[0] * np.hanning(len(rec[0]))))
    freq = np.fft.rfftfreq(len(rec[0]), 1 / 22050)[spec.argmax()]
    assert abs(freq - 440) < 15, freq


@pytest.mark.parametrize("n", [100, 257, 400])
def test_transform_cwt_matches_jax(n):
    from tts_king_torch.ops.cwt import transform_cwt
    from tts_king_tpu.ops.cwt import transform_cwt as jax_cwt

    sig = np.random.RandomState(n).randn(3, n).astype(np.float32)
    got = transform_cwt(sig).numpy()
    assert got.shape == (3, n, 11)
    np.testing.assert_allclose(got, np.asarray(jax_cwt(sig)), rtol=1e-4,
                               atol=1e-5)


def test_cwt_forward_inverse_consistency():
    """Mexican-hat CWT -> weighted recomposition correlates strongly with
    the (standardized) input, the property the pitch path relies on."""
    from tts_king_torch.ops.cwt import inverse_cwt, transform_cwt

    t = np.linspace(0, 4, 400)
    sig = np.sin(2 * np.pi * 1.3 * t) + 0.5 * np.sin(2 * np.pi * 5.7 * t)
    sig = ((sig - sig.mean()) / sig.std()).astype(np.float32)
    coefs = transform_cwt(sig)
    assert tuple(coefs.shape) == (400, 11)
    rec = inverse_cwt(coefs).numpy()
    assert np.corrcoef(rec[30:-30], sig[30:-30])[0, 1] > 0.85


def test_cwt_batched_matches_single():
    from tts_king_torch.ops.cwt import transform_cwt

    sig = np.random.RandomState(1).randn(3, 100).astype(np.float32)
    batched = transform_cwt(sig).numpy()
    for b in range(3):
        np.testing.assert_allclose(batched[b], transform_cwt(sig[b]).numpy(),
                                   rtol=1e-4, atol=1e-5)


# -------------------------------------------------------------------- F0


def _harmonic(f0_hz, seconds=1.0, seed=0):
    t = np.arange(int(SR * seconds)) / SR
    phase = 2 * np.pi * f0_hz * t
    wav = (0.5 * np.sin(phase) + 0.35 * np.sin(2 * phase)
           + 0.1 * np.sin(3 * phase)
           + 0.01 * np.random.RandomState(seed).randn(len(t)))
    return wav.astype(np.float32)


def _vibrato(dur=1.2, f0=120.0, depth=6.0, rate=5.0, silence=0.1):
    """tests/test_f0_parity.py's vibrato: a sung 120 Hz with a leading
    silence."""
    t = np.arange(int(SR * dur)) / SR
    f0_true = f0 + depth * np.sin(2 * np.pi * rate * t)
    phase = 2 * np.pi * np.cumsum(f0_true) / SR
    wav = (0.6 * np.sin(phase) + 0.3 * np.sin(2 * phase)
           + 0.15 * np.sin(3 * phase)).astype(np.float32)
    ns = int(silence * SR)
    wav[:ns] = 0.001 * np.random.RandomState(0).randn(ns)
    return wav, f0_true, ns


def yin_agreement(got, want):
    """(share of frames whose voicing agrees, share of the frames both
    voice whose F0 agrees within 0.1% relative)."""
    same = (got > 0) == (want > 0)
    both = (got > 0) & (want > 0)
    close = np.abs(got - want)[both] <= 1e-3 * want[both]
    return float(same.mean()), float(close.mean()) if both.any() else 0.0


@pytest.mark.parametrize("signal", ["90", "150", "220", "400", "vibrato"])
def test_yin_matches_jax(signal):
    from tts_king_torch.ops.f0 import yin_f0
    from tts_king_tpu.ops.f0 import yin_f0 as jax_yin

    if signal == "vibrato":
        wav = _vibrato()[0]
    else:
        wav = _harmonic(float(signal), seed=int(signal))
    wavs = np.stack([wav, 0.5 * wav[::-1]])
    got = yin_f0(torch.from_numpy(wavs), SR, HOP).numpy()
    want = np.asarray(jax_yin(wavs, SR, HOP))
    assert got.shape == want.shape == (2, len(wav) // HOP + 1)
    voicing, close = yin_agreement(got, want)
    assert voicing >= 0.99 and close >= 0.99, (voicing, close)
    assert (got > 0).mean() > 0.5


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"native toolchain unavailable: {native.build_error()}")
    return native.get_lib()


def test_native_library_builds_outside_the_sources(lib):
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.build_dir()
    assert native.build_dir().endswith(os.path.join("build", "native"))


def test_native_yin_matches_port_yin(lib):
    from tts_king_torch.ops.f0 import yin_f0

    t = np.arange(3 * 4096) / SR
    wav = (0.6 * np.sin(2 * np.pi * 180 * t)
           + 0.2 * np.sin(2 * np.pi * 360 * t)).astype(np.float32)
    f0_native = native.yin_f0(wav, SR, HOP)
    f0_port = yin_f0(torch.from_numpy(wav[None]), SR, HOP).numpy()[0]
    assert len(f0_native) == len(f0_port)
    voiced_n, voiced_p = f0_native > 0, f0_port > 0
    assert np.mean(voiced_n == voiced_p) > 0.9
    both = voiced_n & voiced_p
    assert both.sum() > 10
    np.testing.assert_allclose(f0_native[both], f0_port[both], rtol=0.02)
    assert 170 < np.median(f0_native[voiced_n]) < 190


def test_native_yin_batch(lib):
    t = np.arange(8192) / SR
    wavs = [(0.5 * np.sin(2 * np.pi * f * t[:n])).astype(np.float32)
            for f, n in [(150, 8192), (250, 6000), (330, 4000)]]
    f0s = native.yin_f0_batch(wavs, SR, HOP, n_threads=2)
    assert len(f0s) == 3
    for f_target, f0 in zip([150, 250, 330], f0s):
        voiced = f0[f0 > 0]
        assert len(voiced) > 5
        assert abs(np.median(voiced) - f_target) < 8


def test_npy_batch_loader(lib, tmp_path):
    rng = np.random.RandomState(0)
    paths, refs = [], []
    specs = [((37, 80), np.float32), ((54, 80), np.float64),
             ((20,), np.int64), ((), np.float32)]
    for i, (shape, dtype) in enumerate(specs):
        arr = np.asarray(rng.randn(*shape) * 10).astype(dtype)
        p = tmp_path / f"a{i}.npy"
        np.save(p, arr)
        paths.append(str(p))
        refs.append(arr)
    batch, lengths = native.load_npy_batch(paths, max_rows=60, cols=80,
                                           n_threads=2)
    assert batch.shape == (4, 60, 80)
    assert lengths.tolist() == [37, 54, 20, 1]
    np.testing.assert_allclose(batch[0, :37], refs[0], rtol=1e-6)
    np.testing.assert_allclose(batch[1, :54], refs[1].astype(np.float32),
                               rtol=1e-6)
    np.testing.assert_allclose(batch[2, :20, 0], refs[2].astype(np.float32))
    assert np.all(batch[2, :20, 1:] == 0)
    np.testing.assert_allclose(batch[3, 0, 0], refs[3])
    assert np.all(batch[0, 37:] == 0)


def test_npy_loader_fortran_order(lib, tmp_path):
    """np.save writes fortran_order=True for F-contiguous arrays; the loader
    reads them as np.load does."""
    c_arr = np.random.RandomState(1).randn(27, 11).astype(np.float32)
    f_arr = np.asfortranarray(c_arr)
    p_c, p_f = tmp_path / "c.npy", tmp_path / "f.npy"
    np.save(p_c, c_arr)
    np.save(p_f, f_arr)
    with open(p_f, "rb") as fh:
        assert b"'fortran_order': True" in fh.read(80)
    batch, lengths = native.load_npy_batch([str(p_c), str(p_f)], max_rows=40,
                                           cols=11)
    assert lengths.tolist() == [27, 27]
    np.testing.assert_array_equal(batch[0], batch[1])
    np.testing.assert_allclose(batch[1, :27], c_arr, rtol=1e-6)
    batch2, lengths2 = native.load_npy_batch([str(p_f)], max_rows=20, cols=7)
    assert lengths2.tolist() == [20]
    np.testing.assert_allclose(batch2[0], c_arr[:20, :7], rtol=1e-6)


def test_npy_loader_missing_file(lib, tmp_path):
    batch, lengths = native.load_npy_batch([str(tmp_path / "nope.npy")],
                                           max_rows=4, cols=4)
    assert lengths[0] == -1
    assert np.all(batch == 0)


def test_dio_equals_jax_native(lib):
    """The port's copy of dio.cpp and f0.cpp, built with the same flags,
    gives the JAX package's F0 bit for bit, alone and batched."""
    from tts_king_tpu import native as jax_native

    if not jax_native.available():
        pytest.skip("the JAX package's native library does not build")
    wav, _, _ = _vibrato()
    wavs = [wav, _harmonic(220.0, 0.6)]
    np.testing.assert_array_equal(native.dio_f0(wav, SR, HOP),
                                  jax_native.dio_f0(wav, SR, HOP))
    np.testing.assert_array_equal(native.yin_f0(wav, SR, HOP),
                                  jax_native.yin_f0(wav, SR, HOP))
    for a, b in zip(native.dio_f0_batch(wavs, SR, HOP),
                    jax_native.dio_f0_batch(wavs, SR, HOP)):
        np.testing.assert_array_equal(a, b)


def test_dio_ground_truth_vibrato(lib):
    wav, f0_true, ns = _vibrato()
    f0 = native.dio_f0(wav, SR, HOP)
    frames = np.arange(len(f0)) * HOP
    truth = np.where(frames < ns, 0.0, np.interp(
        frames, np.arange(len(wav)),
        np.pad(f0_true, (0, 1), mode="edge")[:len(wav)]))
    voiced = (f0 > 0) & (truth > 0)
    assert voiced.sum() >= 0.9 * (truth > 0).sum(), "missed voiced frames"
    cents = 1200 * np.log2(f0[voiced] / truth[voiced])
    assert np.median(np.abs(cents)) < 10.0
    assert np.percentile(np.abs(cents), 95) < 30.0
    assert np.all(f0[frames < ns - HOP] == 0.0)   # no voicing in the silence


@pytest.mark.parametrize("f0_hz", [90.0, 220.0, 400.0])
def test_dio_ground_truth_across_registers(lib, f0_hz):
    t = np.arange(int(SR * 0.8)) / SR
    phase = 2 * np.pi * f0_hz * t
    wav = (0.5 * np.sin(phase) + 0.35 * np.sin(2 * phase)
           + 0.1 * np.sin(3 * phase)).astype(np.float32)
    core = native.dio_f0(wav, SR, HOP)[3:-3]
    voiced = core[core > 0]
    assert len(voiced) >= 0.9 * len(core)
    assert np.median(np.abs(1200 * np.log2(voiced / f0_hz))) < 10.0


@pytest.mark.parametrize("snr_db", [20.0, 10.0])
def test_dio_noise_robustness(lib, snr_db):
    rng = np.random.RandomState(3)
    t = np.arange(int(SR * 0.8)) / SR
    phase = 2 * np.pi * 180.0 * t
    clean = (0.5 * np.sin(phase) + 0.3 * np.sin(2 * phase)
             + 0.1 * np.sin(3 * phase))
    noise = rng.randn(len(t)) * np.sqrt(np.mean(clean ** 2)
                                        / (10 ** (snr_db / 10)))
    core = native.dio_f0((clean + noise).astype(np.float32), SR, HOP)[3:-3]
    voiced = core[core > 0]
    assert len(voiced) >= 0.8 * len(core)
    assert np.median(np.abs(1200 * np.log2(voiced / 180.0))) < 20.0


@pytest.mark.parametrize("f0_hz", [60.0, 70.0, 80.0])
def test_dio_low_f0(lib, f0_hz):
    """Low registers with the floor lowered below the default 71 Hz."""
    t = np.arange(int(SR * 1.0)) / SR
    phase = 2 * np.pi * f0_hz * t
    wav = (0.5 * np.sin(phase) + 0.35 * np.sin(2 * phase)
           + 0.15 * np.sin(3 * phase)).astype(np.float32)
    core = native.dio_f0(wav, SR, HOP, f0_floor=50.0)[5:-5]
    voiced = core[core > 0]
    assert len(voiced) >= 0.85 * len(core)
    cents = np.abs(1200 * np.log2(voiced / f0_hz))
    assert np.median(cents) < 15.0 and np.percentile(cents, 95) < 100.0


def test_dio_octave_jump(lib):
    t = np.arange(int(SR * 0.5)) / SR

    def tone(f):
        return (0.5 * np.sin(2 * np.pi * f * t)
                + 0.3 * np.sin(4 * np.pi * f * t)
                + 0.1 * np.sin(6 * np.pi * f * t))

    wav = np.concatenate([tone(140.0), tone(280.0)]).astype(np.float32)
    f0 = native.dio_f0(wav, SR, HOP)
    half, margin = len(f0) // 2, 6
    lo, hi = f0[3 : half - margin], f0[half + margin : -3]
    lo_v, hi_v = lo[lo > 0], hi[hi > 0]
    assert len(lo_v) >= 0.85 * len(lo) and len(hi_v) >= 0.85 * len(hi)
    assert abs(1200 * np.log2(np.median(lo_v) / 140.0)) < 50.0
    assert abs(1200 * np.log2(np.median(hi_v) / 280.0)) < 50.0


def test_dio_default_floor_rejects_subsonic(lib):
    t = np.arange(int(SR * 0.8)) / SR
    f0 = native.dio_f0((0.6 * np.sin(2 * np.pi * 55.0 * t)).astype(
        np.float32), SR, HOP)
    assert (f0[f0 > 0] >= 71.0 - 1e-3).all()


def test_pitch_backend_choice(tmp_path):
    """"auto" keeps the JAX package's order and gives the same answer
    here; a backend asked for by name that cannot run raises; the device
    defaults to the card."""
    from tts_king_torch.config import PreprocessConfig
    from tts_king_torch.data.features import (Preprocessor,
                                              resolve_pitch_backend)
    from tts_king_tpu.config import PreprocessConfig as JaxPreprocessConfig
    from tts_king_tpu.data.features import Preprocessor as JaxPreprocessor

    pp = PreprocessConfig(raw_path=str(tmp_path),
                          preprocessed_path=str(tmp_path))
    got = Preprocessor(pp, device="cpu").pitch_backend
    want = JaxPreprocessor(JaxPreprocessConfig(
        raw_path=str(tmp_path), preprocessed_path=str(tmp_path))
    ).pitch_backend
    assert got == want
    try:
        import pyworld  # noqa: F401
    except ImportError:
        assert got == ("native" if native.available() else "yin")
        with pytest.raises(RuntimeError, match="pyworld"):
            resolve_pitch_backend("pyworld")
    with pytest.raises(ValueError, match="pitch_backend"):
        resolve_pitch_backend("crepe")
    assert resolve_pitch_backend("yin") == "yin"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Preprocessor(pp)


# ---------------------------------------------------------- Preprocessor


def _prepare(raw, out, backend, device="cpu", jax=False):
    """TTSConfig()'s preprocessing (22,050 Hz, 1024/256/1024, 80 mels,
    fmax 8 kHz) of ``raw`` into ``out`` by either package."""
    if jax:
        from tts_king_tpu.config import TTSConfig
        from tts_king_tpu.data.features import Preprocessor

        kw = {}
    else:
        from tts_king_torch.config import TTSConfig
        from tts_king_torch.data.features import Preprocessor

        kw = {"device": device}
    cfg = TTSConfig()
    cfg.preprocess.raw_path, cfg.preprocess.preprocessed_path = raw, out
    Preprocessor(cfg.preprocess, pitch_backend=backend, **kw
                 ).build_from_path(seed=cfg.train.seed)
    return feature_tree(out)


@pytest.fixture(scope="module")
def golden_corpus(tmp_path_factory):
    """The golden's seeded corpus (2 speakers x 3 utterances), written by
    the port's generate_corpus, and the golden tree of the JAX
    Preprocessor (YIN)."""
    from tts_king_torch.data.synthetic import generate_corpus

    z = np.load(GOLDEN_FEATURES)
    corpus = json.loads(str(z["meta::corpus"]))
    raw = str(tmp_path_factory.mktemp("golden_corpus"))
    generate_corpus(raw, **corpus)
    tree = {k[len("tree::"):]: str(z[k]) if z[k].dtype.kind == "U" else z[k]
            for k in z.files if k.startswith("tree::")}
    return raw, corpus, tree


def test_generate_corpus_is_byte_identical_to_jax(golden_corpus, tmp_path):
    import filecmp

    from tts_king_tpu.data.synthetic import generate_corpus

    raw, corpus, _ = golden_corpus
    total = generate_corpus(str(tmp_path), **corpus)
    assert total > 0
    for spk in sorted(os.listdir(raw)):
        names = sorted(os.listdir(os.path.join(raw, spk)))
        assert names == sorted(os.listdir(tmp_path / spk))
        _, mismatch, errors = filecmp.cmpfiles(
            os.path.join(raw, spk), str(tmp_path / spk), names, shallow=False)
        assert not mismatch and not errors, (mismatch, errors)


def test_preprocessor_native_matches_jax(golden_corpus, tmp_path):
    """The native DIO backend: the same F0 on both sides, so metadata and
    durations identical, the linear mel at rtol 1e-4 plus 1e-6 of its
    frame's largest bin (chip_smoke.MEL_RTOL), energy at rtol/atol 1e-4, the
    F0 files and stats.json at rtol 1e-4 / atol 1e-5."""
    if not native.available():
        pytest.skip("native toolchain unavailable")
    raw = golden_corpus[0]
    got = _prepare(raw, str(tmp_path / "port"), "native")
    want = _prepare(raw, str(tmp_path / "jax"), "native", jax=True)
    summary = compare_feature_trees(got, want, yin=False)
    assert summary["utterances"] == 6


def test_preprocessor_yin_matches_jax_golden(golden_corpus, tmp_path):
    """The YIN backend against the committed golden of the JAX
    Preprocessor (scripts/export_cwt_features_golden.py): metadata,
    durations, mel and energy as with DIO; frame-pitch to the YIN bounds;
    the F0-derived files at rtol 1e-3 where an utterance's voicing agrees
    on all frames, at most one of the six with a flipped frame."""
    raw, _, want = golden_corpus
    got = _prepare(raw, str(tmp_path / "port"), "yin")
    summary = compare_feature_trees(got, want, yin=True)
    print(f"YIN: {summary['flipped_utterances']} of {summary['utterances']} "
          f"utterances with a flipped frame, voicing agrees on "
          f"{summary['voicing_agree']:.4%} of frames")
    assert summary["utterances"] == 6 and summary["flipped_utterances"] <= 1


# ---------------------------------- tests/test_data_pipeline.py mirrored


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_data_pipeline.py's corpus (2 speakers x 2 sine
    utterances, fabricated alignments) through the port's Preprocessor."""
    from tts_king_torch.config import PreprocessConfig
    from tts_king_torch.data.features import Preprocessor

    root = tmp_path_factory.mktemp("corpus")
    raw, processed = str(root / "raw"), str(root / "processed")
    os.makedirs(raw)
    _make_corpus(raw)
    cfg = PreprocessConfig(raw_path=raw, preprocessed_path=processed,
                           val_size=1)
    return cfg, Preprocessor(cfg, batch_size=4, device="cpu"
                             ).build_from_path()


def test_preprocessor_outputs(corpus):
    cfg, out = corpus
    root = cfg.preprocessed_path
    assert len(out) == 4
    with open(os.path.join(root, "speakers.json")) as f:
        assert json.load(f) == {"spk_a": 0, "spk_b": 1}
    with open(os.path.join(root, "stats.json")) as f:
        stats = json.load(f)
    assert stats["pitch"][0] < 0 < stats["pitch"][1]
    assert stats["energy"][0] < 0 < stats["energy"][1]
    files = sorted(os.listdir(os.path.join(root, "mel")))
    assert len(files) == 4
    mel = np.load(os.path.join(root, "mel", files[0]))
    name = files[0].replace("spk_a-mel-", "").replace(".npy", "")
    dur = np.load(os.path.join(root, "duration", f"spk_a-duration-{name}.npy"))
    assert len(dur) == 5     # P A0 sp T A after silence trimming
    assert mel.shape == (dur.sum(), 80)
    pitch = np.load(os.path.join(root, "pitch", f"spk_a-pitch-{name}.npy"))
    assert pitch.shape == (5,)
    cwt = np.load(os.path.join(root, "pitch", f"spk_a-cwt-pitch-{name}.npy"))
    assert cwt.shape == (5, 11) and cwt.flags.c_contiguous
    with open(os.path.join(root, "train.txt")) as f:
        train_lines = f.read().strip().split("\n")
    with open(os.path.join(root, "val.txt")) as f:
        val_lines = f.read().strip().split("\n")
    assert len(train_lines) == 3 and len(val_lines) == 1
    assert train_lines[0].count("|") == 3 and "{" in train_lines[0]


def test_f0_sanity(corpus):
    """YIN recovers the synthetic fundamental (150 Hz for spk_a)."""
    from tts_king_torch.data.features import load_wav
    from tts_king_torch.ops.f0 import yin_f0

    cfg, _ = corpus
    wav = load_wav(os.path.join(cfg.raw_path, "spk_a", "utt0.wav"), 22050)
    f0 = yin_f0(torch.from_numpy(wav[None, :]), 22050, 256).numpy()[0]
    voiced = f0[f0 > 0]
    assert len(voiced) > 10
    assert 140 < np.median(voiced) < 160


def test_dataset_and_train_step(corpus, tmp_path):
    """Prepare, then train a micro CWT FastSpeech2 for 2 steps through
    train() on the prepared tree: finite losses, the CWT mean and std terms
    among them."""
    from tts_king_torch import config as pcfg
    from tts_king_torch.train.loop import train

    cfg, _ = corpus
    tts = pcfg.TTSConfig(
        preprocess=cfg,
        model=pcfg._build(pcfg.ModelConfig, dict(TINY_MODEL, use_cwt=True)),
        train=pcfg.TrainConfig(
            ckpt_path=str(tmp_path / "ckpt"),
            result_path=str(tmp_path / "result"),
            optimizer=pcfg.OptimizerConfig(batch_size=1, grad_acc_step=2),
            step=pcfg.StepConfig(total_step=2, log_step=1, val_step=2,
                                 save_step=2),
            objective_val_utts=1))
    state = train(tts, device="cpu")
    assert state.step == 2
    with open(os.path.join(tts.train.result_path,
                           f"{tts.exp_name}.metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train_recs = [r for r in recs if r["phase"] == "train"]
    assert len(train_recs) == 2
    for r in train_recs:
        assert np.isfinite(r["total"]) and r["pitch_mean"] > 0
    assert any(r["phase"] == "val" for r in recs)


def test_grapheme_masking():
    from tts_king_torch.data.dataset import random_mask
    from tts_king_torch.text.symbols import MASK

    rng = np.random.RandomState(0)
    phones = ["P", "A0", "T", "A", "sp", "V", "E0", "T", "K", "O"] * 3
    masked = random_mask(phones, 0.15, rng)
    assert len(masked) == len(phones)
    assert 1 <= sum(1 for p in masked if p == MASK) <= int(0.15 * len(phones))
    assert "sp" in masked


def _datasets(cfg, **kw):
    from tts_king_torch.config import OptimizerConfig, TrainConfig
    from tts_king_torch.data.dataset import FS2Dataset
    from tts_king_tpu.config import OptimizerConfig as JOpt
    from tts_king_tpu.config import PreprocessConfig as JPre
    from tts_king_tpu.config import TrainConfig as JTrain
    from tts_king_tpu.data.dataset import FS2Dataset as JaxDataset

    port = FS2Dataset("train.txt", cfg, TrainConfig(
        optimizer=OptimizerConfig(batch_size=1, grad_acc_step=1)),
        max_mel_len=64, **kw)
    ref = JaxDataset("train.txt", JPre(**dataclasses.asdict(cfg)), JTrain(
        optimizer=JOpt(batch_size=1, grad_acc_step=1)), max_mel_len=64,
        use_native_loader=False)
    return port, ref


def test_superbatch_fast_forward_and_count(corpus):
    cfg, _ = corpus
    ds, _ = _datasets(cfg)
    full = list(ds.epoch_superbatches(seed=7))
    assert ds.superbatches_per_epoch() == len(full) == 3
    tail = list(ds.epoch_superbatches(seed=7, start_batch=2))
    assert len(tail) == 1
    for key in full[2]:
        np.testing.assert_array_equal(full[2][key], tail[0][key],
                                      err_msg=key)


def test_native_loader_matches_numpy_and_jax(corpus):
    """use_native_loader=None picks the native loader where the library
    builds; its superbatches equal the numpy collate's and the JAX
    FS2Dataset's exactly."""
    if not native.available():
        pytest.skip("native toolchain unavailable")
    cfg, _ = corpus
    port, ref = _datasets(cfg)
    assert port.use_native_loader
    plain, _ = _datasets(cfg, use_native_loader=False)
    for seed in (0, 3):
        a = list(port.epoch_superbatches(seed=seed))
        for other in (list(plain.epoch_superbatches(seed=seed)),
                      list(ref.epoch_superbatches(seed=seed))):
            assert len(a) == len(other) == 3
            for x, y in zip(a, other):
                assert x.keys() == y.keys()
                for k in x:
                    assert x[k].dtype == y[k].dtype, k
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# -------------------------------------------- tests/test_metrics.py mirrored


def test_f0_frame_metrics_match_jax():
    from tts_king_torch.train.metrics import f0_frame_metrics
    from tts_king_tpu.train.metrics import f0_frame_metrics as jax_metrics

    f0_gt = np.array([0.0, 100.0, 110.0, 120.0, 0.0, 0.0])
    f0_pred = np.array([0.0, 104.0, 110.0, 117.0, 130.0, 0.0])
    path = [(i, i) for i in range(6)]
    m = f0_frame_metrics(f0_pred, f0_gt, path)
    assert m["f0_rmse_hz"] == pytest.approx(np.sqrt((16 + 0 + 9) / 3))
    assert m["vuv_precision"] == pytest.approx(3 / 4)
    assert m["vuv_recall"] == pytest.approx(1.0)
    assert 0.8 < m["vuv_f1"] < 0.9
    assert m == jax_metrics(f0_pred, f0_gt, path)
    rng = np.random.RandomState(0)
    f0_pred = rng.rand(30) * 200 * (rng.rand(30) > 0.3)
    f0_gt = rng.rand(25) * 200 * (rng.rand(25) > 0.3)
    path = [(min(i, 29), min(i, 24)) for i in range(32)]
    assert f0_frame_metrics(f0_pred, f0_gt, path) == jax_metrics(
        f0_pred, f0_gt, path)


def test_frame_pitch_saved_by_preprocessor(corpus):
    cfg, _ = corpus
    root = cfg.preprocessed_path
    files = [f for f in os.listdir(os.path.join(root, "pitch"))
             if "frame-pitch" in f]
    assert len(files) == 4
    f0 = np.load(os.path.join(root, "pitch", files[0]))
    assert f0.ndim == 1 and (f0 > 0).sum() > 5
    assert 80 < np.median(f0[f0 > 0]) < 400


def test_evaluate_objective_matches_jax(corpus):
    """Free-running metrics of the same micro FastSpeech2 in both packages
    on the prepared corpus, mel-only and with a vocoder and an F0 tracker
    (the F0-RMSE and V/UV branch reads the frame-pitch files)."""
    import jax
    import jax.numpy as jnp

    from tts_king_torch.train.metrics import evaluate_objective
    from tts_king_tpu.train.metrics import evaluate_objective as jax_eval

    cfg, _ = corpus
    ds, ref = _datasets(cfg)
    variables = cwt_variables(TINY_MODEL)
    model = port_model_no_dropout(TINY_MODEL, variables)

    def vocode_fn(mel):
        t = np.arange(mel.shape[0] * HOP) / SR
        return 0.5 * np.sin(2 * np.pi * 150.0 * t)

    def f0_fn(wav):
        return np.full(len(wav) // HOP, 150.0, np.float32)

    jvars = jax.tree.map(jnp.asarray, variables)
    for kw in ({}, {"vocode_fn": vocode_fn, "f0_fn": f0_fn}):
        got = evaluate_objective(model, ds, "cpu", max_utts=2,
                                 max_mel_len=64, **kw)
        want = jax_eval(_jax_model(TINY_MODEL), jvars, ref, max_utts=2,
                        max_mel_len=64, **kw)
        assert got.keys() == want.keys()
        assert got["n_utts"] >= 1
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)
    assert np.isfinite(got["f0_rmse_hz"]) and 0.0 <= got["vuv_f1"] <= 1.0


# -------------------------------------- tests/test_corpus_tools.py mirrored


def _touch_wav(path, n=1000):
    wavfile.write(path, 22050, np.zeros(n, np.int16))


def test_ljspeech_layout(tmp_path):
    root = tmp_path / "ds" / "spk1" / "book1"
    (root / "wavs").mkdir(parents=True)
    with open(root / "metadata.csv", "w", encoding="utf-8") as f:
        f.write("utt1|Раз|Раз\nutt2|Ещё раз|ещё раз\n")
    _touch_wav(str(root / "wavs" / "utt1.wav"))
    _touch_wav(str(root / "wavs" / "utt2.wav"))
    out = tmp_path / "speakers"
    vocab = ct.ljspeech_to_speaker_layout(str(tmp_path / "ds"), str(out))
    assert os.path.exists(out / "spk1" / "utt1.wav")
    with open(out / "spk1" / "utt2.lab", encoding="utf-8") as f:
        assert f.read() == "ещйо раз"   # lowercased, ё -> йо
    assert "раз" in vocab


def test_strip_and_clean_vocab():
    assert ct.strip_non_cyrillic("привет, world 123!") == "привет"
    assert ct.clean_vocab(["длинноеслово", "да", "нет99!"]) == [
        "да", "нет", "длинноеслово"]


def test_labs_to_metadata(tmp_path):
    d = tmp_path / "spk"
    d.mkdir()
    (d / "a.lab").write_text("текст а\n", encoding="utf-8")
    (d / "b.lab").write_text("текст б", encoding="utf-8")
    with open(ct.labs_to_metadata_csv(str(d)), encoding="utf-8") as f:
        assert f.read().strip().split("\n") == ["a|текст а|текст а",
                                                "b|текст б|текст б"]


def test_remove_unaligned(tmp_path):
    spk = tmp_path / "c" / "spk"
    spk.mkdir(parents=True)
    for base in ("good", "bad"):
        _touch_wav(str(spk / f"{base}.wav"))
        (spk / f"{base}.lab").write_text("x")
    (tmp_path / "badlist.txt").write_text("bad\nmissing\n")
    assert ct.remove_unaligned(str(tmp_path / "c"),
                               str(tmp_path / "badlist.txt")) == 1
    assert not (spk / "bad.wav").exists() and (spk / "good.wav").exists()


def test_speaker_stats_and_filter(tmp_path):
    meta = tmp_path / "train.txt"
    lines = [f"utt{i}|spk_big|{{P A0 T}}|текст" for i in range(25)]
    lines.append("uttx|spk_small|{P A0}|текст")
    meta.write_text("\n".join(lines), encoding="utf-8")
    stats = ct.speaker_stats(str(meta))
    assert stats["spk_big"]["utterances"] == 25
    assert abs(stats["spk_big"]["mean_phones"] - 3) < 1e-6
    assert ct.filter_speakers(stats, min_utterances=20) == ["spk_big"]
    assert ct.filter_speakers(stats, min_utterances=20,
                              remove=["spk_big"]) == []


# ------------------------------------------------------------------- CLI


def test_cli_prepares_a_corpus(tmp_path):
    """python -m tts_king_torch.data cfg.yaml --device cpu writes the
    tree."""
    import yaml

    from tts_king_torch.config import TTSConfig
    from tts_king_torch.data.__main__ import main

    raw = tmp_path / "raw"
    raw.mkdir()
    _make_corpus(str(raw))
    cfg = TTSConfig()
    cfg.preprocess.raw_path = str(raw)
    cfg.preprocess.preprocessed_path = str(tmp_path / "processed")
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(dataclasses.asdict(cfg))), f)
    assert main([str(path), "--device", "cpu"]) == 0
    tree = feature_tree(cfg.preprocess.preprocessed_path)
    for name in ("train.txt", "val.txt", "speakers.json", "stats.json"):
        assert name in tree
    assert sum(k.startswith("mel") for k in tree) == 4
