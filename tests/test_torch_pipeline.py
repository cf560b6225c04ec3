"""The port's pipeline on the CPU: the whole slice (text -> phonemes -> FS2
-> HiFi-GAN -> int16) against the JAX TTSKing's frozen golden_e2e outputs,
the npz export of the golden weights, the pipeline's own rules (mel-bucket
escalation, the int16 wrap, CUDA by default), and the package's import ban.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
E2E_DIR = os.path.join(FIXTURES, "golden_e2e")
PORT_FIXTURES = os.path.join(FIXTURES, "torch_port")


def _port_config(jax_cfg):
    """The same TTSConfig, built with the port's own config module."""
    from tts_king_torch import config as port_config

    return port_config._build(port_config.TTSConfig,
                              dataclasses.asdict(jax_cfg)).validate()


@pytest.fixture(scope="module")
def e2e_restored():
    """The golden_e2e FS2 variables, restored from orbax as the JAX
    AcousticModel restores them."""
    from tts_king_tpu.checkpoint import restore_train_state

    payload = restore_train_state(os.path.join(E2E_DIR, "ckpt"))
    return {"params": payload["params"], "batch_stats": payload["batch_stats"]}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def test_golden_e2e_npz_equals_orbax_restore(e2e_restored):
    from tts_king_torch.weights import load_flax_npz

    got = dict(_flat(load_flax_npz(os.path.join(
        PORT_FIXTURES, "golden_e2e_variables.npz"))))
    ref = dict(_flat(e2e_restored))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))


@pytest.fixture(scope="module")
def port_king(e2e_restored):
    from tests.test_golden_e2e import micro_config
    from tts_king_torch.pipeline import TTSKing
    from tts_king_torch.weights import load_flax_npz

    voc = load_flax_npz(os.path.join(PORT_FIXTURES,
                                     "golden_e2e_vocoder_variables.npz"))
    return TTSKing(_port_config(micro_config()), device="cpu",
                   acoustic_variables=e2e_restored, vocoder_variables=voc)


@pytest.mark.parametrize("i", [0, 1])
def test_golden_e2e_speak_matches_jax(port_king, i):
    """Bounds of tests/test_golden_e2e.py: exact phonemes and mel_len, mel
    MAE < 1e-3, < 0.1% of int16 samples off by more than 2 LSB."""
    from tests.test_golden_e2e import SENTENCES

    z = np.load(os.path.join(E2E_DIR, "expected.npz"))
    text, dctl = SENTENCES[i]
    np.testing.assert_array_equal(port_king.text_preprocess(text),
                                  z[f"phonemes_{i}"])
    mel, mel_lens = port_king.generate_mel(text, duration_control=dctl,
                                           speaker=0)
    n = int(mel_lens[0])
    assert n == int(z[f"mel_len_{i}"])
    mel = mel.float().numpy()[0, :n]
    mae = float(np.mean(np.abs(mel - z[f"mel_{i}"])))
    assert mae < 1e-3, mae
    wav = port_king.mel_to_wav(mel[None], mel_lens=np.asarray([n]))[0]
    ref = z[f"wav_{i}"]
    assert wav.dtype == np.int16 and wav.shape == ref.shape
    off = float(np.mean(np.abs(wav.astype(np.int32) - ref.astype(np.int32))
                        > 2))
    assert off < 1e-3, off
    # speak() is generate_mel + mel_to_wav on the padded mel
    spoken = port_king.speak(text, duration_control=dctl)[0]
    assert spoken.shape == ref.shape


def test_wav_to_int16_wraps_like_numpy():
    from tts_king_torch.pipeline import wav_to_int16

    w = np.array([1.0, -1.0, 0.5, -0.5, 0.99999, 1.0001, 3e-5, -3e-5],
                 np.float32)
    got = wav_to_int16(torch.from_numpy(w), 32768.0).numpy()
    ref = (w * 32768.0).astype(np.int32).astype(np.int16)
    np.testing.assert_array_equal(got, ref)
    assert got[0] == -32768   # +1.0 wraps, it does not saturate at 32767
    assert got.dtype == np.int16


def _micro_acoustic(**kw):
    from tts_king_torch.config import micro_config
    from tts_king_torch.pipeline import AcousticModel

    return AcousticModel(micro_config(), device="cpu", **kw)


def test_mel_bucket_escalates_on_raw_length():
    am = _micro_acoustic()
    head = am.model.variance_adaptor.duration_predictor.linear_layer
    with torch.no_grad():   # logd = 3 everywhere: round(e^3 - 1) = 19 frames
        head.weight.zero_()
        head.bias.fill_(3.0)
    phonemes = np.arange(1, 11)[None]   # L = 10: first guess is bucket 128
    out = am.generate(phonemes)
    assert out["mel_bucket"] == 256
    assert int(out["mel_lens_raw"][0]) == 190
    assert int(out["mel_lens"][0]) == 190
    assert out["postnet_mel"].shape == (1, 256, 80)
    pinned = am.generate(phonemes, max_mel_len=128)
    assert pinned["mel_bucket"] == 128
    assert int(pinned["mel_lens"][0]) == 128      # clamped to the bucket
    assert int(pinned["mel_lens_raw"][0]) == 190


def test_ragged_batch_and_speakers():
    am = _micro_acoustic(n_speakers=3)
    phonemes = np.array([[5, 6, 7, 8, 9], [5, 6, 7, 0, 0]])
    out = am.generate(phonemes, speaker_name=[0, 2], src_lens=[5, 3])
    one = am.generate(phonemes[1:, :3], speaker_name=2)
    n = int(one["mel_lens"][0])
    assert int(out["mel_lens"][1]) == n
    np.testing.assert_allclose(out["postnet_mel"][1, :n].numpy(),
                               one["postnet_mel"][0, :n].numpy(), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError):
        am.generate(phonemes, speaker_name=[0, 1, 2])


def _seeded_fs2_variables(cfg, n_speakers, seed=0):
    """Seeded numpy FS2 weights in the flax layout (BatchNorm running stats
    included), with a duration head that gives each phoneme ~5 frames."""
    import math

    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.weights import seeded_state_dict, torch_to_flax

    stats = {"pitch": [-3.0, 9.5], "energy": [-1.5, 6.1]}
    with torch.device("meta"):
        module = build_fastspeech2(cfg.model, stats, n_speakers)
    variables = torch_to_flax(seeded_state_dict(module, seed))
    head = variables["params"]["variance_adaptor"]["duration_predictor"]
    head["linear_layer"]["kernel"] *= 0.1
    head["linear_layer"]["bias"][:] = math.log(6.0)
    return variables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_acoustic_model_dtype_matches_jax(dtype):
    """AcousticModel(dtype=...) against the JAX AcousticModel on the same
    seeded flax variables, a ragged batch of two speakers. In bf16 JAX
    rounds the variable tree (params and batch_stats) to bf16 and computes
    in f32 on it; the port must do the same: equal rounded durations and
    lengths, mels at golden_fs2's 1e-5."""
    import jax.numpy as jnp

    from tts_king_torch.config import micro_config
    from tts_king_torch.pipeline import AcousticModel
    from tts_king_tpu.config import micro_config as jax_micro_config
    from tts_king_tpu.pipeline import AcousticModel as JaxAcousticModel

    variables = _seeded_fs2_variables(micro_config(), 3)
    rng = np.random.RandomState(1)
    phonemes = rng.randint(1, 200, (3, 21))
    phonemes[1, 15:] = 0
    phonemes[2, 9:] = 0
    kw = dict(speaker_name=[0, 2, 1], src_lens=[21, 15, 9],
              duration_control=1.1)
    want = JaxAcousticModel(jax_micro_config(), variables, n_speakers=3,
                            dtype=getattr(jnp, dtype)).generate(phonemes,
                                                                **kw)
    am = AcousticModel(micro_config(), variables, n_speakers=3,
                       dtype=getattr(torch, dtype), device="cpu")
    got = am.generate(phonemes, **kw)
    assert got["mel_bucket"] == want["postnet_mel"].shape[1]
    for key in ("duration_rounded", "mel_lens", "mel_lens_raw"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert int(got["mel_lens"].min()) > 20
    for key in ("log_duration_prediction", "mel", "postnet_mel"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(),
                                   np.asarray(want[key], np.float32),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    # the sinusoid table and the variance bins are no variables: unrounded
    pos = am.model.encoder._pos(8, torch.device("cpu"), torch.float32)
    assert not torch.equal(pos, pos.to(torch.bfloat16).float())
    bins = am.model.variance_adaptor._bins["pitch"]
    assert not torch.equal(bins, bins.to(torch.bfloat16).float())


def test_bf16_fs2_bench_form_computes_in_bf16():
    """FastSpeech2 cast to bf16 (the JAX bench's build_fastspeech2(dtype=
    bf16)) stays reachable and computes in bf16."""
    from tts_king_torch.config import micro_config
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.weights import flax_to_torch, load_into

    cfg = micro_config()
    stats = {"pitch": [-3.0, 9.5], "energy": [-1.5, 6.1]}
    model = load_into(build_fastspeech2(cfg.model, stats, 3), flax_to_torch(
        _seeded_fs2_variables(cfg, 3))).to(torch.bfloat16).eval()
    texts = torch.from_numpy(np.random.RandomState(2).randint(1, 200, (2, 16)))
    with torch.no_grad():
        out = model(torch.tensor([0, 1]), texts, torch.tensor([16, 16]),
                    max_mel_len=128)
    assert out["postnet_mel"].dtype == torch.bfloat16
    assert bool(torch.isfinite(out["postnet_mel"].float()).all())


def test_attention_probs_bf16_refused_on_every_route():
    """The JAX XLA attention rounds the softmax probabilities to bf16 with
    attention_probs_bf16=True, at inference too; the port's FastSpeech2
    refuses the flag wherever it is built: AcousticModel (generate,
    speak, serving), TTSKing, and the training and evaluation paths."""
    from tts_king_torch.config import micro_config
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.pipeline import AcousticModel, TTSKing

    cfg = micro_config()
    cfg.model = dataclasses.replace(cfg.model, attention_probs_bf16=True)
    stats = {"pitch": [-3.0, 9.5], "energy": [-1.5, 6.1]}
    for make in (lambda: build_fastspeech2(cfg.model, stats, 1),
                 lambda: AcousticModel(cfg, device="cpu"),
                 lambda: TTSKing(cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match="attention_probs_bf16"):
            make()


def test_entry_points_default_to_cuda():
    """With no device argument the port asks for CUDA, and raises where
    there is none; the CPU is used only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tts_king_torch.config import micro_config
    from tts_king_torch.pipeline import AcousticModel, TTSKing, Vocoder

    for make in (AcousticModel, Vocoder, TTSKing):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(micro_config())


def test_unported_paths_raise(tmp_path):
    from tts_king_torch.config import micro_config
    from tts_king_torch.pipeline import AcousticModel, Vocoder

    cfg = micro_config()
    cfg.acoustic.weights_path = str(tmp_path)          # an orbax directory
    with pytest.raises(NotImplementedError, match="npz"):
        AcousticModel(cfg, device="cpu")
    cfg.vocoder.weights_path = str(tmp_path)
    with pytest.raises(NotImplementedError, match="npz"):
        Vocoder(cfg, device="cpu")


def test_npz_weights_path(tmp_path):
    """AcousticModel loads a var:: npz export given as weights_path."""
    from scripts.export_flax_variables import flatten_variables
    from tts_king_torch.config import micro_config
    from tts_king_torch.weights import torch_to_flax

    am = _micro_acoustic()
    path = tmp_path / "fs2.npz"
    np.savez(path, **flatten_variables(torch_to_flax(am.model.state_dict())))
    cfg = micro_config()
    cfg.acoustic.weights_path = str(path)
    from tts_king_torch.pipeline import AcousticModel

    am2 = AcousticModel(cfg, device="cpu")
    for k, v in am.model.state_dict().items():
        torch.testing.assert_close(am2.model.state_dict()[k], v, rtol=0,
                                   atol=0)


def test_port_config_and_text_match_jax_package():
    from tts_king_torch import config as port_config
    from tts_king_torch.text.g2p import preprocess_rus
    from tts_king_tpu import config as jax_config
    from tts_king_tpu.text.g2p import preprocess_rus as jax_preprocess_rus

    assert (dataclasses.asdict(port_config.TTSConfig())
            == dataclasses.asdict(jax_config.TTSConfig()))
    assert (dataclasses.asdict(port_config.micro_config())
            == dataclasses.asdict(jax_config.micro_config()))
    for text in ("привет мир", "В 2024 году, 15 мая — ещё 3 дня!",
                 "Съешь же ещё этих мягких французских булок."):
        np.testing.assert_array_equal(preprocess_rus(text),
                                      jax_preprocess_rus(text))


_BANNED = re.compile(r"\b(jax|flax|optax|orbax|tts_king_tpu)\b")
_IMPORT_LINE = re.compile(r"^\s*(import|from)\s", re.MULTILINE)
_DYNAMIC = re.compile(r"(import_module|__import__)\(\s*[\"'](jax|flax|optax|"
                      r"orbax|tts_king_tpu)\b")


def test_port_imports_nothing_of_jax():
    """No file of the port, and not chip_smoke.py, imports jax, flax,
    optax, orbax or tts_king_tpu (the JAX package is named in comments
    only)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tts_king_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        rel = os.path.relpath(path, REPO)
        for line in src.splitlines():
            if _IMPORT_LINE.match(line):
                assert not _BANNED.search(line), f"{rel}: {line.strip()}"
        assert not _DYNAMIC.search(src), rel


def test_chip_smoke_without_cuda_prints_no_result(capsys):
    """chip_smoke.py needs a card: without one it exits 1 and prints
    nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import chip_smoke

    assert chip_smoke.main() == 1
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    import shutil
    import subprocess
    import sys

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_chip_smoke_fused_stages_of_the_shipped_generator():
    import chip_smoke
    from tts_king_torch.config import TTSConfig, micro_config

    assert chip_smoke.fused_stages(TTSConfig(), 1000) == [
        (128, 64000), (64, 128000), (32, 256000)]
    assert len(chip_smoke.fused_stages(micro_config(), 10)) == 4
