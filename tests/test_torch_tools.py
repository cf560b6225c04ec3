"""The port's command-line tools and utilities on the CPU, against the JAX
package's scripts and modules: make_base_mels (raw-pitch and CWT models)
against scripts/make_base_mels.py, speaker_stats, evaluate (--objective)
and synthesize, synth_samples (with and without matplotlib) and
utils/profiling (tests/test_profiling.py mirrored)."""

import dataclasses
import glob
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from chip_smoke import GOLDEN_FEATURES, seeded_flax_variables
from tests.test_torch_train import TINY_MODEL
from tts_king_torch import config as pcfg
from tts_king_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    """A script of scripts/ imported by file path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_config(cfg):
    """The same TTSConfig in the JAX package's config module."""
    from tts_king_tpu import config as jcfg

    return jcfg._build(jcfg.TTSConfig, dataclasses.asdict(cfg)).validate()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The CWT features golden's seeded raw corpus (2 speakers x 3
    utterances, generate_corpus) through the JAX Preprocessor and the
    port's (native DIO on both, the F0 bit-equal): (raw, port tree, JAX
    tree)."""
    from tts_king_torch.data.features import Preprocessor
    from tts_king_torch.data.synthetic import generate_corpus
    from tts_king_tpu.data.features import Preprocessor as JaxPreprocessor

    if not native.available():
        pytest.skip("native toolchain unavailable")
    z = np.load(GOLDEN_FEATURES)
    root = tmp_path_factory.mktemp("tools_corpus")
    raw = str(root / "raw")
    generate_corpus(raw, **json.loads(str(z["meta::corpus"])))
    trees = {}
    for side in ("port", "jax"):
        pp = pcfg.PreprocessConfig(raw_path=raw, val_size=2,
                                   preprocessed_path=str(root / side))
        if side == "port":
            Preprocessor(pp, pitch_backend="native", device="cpu"
                         ).build_from_path()
        else:
            JaxPreprocessor(jax_config(pcfg.TTSConfig(preprocess=pp))
                            .preprocess, pitch_backend="native"
                            ).build_from_path()
        trees[side] = pp.preprocessed_path
    return raw, trees["port"], trees["jax"]


def tools_config(raw, processed, tmp, use_cwt=False):
    """The tiny FastSpeech2 (TINY_MODEL at max_seq_len 1000) on a prepared
    corpus."""
    model = dict(TINY_MODEL, max_seq_len=1000, use_cwt=use_cwt)
    return pcfg.TTSConfig(
        preprocess=pcfg.PreprocessConfig(raw_path=raw, val_size=2,
                                         preprocessed_path=processed),
        model=pcfg._build(pcfg.ModelConfig, model),
        train=pcfg.TrainConfig(ckpt_path=os.path.join(tmp, "ckpt"),
                               result_path=os.path.join(tmp, "result"),
                               optimizer=pcfg.OptimizerConfig(batch_size=2)))


def tools_variables(cfg, seed=5):
    """Seeded flax-layout weights of cfg's FastSpeech2 with the corpus's
    speakers, the duration head at about five frames a phoneme."""
    from tts_king_torch.models.fs2 import build_fastspeech2

    root = cfg.preprocess.preprocessed_path
    with open(os.path.join(root, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(root, "speakers.json")) as f:
        n_speakers = len(json.load(f))
    variables = seeded_flax_variables(lambda: build_fastspeech2(
        cfg.model, stats, n_speakers), seed)
    head = variables["params"]["variance_adaptor"]["duration_predictor"]
    head["linear_layer"]["kernel"] *= 0.1
    head["linear_layer"]["bias"][:] = np.log(6.0)
    return variables


def save_port_checkpoint(cfg, variables, step=7):
    """``variables`` as the port's train_state.pt under train.ckpt_path."""
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.train.checkpoint import save_train_state
    from tts_king_torch.train.state import Optimizer, TrainState
    from tts_king_torch.weights import flax_to_torch, load_into

    root = cfg.preprocess.preprocessed_path
    with open(os.path.join(root, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(root, "speakers.json")) as f:
        n_speakers = len(json.load(f))
    model = load_into(build_fastspeech2(cfg.model, stats, n_speakers),
                      flax_to_torch(variables))
    opt = Optimizer(cfg.train.optimizer, cfg.model.transformer.encoder_hidden)
    save_train_state(cfg.train.ckpt_path, step,
                     TrainState(model, opt.init(model), step))


def patch_jax_restore(monkeypatch, variables, step=7):
    """The JAX package's orbax restore, answering with ``variables``."""
    import tts_king_tpu.checkpoint as jax_checkpoint

    tree = {k: jax_tree(v) for k, v in variables.items()}

    def restore(path, step_=None):
        return {"params": tree["params"], "batch_stats": tree["batch_stats"],
                "step": step, "opt_state": None}

    monkeypatch.setattr(jax_checkpoint, "restore_train_state", restore)


def jax_tree(node):
    import jax.numpy as jnp

    if hasattr(node, "items"):
        return {k: jax_tree(v) for k, v in node.items()}
    return jnp.asarray(node)


# ------------------------------------------------------------ make_base_mels


@pytest.mark.parametrize("use_cwt", [False, True], ids=["raw_pitch", "cwt"])
def test_make_base_mels_matches_jax(corpus, tmp_path, monkeypatch, use_cwt):
    """The port's make_base_mels on the port's features against the JAX
    script on the JAX Preprocessor's, the same flax weights on both sides:
    the same files; mels at golden_fs2's 1e-5; wav slices within one int16
    step, T * hop samples each, T the ground-truth mel's frames."""
    from tts_king_torch.tools.make_base_mels import make_base_mels

    raw, port_tree, jax_tree_dir = corpus
    cfg = tools_config(raw, port_tree, str(tmp_path / "port"), use_cwt)
    variables = tools_variables(cfg)
    save_port_checkpoint(cfg, variables)
    got = make_base_mels(cfg, out=str(tmp_path / "port_out"), batch_size=4,
                         device="cpu")

    jcfg = jax_config(dataclasses.replace(
        cfg, preprocess=dataclasses.replace(
            cfg.preprocess, preprocessed_path=jax_tree_dir)))
    patch_jax_restore(monkeypatch, variables)
    want = jax_script("make_base_mels").make_base_mels(
        jcfg, out=str(tmp_path / "jax_out"), batch_size=4)

    hop = cfg.preprocess.stft.hop_length
    names = sorted(os.path.relpath(p, got) for p in
                   glob.glob(os.path.join(got, "*", "*")))
    assert names == sorted(os.path.relpath(p, want) for p in
                           glob.glob(os.path.join(want, "*", "*")))
    assert len(names) == 2 * 6
    for name in names:
        if name.endswith(".npy"):
            a, b = np.load(os.path.join(got, name)), np.load(
                os.path.join(want, name))
            assert a.shape == b.shape and a.shape[1] == 80, name
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            spk, utt = os.path.basename(name)[:-4].split("-", 1)
            gt = np.load(os.path.join(port_tree, "mel",
                                      f"{spk}-mel-{utt}.npy"))
            assert a.shape[0] == gt.shape[0]
        else:
            sr, a = wavfile.read(os.path.join(got, name))
            _, b = wavfile.read(os.path.join(want, name))
            assert sr == cfg.preprocess.audio.sampling_rate
            assert a.dtype == np.int16 and a.shape == b.shape
            n = np.load(os.path.join(got, "mels", os.path.basename(
                name)[:-4] + ".npy")).shape[0]
            assert len(a) == n * hop
            assert np.abs(a.astype(np.int32) - b).max() <= 1, name


# --------------------------------------------------------------- the CLIs


def _run_main(main, argv, capsys):
    assert main(argv) in (0, None)
    return capsys.readouterr().out


def test_speaker_stats_matches_jax(corpus, tmp_path, capsys, monkeypatch):
    from tts_king_torch.tools.speaker_stats import main

    _, port_tree, _ = corpus
    meta = os.path.join(port_tree, "train.txt")
    remove = tmp_path / "remove.txt"
    spk = sorted(os.listdir(os.path.join(port_tree, "mel")))[0].split(
        "-mel-")[0]
    remove.write_text(spk + "\n")
    for extra in ([], ["--min-utterances", "1", "--remove-list",
                       str(remove)]):
        got = _run_main(main, [meta, "--out", str(tmp_path / "a.txt"),
                               *extra], capsys)
        monkeypatch.setattr(sys, "argv", [
            "speaker_stats.py", meta, "--out", str(tmp_path / "b.txt"),
            *extra])
        jax_script("speaker_stats").main()
        want = capsys.readouterr().out
        assert got == want
        assert (tmp_path / "a.txt").read_text() == (
            tmp_path / "b.txt").read_text()
        last = json.loads(got.strip().splitlines()[-1])
        assert last["speakers"] == 2
    assert last["kept"] == 1


def test_evaluate_cli_matches_jax(corpus, tmp_path, capsys, monkeypatch):
    """The report of the port's evaluate against scripts/evaluate.py on the
    same weights: the same keys; the teacher-forced losses equal the port's
    train/evaluate.evaluate() exactly and JAX's at rtol 1e-4; --objective's
    metrics, through the same vocode_fn and f0_fn, at rtol 1e-4 (the port's
    objective-metric tests' bound)."""
    from tts_king_torch.data.dataset import FS2Dataset
    from tts_king_torch.tools import evaluate as tool
    from tts_king_torch.train.checkpoint import restore_train_state
    from tts_king_torch.train.evaluate import evaluate
    from tts_king_torch.train.state import TrainState
    from tts_king_torch.train.step import make_eval_step
    from tts_king_torch.utils.logging import LOSS_NAMES

    raw, port_tree, _ = corpus
    cfg = tools_config(raw, port_tree, str(tmp_path))
    variables = tools_variables(cfg)
    save_port_checkpoint(cfg, variables)
    hop, sr = cfg.preprocess.stft.hop_length, cfg.preprocess.audio.sampling_rate

    def vocode_fn(mel):
        t = np.arange(mel.shape[0] * hop) / sr
        return 0.5 * np.sin(2 * np.pi * (120.0 + mel.mean()) * t)

    def f0_fn(wav):
        return np.full(len(wav) // hop + 1, 150.0, np.float32)

    monkeypatch.setattr(tool, "objective_fns",
                        lambda cfg, device: (vocode_fn, f0_fn))
    path = tmp_path / "cfg.yaml"
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(dataclasses.asdict(cfg))), f)
    got = json.loads(_run_main(tool.main, [str(path), "--objective",
                                           "--objective-utts", "3",
                                           "--device", "cpu"], capsys))

    # the JAX script: the same weights through its orbax restore, its
    # vocoder and F0 tracker replaced by the same functions
    import tts_king_tpu.ops.f0 as jax_f0
    import tts_king_tpu.pipeline as jax_pipeline

    patch_jax_restore(monkeypatch, variables)
    voc = tmp_path / "voc.pth"
    voc.write_bytes(b"")
    jax_cfg_dict = json.loads(json.dumps(dataclasses.asdict(cfg)))
    jax_cfg_dict["vocoder"]["weights_path"] = str(voc)
    jpath = tmp_path / "jax_cfg.yaml"
    with open(jpath, "w") as f:
        yaml.safe_dump(jax_cfg_dict, f)

    class FakeVocoder:
        def __init__(self, cfg):
            pass

        def __call__(self, mel):
            return vocode_fn(np.asarray(mel)[0])[None]

    monkeypatch.setattr(jax_pipeline, "Vocoder", FakeVocoder)
    monkeypatch.setattr(jax_f0, "yin_f0",
                        lambda wav, sr_, hop_: f0_fn(np.asarray(wav)[0])[None])
    monkeypatch.setattr(sys, "argv", ["evaluate.py", str(jpath),
                                      "--objective", "--objective-utts", "3"])
    jax_script("evaluate").main()
    want = json.loads(capsys.readouterr().out)

    assert got.keys() == want.keys()
    assert {"mcd_db", "f0_rmse_hz", "vuv_f1"} <= got.keys()
    assert got["step"] == want["step"] == 7
    assert got["num_utterances"] == want["num_utterances"] >= 1
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    # the losses are the port's own evaluate() of the same checkpoint
    from tts_king_torch.models.fs2 import build_fastspeech2

    with open(os.path.join(port_tree, "stats.json")) as f:
        stats = json.load(f)
    model = build_fastspeech2(cfg.model, stats, 2)
    model.load_state_dict(restore_train_state(cfg.train.ckpt_path)["model"])
    state = TrainState(model, None)
    ds = FS2Dataset("val.txt", cfg.preprocess, cfg.train, drop_last=False,
                    apply_masking=False, max_mel_len=cfg.model.max_seq_len)
    losses = evaluate(make_eval_step(), state, ds, "cpu")
    for name, v in zip(LOSS_NAMES, losses):
        assert got[name] == round(float(v), 5), name


def test_evaluate_objective_fns_through_the_vocoder(corpus, tmp_path):
    """objective_fns: none without vocoder weights; with an npz vocoder,
    the float waveform of Vocoder (T * hop samples) and YIN's frames."""
    from tts_king_torch.config import micro_config
    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.pipeline import Vocoder
    from tts_king_torch.tools.evaluate import objective_fns

    cfg = micro_config()
    assert objective_fns(cfg, "cpu") == (None, None)
    from chip_smoke import save_npz_weights
    from tts_king_torch.weights import seeded_state_dict

    with torch.device("meta"):
        gen = Generator(cfg.vocoder)
    path = str(tmp_path / "voc.npz")
    save_npz_weights(path, seeded_state_dict(gen, 1))
    cfg.vocoder.weights_path = path
    vocode_fn, f0_fn = objective_fns(cfg, "cpu")
    mel = np.random.RandomState(0).randn(12, 80).astype(np.float32)
    wav = vocode_fn(mel)
    hop = cfg.preprocess.stft.hop_length
    assert wav.shape == (12 * hop,) and wav.dtype == np.float32
    ref = Vocoder(cfg, device="cpu")(mel[None])[0].numpy()
    np.testing.assert_array_equal(wav, ref)
    assert f0_fn(wav).shape == (12 * hop // hop + 1,)


def test_synthesize_cli_equals_speak(tmp_path, capsys):
    """The CLI's wav equals TTSKing.speak of the same text and controls,
    with the config's npz weights."""
    from chip_smoke import save_npz_weights
    from tts_king_torch.config import micro_config
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.pipeline import TTSKing
    from tts_king_torch.tools.synthesize import main
    from tts_king_torch.weights import seeded_state_dict

    import yaml

    cfg = micro_config()
    stats = {"pitch": [-3.0, 9.5], "energy": [-1.5, 6.1]}
    with torch.device("meta"):
        fs2 = build_fastspeech2(cfg.model, stats, 1)
        gen = Generator(cfg.vocoder)
    fs2_sd = seeded_state_dict(fs2, 0)
    fs2_sd["variance_adaptor.duration_predictor.linear_layer.bias"] = (
        torch.full((1,), 1.5))
    cfg.acoustic.weights_path = str(tmp_path / "fs2.npz")
    cfg.vocoder.weights_path = str(tmp_path / "voc.npz")
    save_npz_weights(cfg.acoustic.weights_path, fs2_sd)
    save_npz_weights(cfg.vocoder.weights_path, seeded_state_dict(gen, 1))
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(dataclasses.asdict(cfg))), f)
    text = "Привет, мир!"
    out = _run_main(main, ["--config", str(path), "--text", text,
                           "--duration", "1.2", "--out",
                           str(tmp_path / "out"), "--device", "cpu"], capsys)
    assert "utt_0.wav" in out
    sr, wav = wavfile.read(tmp_path / "out" / "utt_0.wav")
    want = TTSKing(cfg, device="cpu").speak(text, duration_control=1.2)[0]
    assert sr == cfg.preprocess.audio.sampling_rate
    assert len(want) > 0
    np.testing.assert_array_equal(wav, want)


# ------------------------------------------------------------ synth_samples


def _tiny_outputs(n_speakers=3):
    """Outputs of the tiny FastSpeech2 (the golden_fs2 widths) on a seeded
    batch of two, through the port and the JAX model."""
    import jax

    from tests.test_torch_train import _jax_model
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.weights import flax_to_torch, load_into

    stats = {"pitch": [-2.0, 2.0], "energy": [-2.0, 2.0]}
    mc = pcfg._build(pcfg.ModelConfig, TINY_MODEL)
    variables = seeded_flax_variables(
        lambda: build_fastspeech2(mc, stats, n_speakers), 3)
    head = variables["params"]["variance_adaptor"]["duration_predictor"]
    head["linear_layer"]["bias"][:] = np.log(3.0)
    rng = np.random.RandomState(0)
    B, L = 2, 6
    speakers, texts = rng.randint(0, 3, (B,)), rng.randint(1, 200, (B, L))
    src_lens = np.array([L, 4])
    texts[1, 4:] = 0
    model = load_into(build_fastspeech2(mc, stats, n_speakers),
                      flax_to_torch(variables)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(speakers), torch.from_numpy(texts),
                    torch.from_numpy(src_lens).int(), max_mel_len=32)
    want = _jax_model(TINY_MODEL, n_speakers, stats).apply(
        jax_tree(variables), speakers, texts, src_lens, max_mel_len=32,
        train=False)
    return got, jax.tree.map(np.asarray, dict(want))


def _vocoder_pair():
    """The port's Vocoder and the JAX Vocoder on the same seeded weights
    (micro_config's HiFi-GAN)."""
    from tts_king_torch.config import micro_config
    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.pipeline import Vocoder
    from tts_king_tpu.pipeline import Vocoder as JaxVocoder

    cfg = micro_config()
    variables = seeded_flax_variables(lambda: Generator(cfg.vocoder), 1)
    return (Vocoder(cfg, variables, device="cpu"),
            JaxVocoder(jax_config(cfg), jax_tree(variables)))


def test_synth_samples_matches_jax(tmp_path):
    """The same files as the JAX synth_samples (tests/test_misc_coverage.py
    mirrored, with a vocoder); the wavs equal the JAX Vocoder's at the
    vocoder golden's bound (< 0.1% of samples off by more than 2 LSB)."""
    from tts_king_torch.utils.synthesis import synth_samples
    from tts_king_tpu.utils.synthesis import synth_samples as jax_synth

    got_out, want_out = _tiny_outputs()
    np.testing.assert_allclose(got_out["postnet_mel"].numpy(),
                               want_out["postnet_mel"], rtol=1e-5, atol=1e-5)
    voc, jvoc = _vocoder_pair()
    cfg = pcfg.TTSConfig()
    cfg.preprocess.preprocessed_path = str(tmp_path)   # no stats.json
    names = ["utt_a", "utt_b"]
    synth_samples(got_out, names, voc, cfg, str(tmp_path / "port"))
    jax_synth(want_out, names, jvoc, jax_config(cfg), str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == [
        "utt_a.png", "utt_a.wav", "utt_b.png", "utt_b.wav"]
    hop = cfg.preprocess.stft.hop_length
    for i, name in enumerate(names):
        _, a = wavfile.read(tmp_path / "port" / f"{name}.wav")
        _, b = wavfile.read(tmp_path / "jax" / f"{name}.wav")
        assert a.shape == b.shape == (int(want_out["mel_lens"][i]) * hop,)
        off = np.mean(np.abs(a.astype(np.int32) - b) > 2)
        assert off < 1e-3, (name, off)


def test_synth_samples_without_matplotlib(tmp_path, monkeypatch, capsys):
    """With matplotlib hidden, the wavs are written, no PNG, no exception,
    and one line says the plots were skipped."""
    from tts_king_torch.utils.synthesis import synth_samples

    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got_out, _ = _tiny_outputs()
    voc, _ = _vocoder_pair()
    cfg = pcfg.TTSConfig()
    cfg.preprocess.preprocessed_path = str(tmp_path)
    synth_samples(got_out, ["a", "b"], voc, cfg, str(tmp_path / "out"))
    assert sorted(os.listdir(tmp_path / "out")) == ["a.wav", "b.wav"]
    assert "matplotlib is not installed" in capsys.readouterr().err


# -------------------------------------------------------------- profiling


def test_roofline_fields():
    """tests/test_profiling.py mirrored: the JAX function's fields, the
    matmul's operations counted (2 * 256^3)."""
    from tts_king_torch.utils.profiling import roofline
    from tts_king_tpu.utils.profiling import roofline as jax_roofline

    a = np.random.RandomState(0).randn(256, 256).astype(np.float32)
    out = roofline(lambda x: x @ x, torch.from_numpy(a), measured_s=1e-3)
    import jax.numpy as jnp

    want = jax_roofline(lambda x: x @ x, jnp.asarray(a), measured_s=1e-3)
    assert set(out) <= set(want) | {"roofline_fraction"}
    assert set(want) - {"roofline_fraction"} <= set(out)
    assert out["device"]
    assert out["gflops"] >= 0.03
    assert out["arith_intensity"] > 0
    assert out["measured_ms"] == 1.0
    assert out["hbm_gbytes"] == round(3 * 256 * 256 * 4 / 1e9, 3)


def test_timers_and_trace(tmp_path):
    from tts_king_torch.utils.profiling import force, timed, trace

    x = torch.arange(4.0) - 2
    assert force({"x": x, "y": [torch.tensor([3], dtype=torch.int32)]}) == 7.0
    assert force([]) == 0.0
    assert timed(lambda t: t * 2, x, iters=2) > 0
    with trace(str(tmp_path / "prof")):
        (torch.ones(8) * 2).sum()
    assert os.path.exists(tmp_path / "prof" / "trace.json")
