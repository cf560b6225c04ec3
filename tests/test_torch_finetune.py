"""The FS2 -> HiFi-GAN fine-tuning bridge and train()'s synthesis previews
in the port, on the CPU at tiny widths: tests/test_finetune_loop.py (slow
in the JAX suite) mirrored -- train() 2 steps, make_base_mels,
train_vocoder(fine_tuning=True) 3 steps, the export into the fused
Generator against the weight-norm route -- and the previews of train()
and its CLI against the JAX loop's _synth_preview."""

import dataclasses
import glob
import json
import os

import numpy as np
import torch
from scipy.io import wavfile

from chip_smoke import (TOL, PreviewRecorder, save_npz_weights,
                        seeded_flax_variables)
from tests.test_torch_tools import (corpus, jax_config,  # noqa: F401
                                    jax_tree, save_port_checkpoint,
                                    tools_config, tools_variables)
from tts_king_torch import config as pcfg

# the tiny vocoder of tests/test_finetune_loop.py: x256 (the corpus's hop)
TINY_VOCODER = dict(upsample_rates=[8, 8, 2, 2],
                    upsample_kernel_sizes=[16, 16, 4, 4],
                    upsample_initial_channel=16, resblock_kernel_sizes=[3],
                    resblock_dilation_sizes=[[1, 3]], segment_size=2048,
                    batch_size=2)
DISC = dict(disc_p_channels=(4, 8, 8, 8, 8), msd_width=16)


def bridge_config(corpus, tmp, **step):
    raw, port_tree, _ = corpus
    cfg = tools_config(raw, port_tree, tmp)
    cfg.model = dataclasses.replace(cfg.model, max_seq_len=96)
    cfg.train.optimizer = pcfg.OptimizerConfig(batch_size=1, grad_acc_step=2)
    cfg.train.step = pcfg.StepConfig(**{
        "total_step": 2, "log_step": 10, "synth_step": 100, "val_step": 100,
        "save_step": 2, **step})
    cfg.vocoder = dataclasses.replace(cfg.vocoder, **TINY_VOCODER)
    return cfg


def test_finetune_bridge_end_to_end(corpus, tmp_path):
    """train() -> make_base_mels -> train_vocoder(fine_tuning=True) -> the
    folded Generator: checkpoints at each stage, frame-aligned pairs (T
    mel frames, T * hop samples, T the ground-truth mel's), and the
    exported fused Generator equal to the weight-norm route at 1e-4 of
    max(1, peak) (f32, chip_smoke's export bound)."""
    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.tools.make_base_mels import make_base_mels
    from tts_king_torch.train.loop import train
    from tts_king_torch.train.vocoder import export_inference_params
    from tts_king_torch.train.vocoder_loop import train_vocoder
    from tts_king_torch.weights import load_into

    cfg = bridge_config(corpus, str(tmp_path))
    hop = cfg.preprocess.stft.hop_length

    # 1. FastSpeech2 -> checkpoint
    assert train(cfg, max_steps=2, device="cpu").step == 2
    assert os.path.isdir(os.path.join(cfg.train.ckpt_path, "step_00000002"))

    # 2. teacher-forced mels and the aligned ground-truth slices
    out_dir = make_base_mels(cfg, batch_size=2, device="cpu")
    assert out_dir == os.path.join(cfg.preprocess.preprocessed_path,
                                   "base_mels")
    mels = sorted(glob.glob(os.path.join(out_dir, "mels", "*.npy")))
    wavs = sorted(glob.glob(os.path.join(out_dir, "wavs", "*.wav")))
    assert len(mels) == len(wavs) == 6     # 2 speakers x 3 utterances
    for mp, wp in zip(mels, wavs):
        mel = np.load(mp)
        sr, wav = wavfile.read(wp)
        assert mel.ndim == 2 and mel.shape[1] == 80
        assert np.isfinite(mel).all()
        assert sr == cfg.preprocess.audio.sampling_rate
        assert len(wav) == mel.shape[0] * hop
        spk, utt = os.path.basename(mp)[:-4].split("-", 1)
        gt = np.load(os.path.join(cfg.preprocess.preprocessed_path, "mel",
                                  f"{spk}-mel-{utt}.npy"))
        assert mel.shape[0] == min(gt.shape[0], cfg.model.max_seq_len)

    # 3. the vocoder fine-tuned on (ground-truth wav, FS2 mel) pairs
    state = train_vocoder(
        cfg, wavs, max_steps=3,
        ckpt_dir=os.path.join(cfg.train.ckpt_path, "vocoder_ft"),
        log_every=1, save_every=100, fine_tuning=True,
        base_mels_path=os.path.join(out_dir, "mels"), device="cpu", **DISC)
    assert state.step == 3
    assert os.listdir(os.path.join(cfg.train.ckpt_path, "vocoder_ft")) == [
        "step_00000003"]

    # 4. the export into the fused Generator against the weight-norm route
    fused = load_into(Generator(cfg.vocoder),
                      export_inference_params(state.gen)).eval()
    mel = torch.from_numpy(np.load(mels[0]))[None]
    with torch.no_grad():
        ref = state.gen(mel)
        got = fused(mel)
    assert got.shape == (1, mel.shape[1] * hop)
    assert bool(torch.isfinite(got).all())
    tol = TOL[("mrf_stage", "f32")] * max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= tol


def _vocoders(cfg):
    """The port's Vocoder and the JAX Vocoder on the same seeded weights."""
    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.pipeline import Vocoder
    from tts_king_tpu.pipeline import Vocoder as JaxVocoder

    variables = seeded_flax_variables(lambda: Generator(cfg.vocoder), 1)
    return (Vocoder(cfg, variables, device="cpu"),
            JaxVocoder(jax_config(cfg), jax_tree(variables)), variables)


def test_train_writes_previews(corpus, tmp_path):
    """train() with a vocoder and synth_step 1, resumed from weights whose
    durations give frames: step_<n>.wav and .png at every step, each wav
    Vocoder.generate of that step's preview mel (which utterance, at which
    padding: test_preview_matches_jax)."""
    from tts_king_torch.train.loop import train

    cfg = bridge_config(corpus, str(tmp_path), synth_step=1)
    save_port_checkpoint(cfg, tools_variables(cfg), step=1)
    cfg.acoustic.restore_step = 1
    voc = PreviewRecorder(_vocoders(cfg)[0])
    assert train(cfg, max_steps=3, vocoder=voc, device="cpu").step == 3
    files = sorted(os.listdir(cfg.train.result_path))
    for step in (2, 3):
        assert f"step_{step}.wav" in files and f"step_{step}.png" in files
    assert len(voc.calls) == 2
    hop = cfg.preprocess.stft.hop_length
    for step, (mel, lengths, wavs) in zip((2, 3), voc.calls):
        n = mel.shape[1]
        assert n > 0 and lengths == [n * hop]
        _, wav = wavfile.read(os.path.join(cfg.train.result_path,
                                           f"step_{step}.wav"))
        np.testing.assert_array_equal(wav, voc.vocoder.generate(
            mel, lengths=[n * hop])[0])
        np.testing.assert_array_equal(wav, wavs[0])


def test_preview_matches_jax(corpus, tmp_path):
    """synth_preview against the JAX loop's _synth_preview on the same
    FastSpeech2 and vocoder weights, for steps that rotate through the val
    split (synth_step 2): the same utterance at the same padding, so the
    same number of samples, and the wav within the vocoder golden's bound
    (< 0.1% of samples off by more than 2 LSB)."""
    from tts_king_torch.data.dataset import FS2Dataset
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.train.loop import synth_preview
    from tts_king_torch.weights import flax_to_torch, load_into
    from tts_king_tpu.data.dataset import FS2Dataset as JaxDataset
    from tts_king_tpu.models.fs2 import build_fastspeech2 as jax_fs2
    from tts_king_tpu.train.loop import _synth_preview

    import shutil

    cfg = bridge_config(corpus, str(tmp_path / "port"), synth_step=2)
    cfg.model = dataclasses.replace(cfg.model, max_seq_len=1000)
    # every utterance validates, so that the preview rotates through six
    root = str(tmp_path / "features")
    shutil.copytree(cfg.preprocess.preprocessed_path, root)
    with open(os.path.join(root, "val.txt"), "a", encoding="utf-8") as f:
        f.write(open(os.path.join(root, "train.txt"),
                     encoding="utf-8").read())
    cfg.preprocess = dataclasses.replace(cfg.preprocess,
                                         preprocessed_path=root)
    variables = tools_variables(cfg)
    with open(os.path.join(root, "stats.json")) as f:
        stats = json.load(f)
    model = load_into(build_fastspeech2(cfg.model, stats, 2),
                      flax_to_torch(variables))
    voc, jvoc, _ = _vocoders(cfg)
    val = FS2Dataset("val.txt", cfg.preprocess, cfg.train, drop_last=False,
                     apply_masking=False, max_mel_len=cfg.model.max_seq_len)
    jcfg = jax_config(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, result_path=str(tmp_path / "jax"))))
    jval = JaxDataset("val.txt", jcfg.preprocess, jcfg.train, drop_last=False,
                      apply_masking=False, max_mel_len=cfg.model.max_seq_len,
                      use_native_loader=False)

    class State:
        @staticmethod
        def variables():
            return jax_tree(variables)

    jmodel = jax_fs2(jcfg.model, stats, 2)
    assert len(val.meta) == 6
    steps = [2, 4, 6, 8]        # utterances 1, 2, 3 and 4 of the split
    for step in steps:
        synth_preview(cfg, model, val, voc, step, "cpu")
        _synth_preview(jcfg, jmodel, State, jval, jvoc, step)
    lengths = set()
    for step in steps:
        _, a = wavfile.read(os.path.join(cfg.train.result_path,
                                         f"step_{step}.wav"))
        _, b = wavfile.read(tmp_path / "jax" / f"step_{step}.wav")
        assert a.shape == b.shape and len(a) > 0, step
        assert np.mean(np.abs(a.astype(np.int32) - b) > 2) < 1e-3, step
        lengths.add(len(a))
    assert len(lengths) > 3     # the preview rotated


def test_cli_passes_the_vocoder(corpus, tmp_path):
    """python -m tts_king_torch.train builds a Vocoder from
    vocoder.weights_path and writes previews; --no-vocoder writes none."""
    import yaml

    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.train.__main__ import main
    from tts_king_torch.weights import seeded_state_dict

    for no_vocoder in (False, True):
        tmp = tmp_path / str(no_vocoder)
        cfg = bridge_config(corpus, str(tmp), synth_step=1)
        with torch.device("meta"):
            gen = Generator(cfg.vocoder)
        cfg.vocoder.weights_path = str(tmp / "generator.npz")
        os.makedirs(tmp)
        save_npz_weights(cfg.vocoder.weights_path, seeded_state_dict(gen, 1))
        path = tmp / "cfg.yaml"
        with open(path, "w") as f:
            yaml.safe_dump(json.loads(json.dumps(dataclasses.asdict(cfg))), f)
        argv = [str(path), "--steps", "1", "--device", "cpu"]
        assert main(argv + ["--no-vocoder"] * no_vocoder) == 0
        previews = sorted(f for f in os.listdir(cfg.train.result_path)
                          if f.startswith("step_"))
        assert previews == ([] if no_vocoder
                            else ["step_1.png", "step_1.wav"])
