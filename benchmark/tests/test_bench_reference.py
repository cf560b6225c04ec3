"""The plain reference (benchmark/reference/) against tts_king_torch on the
same weights, on the CPU at small widths: FastSpeech2 with the program's
own choices, each configuration's vocoder; the energy ratio that holds the
bf16 vocoder and fails HiFi-GAN's int8 one; and a FastSpeech2 computed in
bf16 misses the float32 limits the bulk cells hold the program to."""

import numpy as np
import pytest
import torch

from benchmark.core import harness, program
from benchmark.reference import fs2, hifigan, vocoders
from benchmark.tests import micro

CPU = torch.device("cpu")


def program_batch(cfg, precision, seed=5):
    weights = program.make_weights(cfg, precision, seed, CPU,
                                   micro.calibration())
    acoustic, vocoder = program.build(cfg, precision, weights, CPU)
    rng = np.random.default_rng(seed)
    lens = np.array([23, 9, 17, 30])
    ph = rng.integers(1, 207, (4, lens.max()))
    ph[np.arange(lens.max())[None] >= lens[:, None]] = 0
    speakers = rng.integers(0, 66, 4)
    out = acoustic.generate(ph, speaker_name=speakers, src_lens=lens)
    return weights, acoustic, vocoder, ph, lens, speakers, out


def reference_rows(cfg, precision, weights, ph, lens, speakers, out):
    p = cfg["precisions"][precision]["acoustic_variables"]
    sd = fs2.round_variables(weights[0], p)
    Lp = out["duration_rounded"].shape[1]
    rows = []
    for r in range(len(lens)):
        row = np.zeros(Lp, np.int64)
        row[:ph.shape[1]] = ph[r]
        chosen = {"log_duration": out["log_duration_prediction"][r],
                  "duration": out["duration_rounded"][r],
                  "pitch": out["pitch_prediction"][r],
                  "energy": out["energy_prediction"][r]}
        rows.append(fs2.fs2_sentence(
            sd, cfg["model"], p, cfg["assumed"]["stats"],
            torch.from_numpy(row), int(lens[r]), int(speakers[r]), chosen,
            int(out["mel_bucket"])))
    return rows


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_fs2_reference_matches_the_program(precision):
    cfg = micro.config()
    weights, _, _, ph, lens, spk, out = program_batch(cfg, precision)
    with torch.no_grad():
        rows = reference_rows(cfg, precision, weights, ph, lens, spk, out)
    for r, (mel, n, errs) in enumerate(rows):
        assert n == int(out["mel_lens"][r]) and n > 0
        assert errs.pop("duration_mismatch") == 0
        assert max(errs.values()) < 1e-5, errs
        got = out["postnet_mel"][r].float()
        assert float((got - mel).abs().max()) < 1e-5


@pytest.mark.parametrize("name", micro.configs())
def test_vocoder_reference_matches_the_program(name):
    cfg = micro.config(name)
    cfg["precisions"]["f32"] = {"acoustic_variables": "float32",
                                "acoustic_compute": "float32",
                                "vocoder": "float32"}
    weights = program.make_weights(cfg, "f32", 9, CPU, micro.calibration())
    _, vocoder = program.build(cfg, "f32", weights, CPU)
    mel = torch.randn(1, 37, 80, generator=torch.Generator().manual_seed(0))
    generate = vocoders.find(cfg["model"]["vocoder_model"]).generate
    with torch.no_grad():
        got = vocoder(mel)[0]
        ref = generate(weights[1], cfg["vocoder"], mel[0])
    assert got.shape == ref.shape == (37 * 256,)
    assert float((got - ref).abs().max()) < 1e-5
    fp8 = generate(weights[1], cfg["vocoder"], mel[0], "float8")
    assert float((fp8 - ref).norm() / ref.norm()) > 1e-2


def test_int16_cast_wraps_at_full_scale():
    wav = torch.tensor([1.0, -1.0, 0.99999, -0.5, 0.00001])
    assert vocoders.to_int16(wav, 32768.0).tolist() == [
        -32768, -32768, 32767, -16384, 0]


def test_fs2_in_bf16_misses_the_f32_limit():
    """FastSpeech2 computed in bf16 (the module cast, as the JAX bench
    builds it) against the reference on the same bf16-rounded variables:
    its mel or a variance prediction misses every cell's limit."""
    cfg = micro.config()
    weights, acoustic, _, ph, lens, spk, out = program_batch(cfg, "bf16")
    acoustic.model.to(torch.bfloat16)
    for m in acoustic.model.modules():
        if getattr(m, "eval_mul", None) is not None:
            m.eval_mul = m.eval_mul.to(torch.bfloat16)
    texts = np.zeros((len(lens), out["duration_rounded"].shape[1]), np.int64)
    texts[:, :ph.shape[1]] = ph
    with torch.no_grad():
        low = acoustic.model(torch.from_numpy(spk), torch.from_numpy(texts),
                             torch.from_numpy(lens), max_mel_len=int(
                                 out["mel_bucket"]))
        low["mel_bucket"] = out["mel_bucket"]
        rows = reference_rows(cfg, "bf16", weights, ph, lens, spk, low)
    worst = {"mel_err": 0.0, "log_duration_err": 0.0, "pitch_err": 0.0,
             "energy_err": 0.0}
    for r, (mel, n, errs) in enumerate(rows):
        got = low["postnet_mel"][r, :n].float()
        scale = max(1.0, float(mel[:n].abs().max()))
        worst["mel_err"] = max(worst["mel_err"],
                               float((got - mel[:n]).abs().max()) / scale)
        errs.pop("duration_mismatch")
        for k, e in errs.items():
            worst[f"{k}_err"] = max(worst[f"{k}_err"], e)
    for cell in micro.cells():
        limits = harness.load_json("limits", f"{cell}.json")["limits"]
        assert any(worst[k] > limits[k] for k in worst), (cell, worst, limits)


def test_noise_ratio_holds_bf16_and_fails_int8():
    """wav_noise_ratio's principle at HiFi-GAN V1's branches and 128
    channels: the program's bf16 vocoder and the reference computed in
    bf16 differ from the float32 reference by about the same energy,
    though not by the same samples; the program's int8 MRF path by several
    times more."""
    from tts_king_torch.models.hifigan import Generator

    cfg = micro.config(micro.configs("hifigan")[0])
    cfg["vocoder"].update(upsample_initial_channel=128,
                          resblock_kernel_sizes=[3, 7, 11],
                          resblock_dilation_sizes=[[1, 3, 5]] * 3)
    weights = program.make_weights(cfg, "bf16", 11, CPU, micro.calibration())
    _, vocoder = program.build(cfg, "bf16", weights, CPU)
    int8 = Generator(vocoder.config.vocoder, mrf_backend="fused_int8")
    int8.load_state_dict({k: t.float() for k, t in weights[1].items()})
    int8 = int8.to(torch.bfloat16).eval()
    mel = torch.randn(1, 24, 80, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ref = hifigan.generate(weights[1], cfg["vocoder"], mel[0])
        stated = hifigan.generate(weights[1], cfg["vocoder"], mel[0],
                                  "bfloat16")
        energy = {name: float(((w[0].float() - ref) ** 2).sum())
                  for name, w in (("bf16", vocoder(mel)), ("int8", int8(mel)),
                                  ("stated", stated[None]))}
    assert float((vocoder(mel)[0].float() - stated).abs().max()) > 0
    assert 0.5 < energy["bf16"] / energy["stated"] < 1.5, energy
    assert energy["int8"] / energy["stated"] > 3.0, energy
