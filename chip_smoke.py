#!/usr/bin/env python3
"""The PyTorch port's main path on one CUDA card, checked end to end.

Run from the root of a checkout, with one card and no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and ends the run with a
non-zero exit (nothing is caught):

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — both CUDA kernels compiled from tts_king_torch/csrc with nvcc
               for sm_90a, in parallel;
  3. kernel vs plain — each kernel against its plain PyTorch version on the
               card at main-path shapes, f32 (TF32 off) and bf16, within the
               stated tolerance;
  4. goldens — golden_fs2, golden_vocoder and golden_trained_vocoder
               through the port in f32 at the CPU tests' tolerances, and the
               golden_e2e sentences through TTSKing.speak from the npz
               export of the trained weights;
  5. main path — TTSConfig() at the shipped width with seeded weights (66
               speakers) brought in through weights.flax_to_torch:
               TTSKing.speak on three Russian sentences (f32), then one
               batched generate + vocode at the bench shape B=32, L=128,
               T_mel=1000 (bf16); kernel launch counts are zeroed just before
               and read just after, and must show both kernels ran;
  6. kernels — kernel time, plain time, library time and the card's bound at
               the bench shape.

The last line is {"ok": true, "device": {...}}. Without CUDA, or outside a
checkout, it prints no result and exits 1. The JAX package is not imported.
"""

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
E2E_DIR = os.path.join(FIXTURES, "golden_e2e")

# H100 SXM data-sheet peaks: dense bf16 on the tensor cores, HBM3 bandwidth.
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12

# Tolerances, kernel vs plain version on the card (max |kernel - plain|):
#  * attention f32: both sum in f32 in different orders and the kernel uses
#    an online softmax; 1e-4 on outputs of order 1.
#  * attention bf16: the kernel rounds the unnormalized probabilities to bf16
#    where the plain version rounds the normalized ones, and the output is
#    bf16 (one ulp of 1 is 7.8e-3); 2e-2.
#  * MRF f32: 18 convs of up to 1408 f32 terms summed in another order;
#    1e-4 relative to the output's largest magnitude.
#  * MRF bf16: both round each conv, lrelu, residual add and mean step to
#    bf16, but a sum that lands next to a rounding boundary may round the
#    other way, and that ulp is carried through the later convs of the
#    chain; 2^-5 relative to the output's largest magnitude (8 ulps of a
#    value in the output's top binade). Observed: 2 ulps at B=2.
TOL = {("attention", "f32"): 1e-4, ("attention", "bf16"): 2e-2,
       ("mrf_stage", "f32"): 1e-4, ("mrf_stage", "bf16"): 2.0 ** -5}

# Shapes: the bench shape of bench.py:134-171 and the main-path shapes the
# kernels are checked at (attention: encoder- and decoder-like T, ragged;
# MRF: stages 1-3 of the shipped Generator at T_mel = 1000, two items),
# plus one narrow case each with a ragged edge (the goldens' widths).
BENCH_B, BENCH_L, BENCH_T = 32, 128, 1000
ATTN_CHECKS = [(8, 2, 128, 128), (8, 2, 1000, 128), (3, 2, 77, 16)]
MRF_CHECKS = [(2, 128, 64000), (2, 64, 128000), (2, 32, 256000),
              (3, 16, 4001)]

SENTENCES = ["Привет, мир!",
             "Сегодня хорошая погода, и мы идём гулять в парк.",
             "Синтез речи работает на графическом ускорителе."]


def emit(obj):
    print(json.dumps(obj, ensure_ascii=False), flush=True)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, warmup=1, reps=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 3


def attention_inputs(B, H, T, D, dtype, seed):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    qkv = [torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
           .to("cuda", dtype).transpose(1, 2) for _ in range(3)]
    lens = rng.randint(max(T // 2, 1), T + 1, size=(B,))
    lens[0] = T
    mask = torch.from_numpy(np.arange(T)[None] >= lens[:, None]).cuda()
    return qkv, mask


def mrf_inputs(B, C, T, dtype, seed, kernel_sizes=(3, 7, 11),
               dilations=(1, 3, 5)):
    """x as the main path hands it over: a (B, T, C) view of a (B, C, T)
    tensor; weights N(0, 1/(C k)) so each conv keeps unit scale."""
    import torch

    from tts_king_torch.ops.kernels.mrf import MrfStageWeights

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, C, T), generator=g, device="cuda").to(dtype)
    ws, bs = [], []
    for k in kernel_sizes:
        ws.append([(torch.randn((C, C, k), generator=g, device="cuda")
                    / math.sqrt(C * k)).to(dtype)
                   for _ in range(2 * len(dilations))])
        bs.append([(0.05 * torch.randn((C,), generator=g, device="cuda"))
                   .to(dtype) for _ in range(2 * len(dilations))])
    return x.transpose(1, 2), MrfStageWeights(kernel_sizes, dilations, ws, bs)


def phase_kernels_vs_plain():
    import torch

    from tts_king_torch.ops.kernels import attention as attn
    from tts_king_torch.ops.kernels import mrf

    errs = {"attention": {}, "mrf_stage": {}}
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for B, H, T, D in ATTN_CHECKS:
            (q, k, v), mask = attention_inputs(B, H, T, D, dtype, seed=T)
            got = attn.attention(q, k, v, mask).float()
            ref = attn.attention_plain(q, k, v, mask).float()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= TOL[
                ("attention", dname)]
            emit({"phase": "kernel_vs_plain", "kernel": "attention",
                  "dtype": dname, "shape": [B, H, T, D],
                  "max_abs_err": err, "tol": TOL[("attention", dname)],
                  "ok": ok})
            if not ok:
                fail(f"attention {dname} T={T}: max err {err}")
            errs["attention"][dname] = max(err, errs["attention"].get(dname, 0))
        for B, C, T in MRF_CHECKS:
            x, stage = mrf_inputs(B, C, T, dtype, seed=C)
            got = mrf.mrf_stage(x, stage).float()
            ref = mrf.mrf_stage_plain(x, stage).float()
            torch.cuda.synchronize()
            scale = max(1.0, float(ref.abs().max()))
            err = float((got - ref).abs().max())
            rel_l2 = float((got - ref).norm() / ref.norm())
            tol = TOL[("mrf_stage", dname)] * scale
            ok = bool(torch.isfinite(got).all()) and err <= tol
            emit({"phase": "kernel_vs_plain", "kernel": "mrf_stage",
                  "dtype": dname, "shape": [B, T, C], "max_abs_err": err,
                  "rel_l2": rel_l2, "max_abs_ref": scale, "tol": tol,
                  "ok": ok})
            if not ok:
                fail(f"mrf_stage {dname} C={C}: max err {err} > {tol}")
            errs["mrf_stage"][dname] = max(err, errs["mrf_stage"].get(dname, 0))
    return errs


# ---------------------------------------------------------------- phase 4


def tiny_fs2_config():
    """The tiny FastSpeech2 of golden_fs2.npz (tests/test_train._tiny_setup,
    postnet 32)."""
    from tts_king_torch.config import (ModelConfig, TransformerConfig,
                                       VariancePredictorConfig)

    return ModelConfig(
        transformer=TransformerConfig(
            encoder_layer=1, encoder_head=2, encoder_hidden=16,
            variance_hidden=16, decoder_layer=1, decoder_head=2,
            decoder_hidden=16, conv_filter_size=32, conv_kernel_size=(9, 1)),
        variance_predictor=VariancePredictorConfig(filter_size=16),
        max_seq_len=32, postnet_dim=32)


def golden_e2e_config():
    """tests/test_golden_e2e.micro_config, in the port's config."""
    from tts_king_torch.config import (AcousticCheckpointConfig, ModelConfig,
                                       PreprocessConfig, TransformerConfig,
                                       TTSConfig, VariancePredictorConfig,
                                       VocoderModelConfig)

    return TTSConfig(
        exp_name="golden_e2e",
        preprocess=PreprocessConfig(
            lexicon_path=os.path.join(E2E_DIR, "lexicon.dict")),
        model=ModelConfig(
            transformer=TransformerConfig(
                encoder_layer=2, encoder_head=2, encoder_hidden=32,
                variance_hidden=32, decoder_layer=2, decoder_head=2,
                decoder_hidden=32, conv_filter_size=64,
                conv_kernel_size=(9, 1)),
            variance_predictor=VariancePredictorConfig(filter_size=32),
            postnet_dim=32, max_seq_len=256),
        acoustic=AcousticCheckpointConfig(
            weights_path=os.path.join(E2E_DIR, "ckpt")),
        vocoder=VocoderModelConfig(upsample_initial_channel=32))


def phase_goldens():
    import numpy as np
    import torch

    from tts_king_torch.config import VocoderModelConfig
    from tts_king_torch.models.fs2 import FastSpeech2
    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.pipeline import TTSKing
    from tts_king_torch.weights import flax_to_torch, load_flax_npz, load_into

    path = os.path.join(FIXTURES, "golden_fs2.npz")
    z = np.load(path)
    fs2 = FastSpeech2(tiny_fs2_config(), n_speakers=3, pitch_min=-2,
                      pitch_max=2, energy_min=-2, energy_max=2)
    fs2 = load_into(fs2, flax_to_torch(load_flax_npz(path))).cuda().eval()
    with torch.inference_mode():
        out = fs2(torch.from_numpy(z["in::speakers"]).long().cuda(),
                  torch.from_numpy(z["in::texts"]).long().cuda(),
                  torch.from_numpy(z["in::src_lens"]).int().cuda(),
                  max_mel_len=32)
    got = {k: v.cpu().numpy() for k, v in out.items()}
    np.testing.assert_array_equal(got["mel_lens"], z["out::mel_lens"])
    errs = {}
    for key in ("log_duration_prediction", "mel", "postnet_mel"):
        np.testing.assert_allclose(got[key], z[f"out::{key}"], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
        errs[key] = float(np.abs(got[key] - z[f"out::{key}"]).max())
    emit({"phase": "golden", "fixture": "golden_fs2", "max_abs_err": errs,
          "tol": "rtol 1e-5 atol 1e-5", "ok": True})

    path = os.path.join(FIXTURES, "golden_vocoder.npz")
    z = np.load(path)
    gen = Generator(VocoderModelConfig(upsample_rates=[4, 4],
                                       upsample_kernel_sizes=[8, 8],
                                       upsample_initial_channel=32))
    gen = load_into(gen, flax_to_torch(load_flax_npz(path))).cuda().eval()
    with torch.inference_mode():
        wav = gen(torch.from_numpy(z["in::mel"]).cuda()).cpu().numpy()
    np.testing.assert_allclose(wav, z["out::wav"], rtol=1e-5, atol=1e-5)
    emit({"phase": "golden", "fixture": "golden_vocoder",
          "max_abs_err": float(np.abs(wav - z["out::wav"]).max()),
          "tol": "rtol 1e-5 atol 1e-5", "ok": True})

    # one k=3 branch with dilations (1, 3), C = 16 down to 2
    path = os.path.join(FIXTURES, "golden_trained_vocoder.npz")
    z = np.load(path)
    gen = Generator(VocoderModelConfig(
        upsample_rates=[8, 8, 2, 2], upsample_kernel_sizes=[16, 16, 4, 4],
        upsample_initial_channel=32, resblock_kernel_sizes=[3],
        resblock_dilation_sizes=[[1, 3]]))
    gen = load_into(gen, flax_to_torch(load_flax_npz(path))).cuda().eval()
    with torch.inference_mode():
        wav = gen(torch.from_numpy(z["mel"]).cuda()).cpu().numpy()
    np.testing.assert_allclose(wav, z["expected_wav"], rtol=1e-5, atol=1e-5)
    emit({"phase": "golden", "fixture": "golden_trained_vocoder",
          "max_abs_err": float(np.abs(wav - z["expected_wav"]).max()),
          "tol": "rtol 1e-5 atol 1e-5", "ok": True})

    port = os.path.join(FIXTURES, "torch_port")
    king = TTSKing(golden_e2e_config(), device="cuda",
                   acoustic_variables=load_flax_npz(
                       os.path.join(port, "golden_e2e_variables.npz")),
                   vocoder_variables=load_flax_npz(
                       os.path.join(port, "golden_e2e_vocoder_variables.npz")))
    z = np.load(os.path.join(E2E_DIR, "expected.npz"))
    for i, (text, dctl) in enumerate((("привет мир", 1.0),
                                      ("привет мир", 1.3))):
        np.testing.assert_array_equal(king.text_preprocess(text),
                                      z[f"phonemes_{i}"])
        mel, mel_lens = king.generate_mel(text, duration_control=dctl)
        n = int(mel_lens[0])
        if n != int(z[f"mel_len_{i}"]):
            fail(f"golden_e2e {i}: mel_len {n} vs {int(z[f'mel_len_{i}'])}")
        mae = float(np.mean(np.abs(mel.float().cpu().numpy()[0, :n]
                                   - z[f"mel_{i}"])))
        wav = king.speak(text, duration_control=dctl)[0]
        ref = z[f"wav_{i}"]
        if wav.shape != ref.shape:
            fail(f"golden_e2e {i}: wav {wav.shape} vs {ref.shape}")
        off = float(np.mean(np.abs(wav.astype(np.int32)
                                   - ref.astype(np.int32)) > 2))
        ok = mae < 1e-3 and off < 1e-3
        emit({"phase": "golden", "fixture": f"golden_e2e[{i}]",
              "mel_len": n, "mel_mae": mae, "wav_frac_off_gt_2lsb": off,
              "tol": "mel MAE < 1e-3, < 0.1% samples off by > 2 LSB",
              "ok": ok})
        if not ok:
            fail(f"golden_e2e {i}: mel MAE {mae}, wav off {off}")


# ---------------------------------------------------------------- phase 5


def seeded_flax_variables(build, seed):
    """Seeded numpy weights in the flax layout, for a module built by
    ``build`` (on the meta device: shapes only)."""
    import torch

    from tts_king_torch.weights import seeded_state_dict, torch_to_flax

    with torch.device("meta"):
        module = build()
    return torch_to_flax(seeded_state_dict(module, seed))


def main_config():
    """The shipped configuration (config.py defaults)."""
    from tts_king_torch.config import TTSConfig

    return TTSConfig()


def fused_stages(cfg, T_mel):
    """(C, T) of the Generator stages that run the MRF kernel at T_mel."""
    v = cfg.vocoder
    out, up = [], 1
    for i, u in enumerate(v.upsample_rates):
        up *= u
        C = v.upsample_initial_channel // 2 ** (i + 1)
        if C <= 128:
            out.append((C, T_mel * up))
    return out


def main_path_kings(cfg, n_spk=66):
    """TTSKing in f32 and in bf16 at ``cfg``'s width, with seeded weights
    brought in through weights.flax_to_torch."""
    import torch

    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.pipeline import TTSKing

    stats = {"pitch": [-3.0, 9.5], "energy": [-1.5, 6.1]}
    fs2_vars = seeded_flax_variables(
        lambda: build_fastspeech2(cfg.model, stats, n_spk), seed=0)
    # Random weights predict log-durations near 0, i.e. next to no frames; a
    # head of bias log(1 + 5) and a tenth of its random weight gives each
    # phoneme about five frames, as a trained model does, so the decoder and
    # the vocoder run at speech-like lengths.
    head = fs2_vars["params"]["variance_adaptor"]["duration_predictor"]
    head["linear_layer"]["kernel"] *= 0.1
    head["linear_layer"]["bias"][:] = math.log(6.0)
    voc_vars = seeded_flax_variables(lambda: Generator(cfg.vocoder), seed=1)
    return {dname: TTSKing(cfg, dtype=dtype, device="cuda",
                           acoustic_variables=fs2_vars,
                           vocoder_variables=voc_vars, n_speakers=n_spk)
            for dname, dtype in (("f32", torch.float32),
                                 ("bf16", torch.bfloat16))}


def bench_batch(n_spk=66):
    """Phonemes and per-item speakers of the bench shape, seeded."""
    import numpy as np

    rng = np.random.RandomState(0)
    phonemes = rng.randint(1, 206, (BENCH_B, BENCH_L))
    return phonemes, [int(s) for s in np.arange(BENCH_B) % n_spk]


def phase_main_path(mods):
    import numpy as np
    import torch

    from tts_king_torch.pipeline import wav_to_int16

    cfg = main_config()
    cfg.preprocess.lexicon_path = os.path.join(E2E_DIR, "lexicon.dict")
    n_spk = 66
    kings = main_path_kings(cfg, n_spk)
    hop = cfg.preprocess.stft.hop_length
    sr = cfg.preprocess.audio.sampling_rate

    def counts():
        return {k: m.launches for k, m in mods.items()}

    B, L, T = BENCH_B, BENCH_L, BENCH_T
    phonemes, speakers = bench_batch(n_spk)
    am, voc = kings["bf16"].tts, kings["bf16"].vocoder
    # one untimed call of each run: cuDNN's plans and the allocator's pools
    for king in kings.values():
        king.speak(SENTENCES[0])
    voc(am.generate(phonemes, speaker_name=speakers,
                    max_mel_len=T)["postnet_mel"])
    torch.cuda.synchronize()

    # -- the main path's counted run: every count 0 just before it
    for m in mods.values():
        m.launches = 0
    results = []
    king = kings["f32"]
    for i, text in enumerate(SENTENCES):
        before = counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wavs = king.speak(text, speaker=i % n_spk)
        end.record()
        end.synchronize()
        after = counts()
        results.append((text, wavs, start.elapsed_time(end), before, after))

    n_fused = len(fused_stages(cfg, T))
    # one attention launch per FFT block and generate pass (more after a
    # mel-bucket escalation)
    n_layers = (cfg.model.transformer.encoder_layer
                + cfg.model.transformer.decoder_layer)
    before_b = counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = am.generate(phonemes, speaker_name=speakers, max_mel_len=T)
    wav_f = voc(out["postnet_mel"])
    wav_i16 = wav_to_int16(wav_f, cfg.vocoder.max_wav_value)
    end.record()
    end.synchronize()
    batch_ms = start.elapsed_time(end)
    after_b = launches = counts()   # read just after the main path's run

    # -- checks of what came out (no kernel launch counted beyond here)
    for text, wavs, ms, before, after in results:
        mel, mel_lens = king.generate_mel(text)
        n = int(mel_lens[0])
        wf = king.vocoder(mel)
        if not bool(torch.isfinite(wf).all()):
            fail(f"speak: non-finite waveform for {text!r}")
        w = wavs[0]
        if n < 1:
            fail(f"speak: no mel frames for {text!r}")
        if w.dtype != np.int16 or w.shape != (n * hop,):
            fail(f"speak: {w.dtype} {w.shape} vs int16 ({n * hop},)")
        d_att = after["attention"] - before["attention"]
        d_mrf = after["mrf_stage"] - before["mrf_stage"]
        if d_att < n_layers or d_mrf != n_fused:
            fail(f"speak: attention launches {d_att} (>= {n_layers}), mrf "
                 f"{d_mrf} (== {n_fused})")
        emit({"phase": "main_path", "call": "TTSKing.speak", "dtype": "f32",
              "text": text, "mel_len": n, "samples": int(w.shape[0]),
              "wall_ms": ms, "rtf": ms / 1e3 / (w.shape[0] / sr),
              "launches": {"attention": d_att, "mrf_stage": d_mrf},
              "ok": True})

    mel_lens = out["mel_lens"].cpu().numpy()
    if tuple(out["postnet_mel"].shape) != (B, T, 80):
        fail(f"batched mel shape {tuple(out['postnet_mel'].shape)}")
    if not bool(torch.isfinite(wav_f).all()):
        fail("batched: non-finite waveform")
    if wav_i16.dtype != torch.int16 or tuple(wav_i16.shape) != (B, T * hop):
        fail(f"batched: {wav_i16.dtype} {tuple(wav_i16.shape)}")
    trimmed = [w[:n] for w, n in zip(wav_i16.cpu().numpy(), mel_lens * hop)]
    if any(len(w) != n * hop for w, n in zip(trimmed, mel_lens)):
        fail("batched: trimmed lengths are not mel_len * hop")
    d_att = after_b["attention"] - before_b["attention"]
    d_mrf = after_b["mrf_stage"] - before_b["mrf_stage"]
    if d_att != n_layers or d_mrf != n_fused:
        fail(f"batched: attention launches {d_att} (== {n_layers}), mrf "
             f"{d_mrf} (== {n_fused})")
    emit({"phase": "main_path", "call": "generate+vocode", "dtype": "bf16",
          "shape": {"B": B, "L": L, "T_mel": T}, "wall_ms": batch_ms,
          "rtf": batch_ms / 1e3 / (B * T * hop / sr),
          "mel_lens_min_max": [int(mel_lens.min()), int(mel_lens.max())],
          "launches": {"attention": d_att, "mrf_stage": d_mrf}, "ok": True})
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the main path")
    emit({"phase": "main_path", "launches": launches, "ok": True})
    return launches, [int(n) for n in mel_lens]


# ---------------------------------------------------------------- phase 6


def phase_timing(cfg, launches, errs, mel_lens):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tts_king_torch.ops.kernels import attention as attn
    from tts_king_torch.ops.kernels import mrf

    tc = cfg.model.transformer
    B, H, T = BENCH_B, tc.decoder_head, BENCH_T
    D = tc.decoder_hidden // H
    (q, k, v), _ = attention_inputs(B, H, T, D, torch.bfloat16, seed=7)
    # the decoder's key mask from the batched run's mel lengths
    mask = torch.from_numpy(np.arange(T)[None] >=
                            np.asarray(mel_lens)[:, None]).cuda()
    additive = torch.zeros((B, 1, 1, T), dtype=torch.bfloat16, device="cuda")
    additive.masked_fill_(mask[:, None, None, :], -1e9)
    ms = cuda_ms(lambda: attn.attention(q, k, v, mask), warmup=2, reps=10)
    plain_ms = cuda_ms(lambda: attn.attention_plain(q, k, v, mask), warmup=2,
                       reps=10)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=additive), warmup=2, reps=10)
    ops = 4.0 * B * H * T * T * D
    nbytes = 4 * B * H * T * D * 2 + B * T
    t_ops, t_bytes = ops / PEAK_BF16_OPS, nbytes / PEAK_BYTES
    rows = [{
        "name": "attention", "route": "cuda",
        "source": "tts_king_torch/csrc/attention.cu",
        "replaces": "tts_king_tpu/ops/pallas/attention.py:29",
        "launches": launches["attention"],
        "max_abs_err": errs["attention"]["bf16"],
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib_ms, "dtype": "bf16", "shape": [B, H, T, D]}]

    stages = fused_stages(cfg, T)
    ms = plain_ms = 0.0
    ops = nbytes = 0.0
    for C, Tw in stages:
        x, stage = mrf_inputs(B, C, Tw, torch.bfloat16, seed=C)
        ms += cuda_ms(lambda: mrf.mrf_stage(x, stage), warmup=1, reps=2)
        plain_ms += cuda_ms(lambda: mrf.mrf_stage_plain(x, stage), warmup=1,
                            reps=2)
        ops += 2.0 * 6 * sum(stage.kernel_sizes) * C * C * Tw * B
        n_w = sum(w.numel() + C for ws in stage.weights for w in ws)
        nbytes += 2.0 * (2 * B * Tw * C + n_w)
        del x, stage
        torch.cuda.empty_cache()
    t_ops, t_bytes = ops / PEAK_BF16_OPS, nbytes / PEAK_BYTES
    rows.append({
        "name": "mrf_stage", "route": "cuda",
        "source": "tts_king_torch/csrc/mrf_stage.cu",
        "replaces": "tts_king_tpu/ops/pallas/mrf_packed.py:172",
        "launches": launches["mrf_stage"],
        "max_abs_err": errs["mrf_stage"]["bf16"],
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "dtype": "bf16",
        "shape": {"B": B, "T_mel": T, "stages_C_T": stages,
                  "note": "sum of one launch per fused stage"}})
    return rows


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "tts_king_torch")):
        print("chip_smoke: run it from the root of a checkout (no "
              "tts_king_torch/ beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from tts_king_torch.ops.kernels import _build
    from tts_king_torch.ops.kernels import attention as attn
    from tts_king_torch.ops.kernels import mrf

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    compiled = _build.build()
    regs = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                   if "registers" in ln or "spill" in ln]
            for name in _build.SOURCES}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": compiled, "ptxas": regs})

    errs = phase_kernels_vs_plain()
    phase_goldens()
    launches, mel_lens = phase_main_path({"attention": attn,
                                          "mrf_stage": mrf})
    rows = phase_timing(main_config(), launches, errs, mel_lens)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
