#!/usr/bin/env python3
"""The PyTorch port's main paths on one CUDA card, checked end to end:
synthesis (TTSKing.speak and batched generate + vocode) and FastSpeech2
training (train() from a preprocessed corpus, with resume).

Run from the root of a checkout, with one card and no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and ends the run with a
non-zero exit (nothing is caught):

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — the three CUDA kernel sources compiled from
               tts_king_torch/csrc with nvcc for sm_90a, in parallel;
  3. kernel vs plain — each kernel against its plain PyTorch version on the
               card at main-path shapes, f32 (TF32 off) and bf16, within the
               stated tolerance; the flash kernels forward and backward
               against the plain version and autograd;
  4. goldens — golden_fs2, golden_vocoder and golden_trained_vocoder
               through the port in f32 at the CPU tests' tolerances, the
               golden_e2e sentences through TTSKing.speak from the npz
               export of the trained weights, and the JAX train step of
               golden_train_step.npz replayed through the port's train step;
  5. main paths — TTSConfig() at the shipped width: (a) synthesis with
               seeded weights (66 speakers) brought in through
               weights.flax_to_torch: TTSKing.speak on three Russian
               sentences (f32), then one batched generate + vocode at the
               bench shape B=32, L=128, T_mel=1000 (bf16); (b) training:
               train() for 4 optimizer steps of 16 x 4 on a synthetic
               preprocessed corpus written to a temporary directory (L = 96,
               T = 640), with validation, objective metrics and a
               checkpoint, then a resume for one more step. Every kernel
               launch count is zeroed just before each path and read just
               after, and must show the path's kernels ran (training: 40
               flash forward and 40 flash backward launches per step);
  6. train step — the sustained ms per optimizer step at the superbatch of
               bench.py:286-301 (acc 4 x B 16, L = 96, T = 640, f32);
  7. kernels — kernel time, plain time, library time and the card's bound at
               the bench shapes.

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

# H100 SXM data-sheet peaks: dense bf16 on the tensor cores, f32 on the
# CUDA cores, HBM3 bandwidth.
PEAK_BF16_OPS = 989e12
PEAK_F32_OPS = 67e12
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
#  * flash attention f32, forward and dq/dk/dv: f32 sums of up to T = 640
#    products in other orders, the forward with an online softmax and the
#    backward recomputing P from the log-sum-exp; 1e-4 on values of order
#    1. dK and dV at padded keys must be exactly 0.
TOL = {("attention", "f32"): 1e-4, ("attention", "bf16"): 2e-2,
       ("mrf_stage", "f32"): 1e-4, ("mrf_stage", "bf16"): 2.0 ** -5,
       ("flash_attention", "f32"): 1e-4}

# Shapes: the bench shape of bench.py:134-171 and the main-path shapes the
# kernels are checked at (attention: encoder- and decoder-like T, ragged;
# MRF: stages 1-3 of the shipped Generator at T_mel = 1000, two items),
# plus one narrow case each with a ragged edge (the goldens' widths).
BENCH_B, BENCH_L, BENCH_T = 32, 128, 1000
ATTN_CHECKS = [(8, 2, 128, 128), (8, 2, 1000, 128), (3, 2, 77, 16)]
MRF_CHECKS = [(2, 128, 64000), (2, 64, 128000), (2, 32, 256000),
              (3, 16, 4001)]
# Training: the superbatch of bench.py:286-301, and the flash kernels'
# shapes on that path (decoder T = 640, encoder L = 96) plus a ragged one.
TRAIN_ACC, TRAIN_B, TRAIN_L, TRAIN_T = 4, 16, 96, 640
FLASH_CHECKS = [(16, 2, 640, 128), (16, 2, 96, 128), (3, 2, 77, 16)]
TRAIN_STEPS = 4

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


def flash_inputs(B, H, T, D, seed, lens=None):
    """q, k, v as the FFT block hands them over ((B, T, H, D) Linear outputs
    viewed as (B, H, T, D)), requiring grad; a ragged key mask; an upstream
    gradient that is 0 on padded query rows, as the block's zeroing makes
    it."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    qkv = [torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
           .cuda().transpose(1, 2).requires_grad_(True) for _ in range(3)]
    if lens is None:
        lens = rng.randint(max(T // 2, 1), T + 1, size=(B,))
        lens[0] = T
    mask = torch.from_numpy(np.arange(T)[None] >= np.asarray(lens)[:, None])
    mask = mask.cuda()
    g = torch.from_numpy(rng.randn(B, H, T, D).astype(np.float32)).cuda()
    g = g * (~mask)[:, None, :, None]
    return qkv, mask, g


def phase_flash_vs_plain():
    """The flash kernels (forward, then dQ and dK/dV) against the plain
    version and autograd, at the training path's shapes."""
    import torch

    from tts_king_torch.ops.kernels import flash_attention as fa

    worst = 0.0
    tol = TOL[("flash_attention", "f32")]
    for B, H, T, D in FLASH_CHECKS:
        (q, k, v), mask, g = flash_inputs(B, H, T, D, seed=T)
        out = fa.flash_attention(q, k, v, mask)
        grads = torch.autograd.grad(out, (q, k, v), g)
        ref = fa.flash_attention_plain(q, k, v, mask)
        ref_grads = torch.autograd.grad(ref, (q, k, v), g)
        torch.cuda.synchronize()
        errs = {name: float((a - b).detach().abs().max()) for name, a, b in
                zip(("o", "dq", "dk", "dv"), (out,) + grads,
                    (ref,) + ref_grads)}
        pad = mask[:, None, :, None].expand_as(grads[1])
        pad_zero = (not bool(grads[1][pad].any())
                    and not bool(grads[2][pad].any()))
        finite = all(bool(torch.isfinite(t.detach()).all())
                     for t in (out,) + grads)
        ok = finite and pad_zero and max(errs.values()) <= tol
        emit({"phase": "kernel_vs_plain", "kernel": "flash_attention",
              "dtype": "f32", "shape": [B, H, T, D], "max_abs_err": errs,
              "padded_key_grads_zero": pad_zero, "tol": tol, "ok": ok})
        if not ok:
            fail(f"flash_attention {[B, H, T, D]}: errors {errs}, padded "
                 f"key grads zero {pad_zero}, finite {finite}")
        worst = max(worst, max(errs.values()))
    return worst


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


# ------------------------------------------------------- golden train step

GOLDEN_TRAIN = os.path.join(FIXTURES, "torch_port", "golden_train_step.npz")
# the model of the train-step goldens and tests (tests/test_torch_train.py)
TRAIN_N_SPEAKERS = 3
TRAIN_STATS = {"pitch": [-2.0, 2.0], "energy": [-2.0, 2.0]}
ADAM_B1 = 0.95   # OptimizerConfig's default beta 1


def port_model_no_dropout(model_cfg, variables, device="cpu"):
    """The port's FastSpeech2 of ``model_cfg`` (a plain dict of ModelConfig
    fields) with ``variables`` (a flax tree) and every dropout at p = 0."""
    from tts_king_torch import config as pcfg
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.models.layers import Dropout
    from tts_king_torch.weights import flax_to_torch, load_into

    model = build_fastspeech2(pcfg._build(pcfg.ModelConfig, model_cfg),
                              TRAIN_STATS, TRAIN_N_SPEAKERS)
    load_into(model, flax_to_torch(variables))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model.to(device)


def port_train_steps(model_cfg, opt_cfg, variables, superbatches,
                     device="cpu"):
    """The port's train step from ``variables``, one optimizer step per
    numpy superbatch, dropout off. Returns the state after each step as
    numpy, keyed by state-dict name."""
    import torch

    from tts_king_torch import config as pcfg
    from tts_king_torch.train.state import Optimizer, TrainState
    from tts_king_torch.train.step import make_train_step, to_device

    mc = pcfg._build(pcfg.ModelConfig, model_cfg)
    model = port_model_no_dropout(model_cfg, variables, device)
    optimizer = Optimizer(pcfg._build(pcfg.OptimizerConfig, opt_cfg),
                          mc.transformer.encoder_hidden)
    state = TrainState(model, optimizer.init(model))
    step = make_train_step(optimizer)
    gen = torch.Generator(device=device).manual_seed(0)

    def host(tree):   # copies: the next step updates in place
        return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}

    out = []
    for sb in superbatches:
        losses = step(state, to_device(sb, device), gen)
        out.append({"losses": dict(zip(losses._fields,
                                       (float(x) for x in losses))),
                    "state_dict": host(model.state_dict()),
                    "count": state.opt_state.count,
                    "mu": host(state.opt_state.mu),
                    "nu": host(state.opt_state.nu)})
    return out


def compare_train_step(got, want, lr, stats_atol=1e-6):
    """A port step (numpy, state-dict names) against a JAX step (flax trees:
    losses, params, batch_stats, count, mu, nu); raises on a mismatch and
    returns the largest errors.

    Tolerances, f32 on both sides with sums in other orders: losses rtol
    1e-5; the Adam moments and the clipped grads mu / (1 - b1) rtol 1e-4
    with an atol of 1e-5 of the largest magnitude over all parameters
    (entries near 0 carry the rounding of the large ones); running stats
    rtol 1e-5, atol ``stats_atol``; new params atol 1e-3 * lr. Adam moves
    each weight by lr * m_hat / (sqrt(v_hat) + eps), which a gradient error
    d moves by up to lr * d / eps: the optimizers of these checks use eps =
    1e-3, so that the gradients' rounding (d < 1e-8 here; the weights whose
    gradient is 0 in exact arithmetic, the key projection's bias and the
    conv biases in front of BatchNorm, get such rounding noise as their
    whole gradient) moves a weight by ~1e-4 * lr at most (5e-5 * lr
    measured on the CPU), while a wrong learning rate, bias correction or
    decay moves it by a visible share of lr."""
    import numpy as np

    from tts_king_torch.weights import flax_adam_to_torch, flax_to_torch

    errs = {"loss_rel": 0.0, "param_abs": 0.0, "stats_abs": 0.0,
            "grad_rel_top": 0.0}
    for name, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][name], v, rtol=1e-5,
                                   atol=1e-7, err_msg=f"loss {name}")
        errs["loss_rel"] = max(errs["loss_rel"], abs(
            got["losses"][name] - float(v)) / max(abs(float(v)), 1e-30))
    params = {k: v.numpy() for k, v in flax_to_torch(
        {"params": want["params"], "batch_stats": want["batch_stats"]}
    ).items()}
    adam = flax_adam_to_torch(want["count"], want["mu"], want["nu"])
    if got["count"] != adam.count:
        fail(f"Adam count {got['count']} vs {adam.count}")
    for k, v in params.items():
        stat = "running" in k
        np.testing.assert_allclose(
            got["state_dict"][k], v, rtol=1e-5 if stat else 0,
            atol=stats_atol if stat else 1e-3 * lr, err_msg=k)
        key = "stats_abs" if stat else "param_abs"
        errs[key] = max(errs[key], float(np.abs(got["state_dict"][k] - v)
                                         .max()))
    for coll, factor in (("mu", 1.0 / (1.0 - ADAM_B1)), ("mu", 1.0),
                         ("nu", 1.0)):
        ref = {k: v.numpy() * factor for k, v in getattr(adam, coll).items()}
        top = max(float(np.abs(r).max()) for r in ref.values())
        for k, v in got[coll].items():
            np.testing.assert_allclose(v * factor, ref[k], rtol=1e-4,
                                       atol=1e-5 * top, err_msg=f"{coll} {k}")
            if factor != 1.0:
                errs["grad_rel_top"] = max(errs["grad_rel_top"], float(
                    np.abs(v * factor - ref[k]).max()) / top)
    return errs


def replay_train_step_golden(device="cpu"):
    """golden_train_step.npz (scripts/export_train_step_golden.py: one JAX
    train step at acc = 2) through the port on ``device``, held to
    compare_train_step's tolerances. Returns (losses, max errors)."""
    import numpy as np

    from tts_king_torch.train.schedule import noam_schedule
    from tts_king_torch.weights import load_flax_npz

    z = np.load(GOLDEN_TRAIN)
    meta = json.loads(str(z["meta::config"]))
    trees = load_flax_npz(GOLDEN_TRAIN)
    variables = {"params": trees["params"],
                 "batch_stats": trees["batch_stats"]}
    sb = {k[len("in::"):]: z[k] for k in z.files if k.startswith("in::")}
    (got,) = port_train_steps(meta["model"], meta["optimizer"], variables,
                              [sb], device=device)
    want = {"losses": {k[len("out::loss::"):]: float(z[k]) for k in z.files
                       if k.startswith("out::loss::")},
            "count": int(z["out::count"]),
            **{c: trees[f"out_{c}"]
               for c in ("params", "batch_stats", "mu", "nu")}}
    lr = noam_schedule(meta["model"]["transformer"]["encoder_hidden"],
                       meta["optimizer"]["warm_up_step"], [], 1.0)(0)
    return got["losses"], compare_train_step(got, want, lr)


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


def launch_counts():
    """Every kernel wrapper's launch count."""
    from tts_king_torch.ops.kernels import attention, flash_attention, mrf

    return {"attention": attention.launches, "mrf_stage": mrf.launches,
            "flash_fwd": flash_attention.launches_fwd,
            "flash_bwd": flash_attention.launches_bwd}


def zero_launch_counts():
    from tts_king_torch.ops.kernels import attention, flash_attention, mrf

    attention.launches = mrf.launches = 0
    flash_attention.launches_fwd = flash_attention.launches_bwd = 0


def phase_main_path():
    import numpy as np
    import torch

    from tts_king_torch.pipeline import wav_to_int16

    cfg = main_config()
    cfg.preprocess.lexicon_path = os.path.join(E2E_DIR, "lexicon.dict")
    n_spk = 66
    kings = main_path_kings(cfg, n_spk)
    hop = cfg.preprocess.stft.hop_length
    sr = cfg.preprocess.audio.sampling_rate
    counts = launch_counts

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
    zero_launch_counts()
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
    for name in ("attention", "mrf_stage"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the synthesis path")
    emit({"phase": "main_path", "path": "synthesis", "launches": launches,
          "ok": True})
    return launches, [int(n) for n in mel_lens]


def bench_train_superbatch():
    """The training superbatch of bench.py:286-301 (acc 4 x B 16, L = 96,
    T = 640; 4-8 frames per phoneme, mel lengths capped at T), seeded as
    there."""
    import numpy as np

    acc, B, L, T = TRAIN_ACC, TRAIN_B, TRAIN_L, TRAIN_T
    rng = np.random.RandomState(4)
    d = rng.randint(4, 9, (acc, B, L))
    return dict(
        speakers=rng.randint(0, 66, (acc, B)).astype(np.int32),
        texts=rng.randint(1, 206, (acc, B, L)).astype(np.int32),
        src_lens=np.full((acc, B), L, np.int32),
        mels=rng.randn(acc, B, T, 80).astype(np.float32),
        mel_lens=np.minimum(d.sum(-1), T).astype(np.int32),
        energies=rng.randn(acc, B, L).astype(np.float32),
        durations=d.astype(np.int32),
        pitches_raw=rng.randn(acc, B, L).astype(np.float32),
        pitches_cwt=rng.randn(acc, B, L, 11).astype(np.float32),
        pitches_mean=rng.randn(acc, B).astype(np.float32),
        pitches_std=rng.rand(acc, B).astype(np.float32))


def train_corpus_config(tmp):
    """TTSConfig() (the shipped width) training on a synthetic preprocessed
    corpus under ``tmp``: enough utterances for TRAIN_STEPS optimizer steps
    of 16 x 4 with phoneme counts up to 96 and mel lengths up to 640 (so
    L = 96 and T = 640 after padding), and one val batch."""
    from tts_king_torch.config import StepConfig
    from tts_king_torch.data.synthetic import write_feature_corpus

    cfg = main_config()
    opt = cfg.train.optimizer
    n_train = TRAIN_STEPS * opt.batch_size * opt.grad_acc_step
    root = write_feature_corpus(
        os.path.join(tmp, "processed"), n_train, opt.batch_size,
        n_speakers=66, phones=(TRAIN_L * 5 // 8, TRAIN_L),
        frames=(TRAIN_T * 25 // 32, TRAIN_T), seed=0)
    cfg.preprocess.preprocessed_path = root
    cfg.train.ckpt_path = os.path.join(tmp, "ckpt")
    cfg.train.result_path = os.path.join(tmp, "result")
    cfg.train.step = StepConfig(total_step=TRAIN_STEPS, log_step=1,
                                synth_step=10 ** 6, val_step=TRAIN_STEPS,
                                save_step=TRAIN_STEPS)
    return cfg


def phase_train_path(device="cuda"):
    """train() at the shipped width for TRAIN_STEPS steps, validation and a
    checkpoint, then a resume for one more step. Every launch count is
    zeroed just before each train() call and read just after."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tts_king_torch.train.loop import train

    cfg = main_config()
    tc = cfg.model.transformer
    # one flash launch (forward and backward) per FFT block and microbatch
    per_step = ((tc.encoder_layer + tc.decoder_layer)
                * cfg.train.optimizer.grad_acc_step)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        cfg = train_corpus_config(tmp)
        corpus_s = time.perf_counter() - t0
        runs = []
        for restore, steps in ((0, TRAIN_STEPS), (TRAIN_STEPS,
                                                  TRAIN_STEPS + 1)):
            cfg.acoustic.restore_step = restore
            zero_launch_counts()
            t0 = time.perf_counter()
            state = train(cfg, max_steps=steps, device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()   # read just after the path's run
            n = steps - restore
            if state.step != steps:
                fail(f"train: ended at step {state.step}, not {steps}")
            if (launches["flash_fwd"] != per_step * n
                    or launches["flash_bwd"] != per_step * n):
                fail(f"train: flash launches {launches} for {n} steps "
                     f"(want {per_step} forward and backward per step)")
            if restore == 0 and launches["attention"] == 0:
                fail("train: validation launched no attention kernel")
            runs.append((restore, steps, wall, launches))
        with open(os.path.join(cfg.train.result_path,
                               f"{cfg.exp_name}.metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        train_recs = [r for r in recs if r["phase"] == "train"]
        losses = [r["total"] for r in train_recs]
        if len(losses) != TRAIN_STEPS + 1 or not np.all(np.isfinite(losses)):
            fail(f"train: losses {losses}")
        val = [r for r in recs if r["phase"] == "val"]
        obj = [r for r in recs if r["phase"] == "objective"]
        if len(val) != 1 or not np.isfinite(val[0]["total"]) or not obj:
            fail(f"train: val {val}, objective {obj}")
        # host time to read and collate one superbatch, as the loop does
        # between steps
        from tts_king_torch.data.dataset import FS2Dataset

        ds = FS2Dataset("train.txt", cfg.preprocess, cfg.train,
                        max_mel_len=cfg.model.max_seq_len)
        t0 = time.perf_counter()
        n_sb = sum(1 for _ in ds.epoch_superbatches(seed=cfg.train.seed))
        load_ms = (time.perf_counter() - t0) * 1e3 / n_sb
        ckpts = sorted(os.listdir(cfg.train.ckpt_path))
        if ckpts != [f"step_{TRAIN_STEPS:08d}", f"step_{TRAIN_STEPS + 1:08d}"]:
            fail(f"train: checkpoints {ckpts}")
        for restore, steps, wall, launches in runs:
            emit({"phase": "main_path", "path": "training",
                  "call": "train", "restore_step": restore,
                  "steps": steps - restore, "wall_s": wall,
                  "launches": launches,
                  "flash_per_step": launches["flash_fwd"] // (steps - restore),
                  "ok": True})
        emit({"phase": "main_path", "path": "training",
              "corpus_s": corpus_s, "losses": losses,
              "sec_per_step": [r["sec_per_step"] for r in train_recs],
              "load_ms_per_superbatch": load_ms,
              "val_total": val[0]["total"],
              "objective": {k: v for k, v in obj[0].items()
                            if k not in ("step", "t", "phase")},
              "checkpoints": ckpts, "ok": True})
        return runs[0][3]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_state_at_width(device="cuda"):
    """A TrainState of TTSConfig()'s FastSpeech2 on the card, initialized as
    train() does, with the bench's pitch/energy bins."""
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.train.state import (Optimizer, TrainState,
                                            init_state_dict)
    from tts_king_torch.weights import load_into

    import torch

    cfg = main_config()
    stats = {"pitch": [-7.0, 9.5], "energy": [-1.4, 6.1]}
    with torch.device("meta"):
        model = build_fastspeech2(cfg.model, stats, 66)
    model = load_into(model.to_empty(device=device),
                      init_state_dict(model, cfg.train.seed))
    optimizer = Optimizer(cfg.train.optimizer,
                          cfg.model.transformer.encoder_hidden)
    return TrainState(model, optimizer.init(model)), optimizer


def phase_train_step_time(smi, device="cuda"):
    """Sustained ms per optimizer step at the bench superbatch: host clock
    around each of 5 steps that end in a synchronize, after 2."""
    import torch

    from tts_king_torch.train.loop import step_generator
    from tts_king_torch.train.step import make_train_step, to_device

    state, optimizer = train_state_at_width(device=device)
    step = make_train_step(optimizer)
    sb = to_device(bench_train_superbatch(), device)
    for _ in range(2):
        step(state, sb, step_generator(0, state.step, device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        losses = step(state, sb, step_generator(0, state.step, device))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    total = float(losses.total)
    if not math.isfinite(total):
        fail(f"train step: loss {total}")
    out = {"phase": "train_step", "shape": {
        "acc": TRAIN_ACC, "B": TRAIN_B, "L": TRAIN_L, "T": TRAIN_T},
        "dtype": "f32", "ms_per_step": sum(times) / len(times),
        "ms_each": times, "loss": total,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "nvidia_smi": smi, "ok": True}
    emit(out)
    del state, sb
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 6


def phase_timing(cfg, launches, train_launches, errs, mel_lens):
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
    rows.append(flash_timing_row(cfg, train_launches, errs["flash_attention"]))
    return rows


def flash_timing_row(cfg, launches, max_err):
    """The flash kernels at the decoder's call of the bench training step
    (B=16, H=2, T=640, D=128, key mask from the bench superbatch's mel
    lengths): forward, backward (dQ then dK/dV), the plain version forward
    + autograd backward, and SDPA forward + backward with the same boolean
    key mask. The bound counts the products against the valid keys only,
    the work this mask needs: 4 T D per (row, valid key) forward and 10
    backward (S and dP recomputed, dV, dQ, dK), f32 on the CUDA cores."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tts_king_torch.ops.kernels import flash_attention as fa

    tc = cfg.model.transformer
    B, H, T = TRAIN_B, tc.decoder_head, TRAIN_T
    D = tc.decoder_hidden // H
    lens = bench_train_superbatch()["mel_lens"][0]
    (q, k, v), mask, g = flash_inputs(B, H, T, D, seed=11, lens=lens)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    m8 = mask.to(torch.uint8)
    o, lse = fa._forward_cuda(qd, kd, vd, m8)
    g = fa._out_like(qd).copy_(g)
    fwd_ms = cuda_ms(lambda: fa._forward_cuda(qd, kd, vd, m8), warmup=2,
                     reps=10)
    bwd_ms = cuda_ms(lambda: fa._backward_cuda(qd, kd, vd, m8, o, lse, g),
                     warmup=2, reps=10)

    def plain():
        out = fa.flash_attention_plain(q, k, v, mask)
        torch.autograd.grad(out, (q, k, v), g)

    keep = (~mask)[:, None, None, :]

    def sdpa():
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        torch.autograd.grad(out, (q, k, v), g)

    plain_ms = cuda_ms(plain, warmup=2, reps=10)
    lib_ms = cuda_ms(sdpa, warmup=2, reps=10)
    n_keys = float(np.sum(lens))
    ops_f = 4.0 * H * D * T * n_keys
    ops_b = 10.0 * H * D * T * n_keys
    elems = B * H * T * D
    bytes_f = 4.0 * (4 * elems + B * H * T) + B * T
    bytes_b = 4.0 * (8 * elems + B * H * T) + B * T
    t_ops = (ops_f + ops_b) / PEAK_F32_OPS
    t_bytes = (bytes_f + bytes_b) / PEAK_BYTES
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "tts_king_torch/csrc/flash_attention.cu",
        "replaces": "tts_king_tpu/ops/pallas/attention.py:102",
        "launches": launches["flash_fwd"], "launches_fwd":
        launches["flash_fwd"], "launches_bwd": launches["flash_bwd"],
        "max_abs_err": max_err, "ms": fwd_ms + bwd_ms,
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "fwd_bound_ms": max(ops_f / PEAK_F32_OPS, bytes_f / PEAK_BYTES) * 1e3,
        "bwd_bound_ms": max(ops_b / PEAK_F32_OPS, bytes_b / PEAK_BYTES) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib_ms, "dtype": "f32", "shape": [B, H, T, D],
        "note": "ms, plain_ms, library_ms: forward + backward; launches "
                "from the training path's run"}


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
    errs["flash_attention"] = phase_flash_vs_plain()
    phase_goldens()
    t0 = time.perf_counter()
    losses, golden_errs = replay_train_step_golden(device="cuda")
    emit({"phase": "golden", "fixture": "golden_train_step",
          "loss_total": losses["total"], "max_err": golden_errs,
          "tol": "tests/test_torch_train.py (compare_train_step)",
          "seconds": time.perf_counter() - t0, "ok": True})
    launches, mel_lens = phase_main_path()
    train_launches = phase_train_path()
    phase_train_step_time(smi)
    rows = phase_timing(main_config(), launches, train_launches, errs,
                        mel_lens)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
