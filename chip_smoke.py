#!/usr/bin/env python3
"""The PyTorch port's main paths on one CUDA card, checked end to end:
synthesis (TTSKing.speak, speak_streaming, batched generate + vocode), the
int8 vocoder (Generator(mrf_backend="fused_int8")), the other vocoder paths
(MelGAN, upstream .pth.tar checkpoints), FastSpeech2 training (train()
from a preprocessed corpus, with resume), the data-preparation path and the
CWT model, and HiFi-GAN GAN training (VocoderTrainer, train_vocoder).

Run from the root of a checkout, with one card and no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and ends the run with a
non-zero exit (nothing is caught):

  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — the four CUDA kernel sources compiled from
               tts_king_torch/csrc with nvcc for sm_90a, in parallel;
  3. kernel vs plain — each kernel against its plain PyTorch version on the
               card at main-path shapes, f32 (TF32 off) and bf16, within the
               stated tolerance (attention and flash also on masks with an
               item of length 1, padded key tiles in the middle and at the
               start of an item and, for attention, an item with no valid
               key, at a T no multiple of a key tile); the int8 MRF stage
               at stages 1-3's widths, a small-tile case with a
               time-varying gain and the edges of its cluster plan; the flash
               kernels forward and backward against the plain version and
               autograd;
  4. goldens — golden_fs2, golden_vocoder, golden_trained_vocoder and the
               JAX int8 vocoder (golden_int8_vocoder.npz) through the port
               in f32 at the CPU tests' tolerances, the upstream MelGAN
               oracle, a weight-normed HiFi-GAN .pth.tar through Vocoder
               against the same weights from npz, the golden_e2e sentences
               through TTSKing.speak from the npz export of the trained
               weights, and the JAX train step of golden_train_step.npz
               replayed through the port's train step;
  5. main paths — TTSConfig() at the shipped width: (a) synthesis with
               seeded weights (66 speakers) brought in through
               weights.flax_to_torch: TTSKing.speak on three Russian
               sentences (f32), one batched generate + vocode at the bench
               shape B=32, L=128, T_mel=1000 (bf16), and speak_streaming on
               one sentence (f32); (b) the int8 Generator at config 2b of
               bench.py (B=8, T_mel=1000, bf16) beside the fused bf16
               Generator; (c) training: train() for 4 optimizer steps of
               16 x 4 on a synthetic preprocessed corpus written to a
               temporary directory (L = 96, T = 640), with validation,
               objective metrics and a checkpoint, then a resume for one
               more step. Every kernel launch count is zeroed just before
               each path and read just after, and must show the path's
               kernels ran (training: 40 flash forward and 40 flash
               backward launches per step; int8: 3 per Generator call);
  6. data preparation and CWT — a raw synthetic corpus (4 speakers x 40
               utterances, wav + TextGrid) through the port's Preprocessor on
               the card (YIN), held against the same corpus prepared on the
               CPU and the golden's corpus against the JAX Preprocessor's
               golden, then the native DIO backend; train() of a use_cwt=True
               FastSpeech2 at the shipped width on the card's features (4
               steps, validation, a checkpoint, a resume), a timed train
               step, the JAX CWT train-step and forward goldens replayed;
               TTSKing.speak through the trained CWT model (f32) with launch
               counts, a B = 4 generate against the CPU and a flat pitch at
               B = 1;
  7. GAN training — (a) the JAX GAN step of golden_gan_step.npz replayed
               through VocoderTrainer in f32 at the CPU test's bounds; (b)
               the sustained ms per GAN step at bench.py:350-399's shape
               (B = 16 x 8192 samples, the published widths), f32 and
               bf16, with FLOPs from the conv shapes, share of peak and
               peak memory; (c) train_vocoder at batch 8 on generated wavs,
               4 steps, validation, a checkpoint, a resume for one more;
               (d) the trained generator folded into the fused inference
               Generator (f32 and bf16) on a 1000-frame mel against the
               weight-norm route, with 3 MRF launches a call;
  8. train step — the sustained ms per optimizer step at the superbatch of
               bench.py:286-301 (acc 4 x B 16, L = 96, T = 640, f32);
  9. kernels — kernel time, plain time, library time and the card's bound at
               the bench shapes (attention also at speak's f32 call, the
               MRF kernel's f32 route, 3xTF32 passes of (tile, branch)
               blocks, at speak's 192-frame sentence; f32 bounds as 3xTF32
               on the tensor cores, the CUDA-core f32 bound beside them),
               each kernel first held against its plain version on the very
               inputs it is timed on; the MRF rows also give the same convs
               through cuDNN at its fastest algorithms (cudnn_chain_ms) and
               each stage's grid (f32: blocks per pass, launches per stage);
               the int8 row its cluster plan per stage and the fused bf16
               kernel at the same stages (bf16_kernel_ms); the MRF rows
               the GAN export's launches (launches_gan).

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
#  * attention f32: the kernel's products are 3xTF32 (about 2^-21 of each
#    product), both sum in f32 in different orders and the kernel uses an
#    online softmax; 1e-4 on outputs of order 1.
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
#  * flash attention f32, forward and dq/dk/dv: 3xTF32 products summed in
#    f32 over up to T = 640 terms in other orders, the forward with an
#    online softmax and the backward recomputing P from the log-sum-exp;
#    1e-4 on values of order 1. dK and dV at padded keys must be exactly 0.
TOL = {("attention", "f32"): 1e-4, ("attention", "bf16"): 2e-2,
       ("mrf_stage", "f32"): 1e-4, ("mrf_stage", "bf16"): 2.0 ** -5,
       ("flash_attention", "f32"): 1e-4}

# Shapes: the bench shape of bench.py:134-171 and the main-path shapes the
# kernels are checked at (attention: encoder- and decoder-like T, ragged;
# MRF: stages 1-3 of the shipped Generator at T_mel = 1000, two items),
# plus one narrow case each with a ragged edge (the goldens' widths).
# The "edge" cases (B = 5, T no multiple of a key tile; key_mask) hold a
# full item, an item of length 1, padded key tiles in the middle and at the
# start of an item, and, for attention only, an item with no valid key (its
# rows average v over T); they cover each padded head dim the kernels
# instantiate (16, 32, 64, 128), and the flash kernels the train-step
# golden's D = 4.
BENCH_B, BENCH_L, BENCH_T = 32, 128, 1000
ATTN_CHECKS = [(8, 2, 128, 128, "suffix"), (8, 2, 1000, 128, "suffix"),
               (3, 2, 77, 16, "suffix"), (5, 2, 200, 128, "edge"),
               (5, 2, 77, 16, "edge"), (5, 2, 100, 64, "edge"),
               (5, 1, 50, 32, "edge")]
MRF_CHECKS = [(2, 128, 64000), (2, 64, 128000), (2, 32, 256000),
              (3, 16, 4001)]
# Training: the superbatch of bench.py:286-301, and the flash kernels'
# shapes on that path (decoder T = 640, encoder L = 96) plus a ragged one.
TRAIN_ACC, TRAIN_B, TRAIN_L, TRAIN_T = 4, 16, 96, 640
FLASH_CHECKS = [(16, 2, 640, 128, "suffix"), (16, 2, 96, 128, "suffix"),
                (3, 2, 77, 16, "suffix"), (5, 2, 200, 128, "edge"),
                (5, 2, 77, 16, "edge"), (5, 2, 50, 4, "edge")]
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


def key_mask(B, T, rng, kind="suffix", empty_item=True):
    """(B, T) bool, True = padded key. "suffix": lengths in [T/2, T], the
    first item full. "edge" (B >= 5): item 0 full; item 1 of length 1; item
    2 a random non-suffix mask (each key padded with probability 1/2, key 0
    and keys 32-127 padded: whole key tiles skipped in the middle); item 3
    its first T/4 keys (up to 64) padded, then a suffix length (leading
    tiles skipped); item 4 with no valid key if ``empty_item`` (else of
    length T/3); later items suffix."""
    import numpy as np

    lens = rng.randint(max(T // 2, 1), T + 1, size=(B,))
    lens[0] = T
    if kind == "edge":
        lens[1], lens[4] = 1, 0 if empty_item else max(T // 3, 1)
    mask = np.arange(T)[None] >= lens[:, None]
    if kind == "edge":
        mask[2] = rng.rand(T) < 0.5
        mask[2, 0] = True
        mask[2, 32:128] = True
        mask[3, :min(64, T // 4)] = True
    return mask


def attention_inputs(B, H, T, D, dtype, seed, kind="suffix"):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    qkv = [torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
           .to("cuda", dtype).transpose(1, 2) for _ in range(3)]
    mask = torch.from_numpy(key_mask(B, T, rng, kind)).cuda()
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


def phase_attention_vs_plain():
    """The inference attention kernel against its plain version, f32 and
    bf16, at ATTN_CHECKS. Returns the largest error per dtype."""
    import torch

    from tts_king_torch.ops.kernels import attention as attn

    errs = {}
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for B, H, T, D, kind in ATTN_CHECKS:
            (q, k, v), mask = attention_inputs(B, H, T, D, dtype, seed=T,
                                               kind=kind)
            got = attn.attention(q, k, v, mask).float()
            ref = attn.attention_plain(q, k, v, mask).float()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= TOL[
                ("attention", dname)]
            emit({"phase": "kernel_vs_plain", "kernel": "attention",
                  "dtype": dname, "shape": [B, H, T, D], "mask": kind,
                  "max_abs_err": err, "tol": TOL[("attention", dname)],
                  "ok": ok})
            if not ok:
                fail(f"attention {dname} {[B, H, T, D]} {kind}: max err "
                     f"{err}")
            errs[dname] = max(err, errs.get(dname, 0))
    return errs


def phase_kernels_vs_plain():
    import torch

    from tts_king_torch.ops.kernels import mrf

    errs = {"attention": phase_attention_vs_plain(), "mrf_stage": {}}
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
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


# int8 MRF stage, kernel vs plain: stages 1-3 of the shipped Generator (C,
# and r as the Generator picks it), B = 2, T covering two full TPU windows
# (TS = r * 1024 steps each) and half a third; then one case with a small
# tile and a time-varying gain, where the windows' scales differ most.
INT8_CHECKS = [(2, 128, 1, 2560, 1024, False), (2, 64, 2, 5120, 1024, False),
               (2, 32, 4, 10240, 1024, False), (2, 32, 4, 4096, 64, True)]
# The int8 kernel's cluster edges (mrf_int8.int8_plan): a T shorter than
# one CTA's rows (a cluster of one); a cluster of 2 whose second CTA holds
# rows outside [0, T) only; a last TPU tile of half length (6 CTAs);
# fewer channels than the padded width (C = 16, 4 CTAs, the int8 golden's
# stage 0); two passes a CTA over two tiles (C = 8, its stage 1). The
# tile = 64 gain case above runs on a cluster of one; in f32 the C = 128
# and C = 64 stages keep the branch sum in y, bf16 in shared memory.
INT8_EDGE_CHECKS = [(1, 128, 1, 32, 1024, False),
                    (1, 64, 2, 256, 1024, False),
                    (2, 64, 2, 3072, 1024, False),
                    (2, 16, 8, 2400, 1024, False),
                    (2, 8, 8, 9600, 1024, True)]
# Tolerances, int8 kernel vs plain on the card: both quantize the same
# values with the same f32 operations (IEEE division, round half up, the
# dequantization without FMA, the branch mean as an IEEE division by the
# branch count) and sum the integer products exactly, so they agree bit for
# bit; the bounds leave room for one ulp of the output. f32: max abs 1e-5
# and rel L2 1e-6 of the output; bf16: max abs 2^-6 of the output's largest
# magnitude (two ulps in its top binade) and rel L2 1e-3.
TOL_INT8 = {"f32": (1e-5, 1e-6), "bf16": (2.0 ** -6, 1e-3)}
# The int8 golden (tests/fixtures/torch_port/golden_int8_vocoder.npz,
# scripts/export_int8_vocoder_golden.py) at tests/test_torch_mrf_int8.py's
# bound: relative L2 to the JAX int8 waveform 1.25e-3, SNR to the JAX f32
# waveform > 25 dB.
GOLDEN_INT8 = os.path.join(FIXTURES, "torch_port", "golden_int8_vocoder.npz")
GOLDEN_INT8_REL = 1.25e-3
INT8_SNR_DB = 25.0
# Config 2b of bench.py:218-240: mel -> wav, B = 8, T_mel = 1000, bf16. Its
# waveform is held to the fused f32 Generator's at 15 dB SNR: the bf16
# rounding of every layer adds to the int8 noise here (the f32 golden holds
# the int8 path alone to 25 dB).
INT8_B, INT8_T = 8, 1000
INT8_BF16_SNR_DB = 15.0
PEAK_INT8_OPS = 1979e12


def int8_stage_inputs(B, C, T, dtype, seed, gain=False,
                      kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
    """x as the Generator hands it over (a (B, T, C) view of a (B, C, T)
    tensor), optionally with a gain of 10^U(-1, 1) per 64 steps, and a
    stage quantized from f32 weights N(0, 1/(C k))."""
    import torch

    from tts_king_torch.ops.kernels.mrf import MrfStageWeights
    from tts_king_torch.ops.kernels.mrf_int8 import quantize_mrf_stage

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, C, T), generator=g, device="cuda")
    if gain:
        seg = 10.0 ** (2 * torch.rand((B, 1, T // 64), generator=g,
                                      device="cuda") - 1)
        x = x * seg.repeat_interleave(64, dim=2)
    ws, bs = [], []
    for k in kernel_sizes:
        ws.append([torch.randn((C, C, k), generator=g, device="cuda")
                   / math.sqrt(C * k) for _ in range(2 * len(dilations))])
        bs.append([0.05 * torch.randn((C,), generator=g, device="cuda")
                   for _ in range(2 * len(dilations))])
    stage = MrfStageWeights(kernel_sizes, dilations, ws, bs)
    return x.to(dtype).transpose(1, 2), quantize_mrf_stage(stage)


def int8_plan_fields(plan):
    """The int8 kernel's launch, as the kernels line and the checks give
    it: cluster size, rows a CTA, passes, ring slots, shared bytes, grid."""
    return {"cluster": plan.cluster, "rows_per_cta": plan.rows,
            "passes": plan.passes, "slots": plan.slots, "smem": plan.smem,
            "grid": list(plan.grid)}


def phase_int8_vs_plain():
    """The int8 MRF kernel against its plain version on the card."""
    import torch

    from tts_king_torch.ops.kernels import mrf_int8

    worst = {}
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for B, C, r, T, tile, gain in INT8_CHECKS + INT8_EDGE_CHECKS:
            if mrf_int8.pack_factor(C, T) != r:
                fail(f"mrf_stage_int8: r for C={C}, T={T} is not {r}")
            x, q = int8_stage_inputs(B, C, T, dtype, seed=C + tile, gain=gain)
            got = mrf_int8.mrf_stage_int8(x, q, r, tile).float()
            ref = mrf_int8.mrf_stage_int8_plain(x, q, r, tile).float()
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            rel_l2 = float((got - ref).norm() / ref.norm())
            tol_abs, tol_rel = TOL_INT8[dname]
            ok = (bool(torch.isfinite(got).all()) and err <= tol_abs * scale
                  and rel_l2 <= tol_rel)
            plan = mrf_int8.int8_plan(T, C, r, q.kernel_sizes, q.dilations,
                                      B, dtype, tile)
            emit({"phase": "kernel_vs_plain", "kernel": "mrf_stage_int8",
                  "dtype": dname, "shape": [B, T, C], "r": r, "tile": tile,
                  "gain": gain, "plan": int8_plan_fields(plan),
                  "max_abs_err": err, "rel_l2": rel_l2,
                  "max_abs_ref": scale, "tol_abs": tol_abs * scale,
                  "tol_rel_l2": tol_rel, "ok": ok})
            if not ok:
                fail(f"mrf_stage_int8 {dname} C={C} tile={tile}: max err "
                     f"{err}, rel L2 {rel_l2}")
            worst[dname] = max(err, worst.get(dname, 0.0))
    return worst


def snr_db(got, ref):
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return 20.0 * math.log10(np.linalg.norm(ref)
                             / max(np.linalg.norm(got - ref), 1e-30))


def phase_int8_golden():
    """The JAX int8 vocoder golden replayed through the port in f32."""
    import numpy as np
    import torch

    from tts_king_torch.config import VocoderModelConfig
    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.weights import flax_to_torch, load_flax_npz, load_into

    z = np.load(GOLDEN_INT8)
    cfg = VocoderModelConfig(**json.loads(str(z["meta::config"])))
    gen = load_into(Generator(cfg, mrf_backend="fused_int8"),
                    flax_to_torch(load_flax_npz(GOLDEN_INT8))).cuda().eval()
    with torch.inference_mode():
        wav = gen(torch.from_numpy(z["in::mel"]).cuda()).cpu().numpy()
    ref = z["out::wav_int8"]
    rel = float(np.linalg.norm(wav - ref) / np.linalg.norm(ref))
    snr = snr_db(wav, z["out::wav_f32"])
    ok = wav.shape == ref.shape and rel <= GOLDEN_INT8_REL and snr > INT8_SNR_DB
    emit({"phase": "golden", "fixture": "golden_int8_vocoder",
          "rel_l2_vs_jax_int8": rel, "snr_db_vs_jax_f32": snr,
          "max_abs_err": float(np.abs(wav - ref).max()),
          "tol": f"rel L2 <= {GOLDEN_INT8_REL}, SNR > {INT8_SNR_DB} dB",
          "ok": ok})
    if not ok:
        fail(f"golden_int8_vocoder: rel {rel}, SNR {snr} dB")


def shipped_generator(cfg, backend, dtype):
    """TTSConfig()'s Generator on the card with seeded weights (seed 1, as
    main_path_kings), loaded in f32 and then cast, as the Vocoder does."""
    import torch

    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.weights import flax_to_torch, load_into

    with torch.device("meta"):
        gen = Generator(cfg.vocoder, mrf_backend=backend)
    voc_vars = seeded_flax_variables(lambda: Generator(cfg.vocoder), seed=1)
    gen = load_into(gen.to_empty(device="cuda"), flax_to_torch(voc_vars))
    return gen.to(dtype).eval()


def phase_int8_vocoder(cfg):
    """Config 2b: the int8 Generator at the shipped width, bf16, on a mel of
    B = 8, T_mel = 1000 (bench.py:218-240), beside the fused bf16 Generator
    at the same shape and against the fused f32 Generator. The counts are
    zeroed just before the timed int8 calls and read just after."""
    import numpy as np
    import torch

    from tts_king_torch.ops.kernels import mrf_int8

    B, T = INT8_B, INT8_T
    hop = cfg.preprocess.stft.hop_length
    sr = cfg.preprocess.audio.sampling_rate
    mel = torch.from_numpy(np.random.RandomState(2).randn(B, T, 80)
                           .astype(np.float32)).cuda()
    gen8 = shipped_generator(cfg, "fused_int8", torch.bfloat16)
    reps = 3
    with torch.inference_mode():
        gen8(mel)   # cuDNN's plans, the allocator's pools
        torch.cuda.synchronize()
        zero_launch_counts()
        int8_ms = cuda_ms(lambda: gen8(mel), warmup=0, reps=reps)
        launches = launch_counts()   # read just after the path's run
        wav8 = gen8(mel).float()
        del gen8
        gen16 = shipped_generator(cfg, "fused", torch.bfloat16)
        bf16_ms = cuda_ms(lambda: gen16(mel), warmup=1, reps=reps)
        wav16 = gen16(mel).float()
        del gen16
        gen32 = shipped_generator(cfg, "fused", torch.float32)
        wav32 = gen32(mel)
        del gen32
    torch.cuda.empty_cache()
    per_call = launches["mrf_stage_int8"] / reps
    n_fused = len(fused_stages(cfg, T))
    snr = snr_db(wav8.cpu().numpy(), wav32.cpu().numpy())
    snr16 = snr_db(wav16.cpu().numpy(), wav32.cpu().numpy())
    ok = (per_call == n_fused and launches["mrf_stage"] == 0
          and tuple(wav8.shape) == (B, T * hop)
          and bool(torch.isfinite(wav8).all()) and snr > INT8_BF16_SNR_DB)
    emit({"phase": "main_path", "path": "int8 vocoder",
          "call": "Generator(mrf_backend='fused_int8')", "dtype": "bf16",
          "shape": {"B": B, "T_mel": T}, "wall_ms": int8_ms,
          "rtf": int8_ms / 1e3 / (B * T * hop / sr),
          "fused_bf16_wall_ms": bf16_ms, "snr_db_vs_fused_f32": snr,
          "fused_bf16_snr_db_vs_fused_f32": snr16,
          "snr_gate_db": INT8_BF16_SNR_DB,
          "launches": launches, "int8_launches_per_call": per_call,
          "ok": ok})
    if not ok:
        fail(f"int8 vocoder: launches {launches}, SNR {snr} dB, shape "
             f"{tuple(wav8.shape)}")
    return launches


def int8_timing_row(cfg, launches, max_err):
    """Row 2b: the int8 kernel at config 2b's stages (B = 8, T_mel = 1000,
    bf16), the sum of one launch per fused stage, and the plain version;
    the kernel's output at each stage is held against the plain version's
    on the same inputs under TOL_INT8. The bound: 2 * 6 * sum(k) * C^2 int8
    operations per time step over the dense int8 rate, or the bf16
    activations in and out plus the int8 taps over the memory rate.
    bf16_kernel_ms: the fused bf16 kernel (mrf_stage) at the same stages
    and batch, the time the int8 kernel has to beat (not a library time);
    plan: each stage's cluster plan."""
    import torch

    from tts_king_torch.ops.kernels import mrf, mrf_int8

    B, T = INT8_B, INT8_T
    stages = fused_stages(cfg, T)
    plain_ms = ops = nbytes = 0.0
    stage_ms, bf16_ms, plans = [], [], []
    for C, Tw in stages:
        xb, stage = mrf_inputs(B, C, Tw, torch.bfloat16, seed=C)
        packed = mrf.pack_stage(stage)
        bf16_ms.append(cuda_ms(lambda: mrf.mrf_stage(xb, packed), warmup=1,
                               reps=3))
        del xb, stage, packed
    torch.cuda.empty_cache()
    tol_abs, tol_rel = TOL_INT8["bf16"]
    for C, Tw in stages:
        x, q = int8_stage_inputs(B, C, Tw, torch.bfloat16, seed=C)
        r = mrf_int8.pack_factor(C, Tw)
        plans.append(int8_plan_fields(mrf_int8.int8_plan(
            Tw, C, r, q.kernel_sizes, q.dilations, B, torch.bfloat16)))
        stage_ms.append(cuda_ms(lambda: mrf_int8.mrf_stage_int8(x, q, r),
                                warmup=1, reps=3))
        plain_ms += cuda_ms(lambda: mrf_int8.mrf_stage_int8_plain(x, q, r),
                            warmup=1, reps=1)
        got = mrf_int8.mrf_stage_int8(x, q, r).float()
        ref = mrf_int8.mrf_stage_int8_plain(x, q, r).float()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        rel_l2 = float((got - ref).norm() / ref.norm())
        ok = (bool(torch.isfinite(got).all()) and err <= tol_abs * scale
              and rel_l2 <= tol_rel)
        emit({"phase": "kernel_vs_plain", "kernel": "mrf_stage_int8",
              "dtype": "bf16", "shape": [B, Tw, C], "r": r,
              "tile": mrf_int8.TILE, "gain": False, "max_abs_err": err,
              "rel_l2": rel_l2, "max_abs_ref": scale,
              "tol_abs": tol_abs * scale, "tol_rel_l2": tol_rel, "ok": ok})
        if not ok:
            fail(f"mrf_stage_int8 bf16 at config 2b's C={C}, T={Tw}: max err "
                 f"{err}, rel L2 {rel_l2}")
        max_err = max(max_err, err)
        del got, ref
        ops += 2.0 * 6 * sum(q.kernel_sizes) * C * C * Tw * B
        n_w = q.taps.numel()
        nbytes += 2.0 * 2 * B * Tw * C + n_w + 4.0 * 2 * q.scales.numel()
        del x, q
        torch.cuda.empty_cache()
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return {
        "name": "mrf_stage_int8", "route": "cuda",
        "source": "tts_king_torch/csrc/mrf_stage_int8.cu",
        "replaces": "tts_king_tpu/ops/pallas/mrf_packed.py:172",
        "launches": launches["mrf_stage_int8"], "max_abs_err": max_err,
        "ms": sum(stage_ms), "stage_ms": stage_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "bf16_kernel_ms": sum(bf16_ms),
        "bf16_kernel_stage_ms": bf16_ms, "plan": plans, "dtype": "bf16",
        "shape": {"B": B, "T_mel": T, "stages_C_T": stages,
                  "note": "sum of one launch per fused stage; launches "
                          "from the int8 vocoder's run"}}


MELGAN_ORACLE = os.path.join(FIXTURES, "oracle_cache",
                             "melgan_d1eef7712903051ca869.npz")


def upstream_hifigan_state(vocoder_cfg, seed):
    """A weight-normed upstream HiFi-GAN Generator state dict (hifi/
    models.py names: ups.{i}, resblocks.{n}.convs1.{j} or .convs.{j}, ...)
    of the port Generator's shapes, seeded; weight_g is (out, 1, 1), torch's
    weight_norm at dim=0."""
    import numpy as np
    import torch

    from tts_king_torch.models.hifigan import Generator

    rng = np.random.RandomState(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  Generator(vocoder_cfg).state_dict().items()}
    state = {}
    for key, shape in shapes.items():
        mod, leaf = key.rsplit(".", 1)
        for a, b in (("ups_", "ups."), ("resblocks_", "resblocks."),
                     ("convs1_", "convs1."), ("convs2_", "convs2."),
                     ("convs_", "convs.")):
            mod = mod.replace(a, b)
        if leaf == "bias":
            state[f"{mod}.bias"] = 0.02 * rng.randn(*shape)
        else:
            state[f"{mod}.weight_v"] = 0.1 * rng.randn(*shape)
            state[f"{mod}.weight_g"] = 1.0 + 0.1 * rng.randn(
                shape[0], *[1] * (len(shape) - 1))
    return {k: torch.from_numpy(v.astype(np.float32))
            for k, v in state.items()}


def phase_vocoders():
    """MelGAN against the recorded upstream oracle (tests/test_melgan.py's
    inputs and tolerance), and a weight-normed HiFi-GAN .pth.tar loaded
    through Vocoder against the same folded weights loaded from npz."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tts_king_torch.checkpoint import (convert_hifigan_checkpoint,
                                           convert_melgan_state)
    from tts_king_torch.config import TTSConfig, VocoderModelConfig
    from tts_king_torch.models.melgan import MelGANGenerator
    from tts_king_torch.pipeline import Vocoder
    from scripts.export_flax_variables import flatten_variables
    from tts_king_torch.weights import load_into, torch_to_flax

    z = np.load(MELGAN_ORACLE)
    state = {k[len("state__"):]: torch.from_numpy(z[k]) for k in z.files
             if k.startswith("state__")}
    model = MelGANGenerator(ngf=4, n_residual_layers=2, ratios=(4, 2))
    model = load_into(model, convert_melgan_state(state, (4, 2), 2))
    model = model.cuda().eval()
    mel = np.random.RandomState(0).randn(2, 80, 17).astype(np.float32)
    with torch.inference_mode():
        wav = model(torch.from_numpy(mel.transpose(0, 2, 1).copy()).cuda())
    wav = wav.cpu().numpy()
    ref = z["wav"][:, 0, :]
    np.testing.assert_allclose(wav, ref, rtol=1e-4, atol=1e-5)
    emit({"phase": "golden", "fixture": "melgan oracle",
          "max_abs_err": float(np.abs(wav - ref).max()),
          "tol": "rtol 1e-4 atol 1e-5", "ok": True})

    cfg = TTSConfig(vocoder=VocoderModelConfig(
        upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
        upsample_initial_channel=32))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pth_")
    try:
        pth = os.path.join(tmp, "g_02500000.pth.tar")
        torch.save({"generator": upstream_hifigan_state(cfg.vocoder, 3)}, pth)
        flat = flatten_variables(torch_to_flax(
            convert_hifigan_checkpoint(pth, n_ups=2)))
        npz = os.path.join(tmp, "vocoder.npz")
        np.savez(npz, **flat)
        mel = np.random.RandomState(4).randn(2, 50, 80).astype(np.float32)
        wavs = {}
        for name, path in (("pth", pth), ("npz", npz)):
            cfg.vocoder.weights_path = path
            wavs[name] = Vocoder(cfg, device="cuda")(mel).cpu().numpy()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    err = float(np.abs(wavs["pth"] - wavs["npz"]).max())
    ok = wavs["pth"].shape == (2, 50 * 16) and err <= 1e-6
    emit({"phase": "checkpoint", "file": "HiFi-GAN .pth.tar, weight norm",
          "max_abs_err_vs_npz": err, "tol": 1e-6, "ok": ok})
    if not ok:
        fail(f"HiFi-GAN .pth.tar vs npz: max err {err}")


def phase_streaming(king, n_fused, n_layers, text):
    """TTSKing.speak_streaming on one sentence (f32): the chunks' interior
    equals speak()'s waveform (one LSB: cuDNN may sum a window's convs in
    another order than the whole utterance's), the total length is
    speak()'s, and the ms to the first chunk. Counts zeroed just before,
    read just after."""
    import numpy as np
    import torch

    from tts_king_torch.ops.streaming import generator_receptive_field

    cfg = king.cfg
    hop = cfg.preprocess.stft.hop_length
    zero_launch_counts()
    t0 = time.perf_counter()
    chunks, first_ms = [], None
    for chunk in king.speak_streaming(text):
        if first_ms is None:
            first_ms = (time.perf_counter() - t0) * 1e3
        chunks.append(chunk)
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()   # read just after the path's run
    torch.cuda.synchronize()
    wav = king.speak(text)[0]
    streamed = np.concatenate(chunks)
    edge = generator_receptive_field(cfg.vocoder) * hop
    diff = np.abs(streamed[edge:-edge].astype(np.int32)
                  - wav[edge:-edge].astype(np.int32))
    ok = (streamed.shape == wav.shape
          and all(c.dtype == np.int16 for c in chunks)
          and int(diff.max()) <= 1
          and launches["mrf_stage"] == n_fused * len(chunks)
          and launches["attention"] >= n_layers)
    emit({"phase": "main_path", "path": "streaming",
          "call": "TTSKing.speak_streaming", "dtype": "f32", "text": text,
          "chunks": len(chunks), "samples": int(streamed.shape[0]),
          "speak_samples": int(wav.shape[0]), "first_chunk_ms": first_ms,
          "total_ms": total_ms, "interior_max_lsb": int(diff.max()),
          "interior_frac_off": float(np.mean(diff > 0)),
          "launches": launches, "ok": ok})
    if not ok:
        fail(f"speak_streaming: {len(chunks)} chunks, {streamed.shape} vs "
             f"{wav.shape}, interior max {int(diff.max())} LSB, launches "
             f"{launches}")
    return launches


def flash_inputs(B, H, T, D, seed, lens=None, kind="suffix"):
    """q, k, v as the FFT block hands them over ((B, T, H, D) Linear outputs
    viewed as (B, H, T, D)), requiring grad; a key mask (``lens``, else
    key_mask's ``kind``, with no item lacking a valid key: training never
    has one); an upstream gradient that is 0 on padded query rows, as the
    block's zeroing makes it."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    qkv = [torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
           .cuda().transpose(1, 2).requires_grad_(True) for _ in range(3)]
    if lens is None:
        mask = key_mask(B, T, rng, kind, empty_item=False)
    else:
        mask = np.arange(T)[None] >= np.asarray(lens)[:, None]
    mask = torch.from_numpy(mask).cuda()
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
    for B, H, T, D, kind in FLASH_CHECKS:
        (q, k, v), mask, g = flash_inputs(B, H, T, D, seed=T, kind=kind)
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
              "dtype": "f32", "shape": [B, H, T, D], "mask": kind,
              "max_abs_err": errs,
              "padded_key_grads_zero": pad_zero, "tol": tol, "ok": ok})
        if not ok:
            fail(f"flash_attention {[B, H, T, D]} {kind}: errors {errs}, "
                 f"padded key grads zero {pad_zero}, finite {finite}")
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
    got = {k: v.cpu().numpy() for k, v in out.items() if v is not None}
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


def replay_train_step_golden(device="cpu", path=GOLDEN_TRAIN):
    """A train-step golden through the port on ``device``, held to
    compare_train_step's tolerances. golden_train_step.npz
    (scripts/export_train_step_golden.py) is one JAX train step at acc = 2;
    golden_cwt_train_step.npz (scripts/export_cwt_features_golden.py) is two
    steps of a CWT model, its inputs and losses with a leading step axis and
    the state after the last step, held at the two-step bounds of
    tests/test_torch_train.py. Returns (the last step's losses, max
    errors)."""
    import numpy as np

    from tts_king_torch.train.schedule import noam_schedule
    from tts_king_torch.weights import load_flax_npz

    z = np.load(path)
    meta = json.loads(str(z["meta::config"]))
    n = meta.get("steps", 1)
    trees = load_flax_npz(path)
    variables = {"params": trees["params"],
                 "batch_stats": trees["batch_stats"]}
    ins = {k[len("in::"):]: z[k] for k in z.files if k.startswith("in::")}
    sbs = ([ins] if n == 1 else
           [{k: v[i] for k, v in ins.items()} for i in range(n)])
    got = port_train_steps(meta["model"], meta["optimizer"], variables, sbs,
                           device=device)
    losses = {k[len("out::loss::"):]: np.reshape(z[k], (n,)) for k in z.files
              if k.startswith("out::loss::")}
    for i in range(n - 1):
        for name, v in losses.items():
            np.testing.assert_allclose(got[i]["losses"][name], v[i],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} loss {name}")
    want = {"losses": {k: float(v[-1]) for k, v in losses.items()},
            "count": int(z["out::count"]),
            **{c: trees[f"out_{c}"]
               for c in ("params", "batch_stats", "mu", "nu")}}
    lr = noam_schedule(meta["model"]["transformer"]["encoder_hidden"],
                       meta["optimizer"]["warm_up_step"], [], 1.0)(n - 1)
    # after a first step the weights already differ by rounding
    # (tests/test_torch_train.py::test_train_step_matches_jax)
    return got[-1]["losses"], compare_train_step(
        got[-1], want, lr, stats_atol=1e-6 if n == 1 else 1e-4)


# ------------------------------------------------------- the GAN-step golden

# scripts/export_gan_step_golden.py (JAX on the CPU) writes it
GOLDEN_GAN = os.path.join(FIXTURES, "torch_port", "golden_gan_step.npz")
GAN_ADAM_B1 = 0.8   # VocoderModelConfig's adam_b1


def gan_golden(path=GOLDEN_GAN):
    """(meta, the npz, its variable trees) of the GAN-step golden."""
    import numpy as np

    from tts_king_torch.weights import load_flax_npz

    z = np.load(path)
    return json.loads(str(z["meta::config"])), z, load_flax_npz(path)


def gan_trainer(meta, device="cpu", compute_dtype=None):
    """The port's VocoderTrainer at the golden's configuration."""
    from tts_king_torch.config import VocoderModelConfig
    from tts_king_torch.train.vocoder import VocoderTrainer

    return VocoderTrainer(
        VocoderModelConfig(**meta["vocoder"]),
        disc_p_channels=meta["disc_p_channels"], msd_width=meta["msd_width"],
        steps_per_epoch=meta["steps_per_epoch"], eps=meta["eps"],
        compute_dtype=compute_dtype, device=device)


def gan_state_dicts(trees, params="params", spectral="spectral"):
    """(generator, discriminators) state dicts of one of the golden's
    variable sets."""
    from tts_king_torch.weights import flax_to_torch

    p = trees[params]
    return (flax_to_torch({"params": p["gen"]}),
            flax_to_torch({"params": {"mpd": p["mpd"], "msd": p["msd"]},
                           "spectral": trees[spectral]}))


def gan_golden_batch(z, device="cpu"):
    import torch

    return {k: torch.from_numpy(z[f"in::{k}"]).to(device)
            for k in ("mel", "wav", "mel_loss")}


def compare_gan_step(state, losses, z, trees, lr):
    """A port GAN step (its state after the step and its losses) against
    the golden's JAX step; raises on a mismatch and returns the largest
    errors. The bounds are compare_train_step's: losses rtol 1e-5; params
    atol 1e-3 * lr (the optimizers run at eps = 1e-3, so a gradient's
    rounding moves a weight by far less); the Adam moments, and mu / (1 -
    b1), the gradient, rtol 1e-4 with an atol of 1e-5 of the largest
    magnitude of their optimizer; the spectral buffers u and v rtol 1e-4
    (atol 1e-6, for entries near 0 of these unit vectors); the counts
    exactly."""
    import numpy as np

    from tts_king_torch.weights import flax_to_torch

    errs = {"loss_rel": 0.0, "param_abs": 0.0, "uv_abs": 0.0,
            "grad_rel_top": 0.0}
    for name, v in zip(losses._fields, losses):
        want = float(z[f"out::loss::{name}"])
        np.testing.assert_allclose(float(v), want, rtol=1e-5, atol=1e-7,
                                   err_msg=f"loss {name}")
        errs["loss_rel"] = max(errs["loss_rel"],
                               abs(float(v) - want) / max(abs(want), 1e-30))
    gen_want, disc_want = gan_state_dicts(trees, "out_params", "out_spectral")

    def host(module):
        return {k: t.detach().float().cpu().numpy()
                for k, t in module.state_dict().items()}

    for got, want in ((host(state.gen), gen_want), (host(state.disc),
                                                     disc_want)):
        if got.keys() != want.keys():
            fail(f"GAN golden: state keys {sorted(set(got) ^ set(want))[:6]}")
        for k, w in want.items():
            w = w.numpy()
            uv = k.endswith((".u", ".v")) and w.ndim == 1
            np.testing.assert_allclose(got[k], w, rtol=1e-4 if uv else 0,
                                       atol=1e-6 if uv else 1e-3 * lr,
                                       err_msg=k)
            key = "uv_abs" if uv else "param_abs"
            errs[key] = max(errs[key], float(np.abs(got[k] - w).max()))
    for which, opt in (("gen", state.gen_opt), ("disc", state.disc_opt)):
        count = int(z[f"out::{which}_count"])
        if opt.count != count:
            fail(f"GAN golden: {which} Adam count {opt.count} vs {count}")
        for coll, factor in (("mu", 1.0 / (1.0 - GAN_ADAM_B1)), ("mu", 1.0),
                             ("nu", 1.0)):
            tree = trees[f"out_{which}_{coll}"]
            ref = {k: v.numpy() * factor for k, v in flax_to_torch(
                {"params": tree["gen"] if which == "gen" else tree}).items()}
            top = max(float(np.abs(r).max()) for r in ref.values())
            got = getattr(opt, coll)
            if got.keys() != ref.keys():
                fail(f"GAN golden: {which} {coll} keys differ")
            for k, v in got.items():
                v = v.detach().cpu().numpy() * factor
                np.testing.assert_allclose(v, ref[k], rtol=1e-4,
                                           atol=1e-5 * top,
                                           err_msg=f"{which} {coll} {k}")
                if factor != 1.0:
                    errs["grad_rel_top"] = max(errs["grad_rel_top"], float(
                        np.abs(v - ref[k]).max()) / top)
    if state.step != int(z["out::step"]):
        fail(f"GAN golden: step {state.step} vs {int(z['out::step'])}")
    return errs


def replay_gan_step_golden(device="cpu"):
    """golden_gan_step.npz through the port's VocoderTrainer on ``device``
    (f32): one train step from the golden's variables held to
    compare_gan_step, then the eval step's mel L1 (rtol 1e-5). Returns
    (losses, max errors)."""
    import numpy as np

    meta, z, trees = gan_golden()
    trainer = gan_trainer(meta, device)
    state = trainer.state_from(*gan_state_dicts(trees))
    batch = gan_golden_batch(z, device)
    losses = trainer.make_train_step()(state, batch)
    lr = meta["vocoder"]["learning_rate"]
    errs = compare_gan_step(state, losses, z, trees, lr)
    mel_l1 = float(trainer.make_eval_step()(state, batch))
    np.testing.assert_allclose(mel_l1, float(z["out::eval_mel_l1"]),
                               rtol=1e-5, err_msg="eval mel L1")
    errs["eval_mel_l1_rel"] = abs(mel_l1 - float(z["out::eval_mel_l1"])) \
        / float(z["out::eval_mel_l1"])
    return {k: float(v) for k, v in zip(losses._fields, losses)}, errs


# ------------------------------------------------- CWT and feature goldens

# scripts/export_cwt_features_golden.py (JAX on the CPU) writes these
GOLDEN_CWT_FS2 = os.path.join(FIXTURES, "torch_port", "golden_cwt_fs2.npz")
GOLDEN_CWT_TRAIN = os.path.join(FIXTURES, "torch_port",
                                "golden_cwt_train_step.npz")
GOLDEN_FEATURES = os.path.join(FIXTURES, "torch_port",
                               "golden_cwt_features.npz")


def compare_cwt_outputs(got, want):
    """A CWT FastSpeech2's outputs (numpy) against a reference's, at the
    bounds of tests/test_parity_fs2_extra.py::test_cwt_mode_parity:
    pitch_prediction, log_duration_prediction, pitch_mean and pitch_std at
    rtol/atol 1e-4, mel_lens equal, mel on each item's valid frames at rtol
    1e-3 / atol 3e-4. Raises on a mismatch; returns the largest errors."""
    import numpy as np

    errs = {}
    for key in ("pitch_prediction", "log_duration_prediction", "pitch_mean",
                "pitch_std"):
        if want.get(key) is not None:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-4, err_msg=key)
            errs[key] = float(np.abs(got[key] - want[key]).max())
    np.testing.assert_array_equal(got["mel_lens"], want["mel_lens"])
    if int(np.max(want["mel_lens"])) < 1:
        fail("CWT outputs: no mel frames to compare")
    errs["mel"] = 0.0
    for b, n in enumerate(np.asarray(want["mel_lens"]).astype(int)):
        g, w = got["mel"][b, :n], want["mel"][b, :n]
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=3e-4,
                                   err_msg=f"mel item {b}")
        errs["mel"] = max(errs["mel"], float(np.abs(g - w).max()))
    return errs


def replay_cwt_fs2_golden(device="cpu"):
    """golden_cwt_fs2.npz (a JAX CWT FastSpeech2 at micro width: its
    variables, a B = 3 batch of lengths 10 / 7 / 4 and the eval forward's
    outputs) through the port on ``device``, at compare_cwt_outputs'
    bounds. Returns the largest errors."""
    import numpy as np
    import torch

    from tts_king_torch.weights import load_flax_npz

    z = np.load(GOLDEN_CWT_FS2)
    meta = json.loads(str(z["meta::config"]))
    model = port_model_no_dropout(meta["model"], load_flax_npz(GOLDEN_CWT_FS2),
                                  device).eval()
    with torch.inference_mode():
        out = model(*(torch.from_numpy(z[f"in::{k}"]).to(device)
                      for k in ("speakers", "texts", "src_lens")),
                    max_mel_len=meta["max_mel_len"])
    got = {k: v.float().cpu().numpy() for k, v in out.items()
           if v is not None}
    want = {k[len("out::"):]: z[k] for k in z.files if k.startswith("out::")}
    return compare_cwt_outputs(got, want)


_FEATURE_KINDS = ("frame-pitch", "cwt-pitch", "pitch-mean", "pitch-std",
                  "pitch", "mel", "energy", "duration")
_F0_DERIVED = ("pitch", "cwt-pitch", "pitch-mean", "pitch-std")
# Log-mels are held in the linear domain, each bin at rtol 1e-4 (a log-mel
# error of 1e-4) plus an atol of 1e-6 of its frame's largest bin. Two f32
# FFTs differ in a bin by the rounding of the frame's loud bins: ~2e-8
# between XLA's and PyTorch's CPU FFTs, up to 2e-7 between cuFFT and the
# CPU, which in a quiet bin near the 1e-5 clip is a log-mel error of up to
# 3e-3 (each f32 STFT on the CPU is several 1e-4 from a float64 one there:
# tests/test_torch_features.py::test_mel_matches_float64_stft). TF32
# products would miss the loud bins by ~1e-3 relative.
MEL_RTOL, MEL_FRAME_ATOL = 1e-4, 1e-6


def feature_tree(root):
    """A prepared feature tree as {relative path: array, or text for
    .txt and .json files}."""
    import numpy as np

    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            rel = os.path.relpath(path, root)
            if n.endswith(".npy"):
                out[rel] = np.load(path)
            else:
                with open(path, encoding="utf-8") as f:
                    out[rel] = f.read()
    return out


def _feature_kind(rel):
    """(kind, speaker-name key) of a per-utterance feature file."""
    base = os.path.basename(rel)[: -len(".npy")]
    for kind in _FEATURE_KINDS:
        marker = f"-{kind}-"
        if marker in base:
            spk, name = base.split(marker, 1)
            return kind, (spk, name)
    raise ValueError(f"not a feature file: {rel}")


def compare_feature_trees(got, want, yin, max_flipped_share=1 / 6):
    """Two feature trees (feature_tree) of one corpus, held to each other:
    train.txt, val.txt and speakers.json identical, the same files,
    durations equal; the linear mel (exp of the log-mel) at rtol MEL_RTOL
    and an atol of MEL_FRAME_ATOL times its frame's largest bin; energy at
    rtol 1e-4 / atol 1e-4. The F0 files:

      * ``yin=False`` (the same F0 on both sides, e.g. the native DIO):
        pitch, cwt-pitch, frame-pitch, pitch-mean, pitch-std and stats.json
        at rtol 1e-4 / atol 1e-5;
      * ``yin=True`` (YIN through two FFT implementations, whose decisions
        are thresholds an ulp can flip): frame-pitch voicing agrees on
        >= 99% of all frames, and F0 within 0.1% relative on >= 99% of the
        frames both voice; for every utterance whose voicing agrees on all
        frames the F0-derived files at rtol 1e-3 (atol 1e-3: the corpus
        normalization of the pitch files moves with a flipped frame
        elsewhere), stats.json at rtol 1e-3 / atol 1e-3; at most
        ``max_flipped_share`` of the utterances (and at least one allowed)
        may have a flipped frame.

    Raises on a mismatch; returns a summary."""
    import numpy as np

    for name in ("train.txt", "val.txt", "speakers.json"):
        if got[name] != want[name]:
            fail(f"features: {name} differs")
    if sorted(got) != sorted(want):
        fail(f"features: files differ: "
             f"{sorted(set(got) ^ set(want))[:6]}")
    utts = {}
    for rel in want:
        if rel.endswith(".npy"):
            kind, key = _feature_kind(rel)
            utts.setdefault(key, {})[kind] = rel
    mel_err = mel_share = 0.0
    frames = agree = both = close = 0
    flipped = []
    for key, files in sorted(utts.items()):
        np.testing.assert_array_equal(got[files["duration"]],
                                      want[files["duration"]], err_msg=key)
        g, w = got[files["mel"]], want[files["mel"]]
        if g.shape != w.shape:
            fail(f"features: mel {key} {g.shape} vs {w.shape}")
        lin_g, lin_w = np.exp(g), np.exp(w)
        bound = (MEL_RTOL * lin_w
                 + MEL_FRAME_ATOL * lin_w.max(axis=-1, keepdims=True))
        share = np.abs(lin_g - lin_w) / bound
        if (share > 1).any():
            fail(f"features: mel {key}: {int((share > 1).sum())} bins out "
                 f"of bounds, the worst at {share.max():.2f} of its bound")
        mel_share = max(mel_share, float(share.max(initial=0.0)))
        mel_err = max(mel_err, float(np.abs(g - w).max(initial=0.0)))
        np.testing.assert_allclose(got[files["energy"]],
                                   want[files["energy"]], rtol=1e-4,
                                   atol=1e-4, err_msg=f"energy {key}")
        gf, wf = got[files["frame-pitch"]], want[files["frame-pitch"]]
        if gf.shape != wf.shape:
            fail(f"features: frame-pitch {key} {gf.shape} vs {wf.shape}")
        if not yin:
            for kind in _F0_DERIVED + ("frame-pitch",):
                np.testing.assert_allclose(
                    got[files[kind]], want[files[kind]], rtol=1e-4,
                    atol=1e-5, err_msg=f"{kind} {key}")
            continue
        same = (gf > 0) == (wf > 0)
        voiced = (gf > 0) & (wf > 0)
        frames += gf.size
        agree += int(same.sum())
        both += int(voiced.sum())
        close += int((np.abs(gf - wf)[voiced]
                      <= 1e-3 * np.abs(wf[voiced])).sum())
        if not same.all():
            flipped.append(key)
            continue
        for kind in _F0_DERIVED:
            np.testing.assert_allclose(
                got[files[kind]], want[files[kind]], rtol=1e-3, atol=1e-3,
                err_msg=f"{kind} {key}")
    rtol, atol = (1e-3, 1e-3) if yin else (1e-4, 1e-5)
    gs, ws = json.loads(got["stats.json"]), json.loads(want["stats.json"])
    for name in ws:
        np.testing.assert_allclose(gs[name], ws[name], rtol=rtol, atol=atol,
                                   err_msg=f"stats.json {name}")
    summary = {"utterances": len(utts), "log_mel_max_err": mel_err,
               "mel_worst_share_of_bound": mel_share}
    if yin:
        summary.update({"voicing_agree": agree / max(frames, 1),
                        "f0_close": close / max(both, 1),
                        "flipped_utterances": len(flipped)})
        if agree < 0.99 * frames or close < 0.99 * both:
            fail(f"features: YIN voicing agrees on {agree}/{frames} frames, "
                 f"F0 within 0.1% on {close}/{both}")
        if len(flipped) > max(1, int(max_flipped_share * len(utts))):
            fail(f"features: {len(flipped)} of {len(utts)} utterances have "
                 f"a flipped YIN frame")
    return summary


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
    from tts_king_torch.ops.kernels import (attention, flash_attention, mrf,
                                            mrf_int8)

    return {"attention": attention.launches, "mrf_stage": mrf.launches,
            "mrf_stage_int8": mrf_int8.launches,
            "flash_fwd": flash_attention.launches_fwd,
            "flash_bwd": flash_attention.launches_bwd}


def zero_launch_counts():
    from tts_king_torch.ops.kernels import (attention, flash_attention, mrf,
                                            mrf_int8)

    attention.launches = mrf.launches = mrf_int8.launches = 0
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
    mrf_runs = {"f32": 0, "bf16": 0}   # MRF launches by route
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
        mrf_runs["f32"] += d_mrf
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
    mrf_runs["bf16"] = d_mrf
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
    phase_streaming(king, n_fused, n_layers, SENTENCES[1])
    return launches, [int(n) for n in mel_lens], mrf_runs, kings


# ---------------------------------------------------------------- serving

SERVE_MAX_PHONEMES = 64
SERVE_CONTROLS = (1.0, 1.2)   # the two duration-control groups


def serve_requests(king, n, seed):
    """n requests: SENTENCES' phonemes and seeded phoneme rows of 8-64
    phonemes, speakers 0-2, the two duration controls in turn."""
    import numpy as np

    rng = np.random.RandomState(seed)
    rows = [king.text_preprocess(t)[0] for t in SENTENCES]
    while len(rows) < n:
        rows.append(rng.randint(1, 206, rng.randint(8, SERVE_MAX_PHONEMES + 1)))
    return [(np.asarray(p, np.int32), i % 3, SERVE_CONTROLS[i % 2])
            for i, p in enumerate(rows[:n])]


def percentile_ms(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs) * 1e3, q))


def serve_burst(server, requests, stream_text=None):
    """Submit every request at once (and, with stream_text, run one stream()
    while they are in flight); wait for all. Returns the wavs, each
    request's latency (s), the burst's wall seconds, and the stream's chunks
    and seconds to its first chunk."""
    import time as _time

    done = {}
    t0 = _time.perf_counter()
    futures = []
    for i, (phonemes, speaker, dctl) in enumerate(requests):
        t_sub = _time.perf_counter()
        f = server.submit(phonemes=phonemes, speaker=speaker,
                          duration_control=dctl)
        f.add_done_callback(lambda _, i=i: done.setdefault(
            i, _time.perf_counter()))
        futures.append((f, t_sub))
    chunks, first_s = [], None
    if stream_text is not None:
        ts = _time.perf_counter()
        for chunk in server.stream(text=stream_text):
            if first_s is None:
                first_s = _time.perf_counter() - ts
            chunks.append(chunk)
    wavs = [f.result(timeout=600) for f, _ in futures]
    wall = max(done.values()) - t0
    lat = [done[i] - t_sub for i, (_, t_sub) in enumerate(futures)]
    return wavs, lat, wall, chunks, first_s


def serve_summary(server, requests, wavs, lat, wall, sr, n_before):
    """The burst's numbers; its formed batches are those after the first
    n_before dispatches."""
    import numpy as np

    formed = list(server._trace_batches)[n_before:]
    audio_s = sum(len(w) for w in wavs) / sr
    return {"requests": len(requests), "wall_s": wall,
            "requests_per_s": len(requests) / wall,
            "audio_s_per_wall_s": audio_s / wall, "audio_s": audio_s,
            "latency_ms": {"p50": percentile_ms(lat, 50),
                           "p90": percentile_ms(lat, 90),
                           "max": float(max(lat) * 1e3)},
            "formed_batches": formed,
            "mean_formed_batch": float(np.mean(formed)),
            "stats": server.stats()}


def alone_wavs(king, phonemes, speaker, dctl):
    """The request run alone (B = 1: generate, then vocode_int16 on the
    whole bucket, trimmed) at its own phoneme padding and, where that
    leaves it under 2 padded positions, also at twice that padding.
    FastSpeech2's pitch and energy predictors (two k=3 convs, the speaker
    embedding added at padded positions too) read the two positions after
    the last phoneme, so a request's durations depend on whether it has 2
    padded positions; the JAX package's do alike. A served batch pads a
    request to its own bucket or to a larger one (at least twice it)."""
    import numpy as np

    from tts_king_torch.pipeline import _phone_pad

    hop = king.cfg.preprocess.stft.hop_length
    L = len(phonemes)
    widths = [L]
    if _phone_pad(L, king.tts.phone_buckets) < L + 2:
        widths.append(2 * _phone_pad(L, king.tts.phone_buckets))
    wavs = []
    for width in widths:
        row = np.zeros((1, width), np.int32)
        row[0, :L] = phonemes
        out = king.tts.generate(row, duration_control=dctl,
                                speaker_name=speaker, src_lens=[L])
        n = int(out["mel_lens"][0])
        wav = king.vocoder.vocode_int16(out["postnet_mel"])[0, :n * hop]
        wavs.append(wav.cpu().numpy())
    return wavs


def check_served_alone(king, requests, wavs, what, exact_f32=True):
    """Each served wav against the same request run alone (alone_wavs, the
    run of its padding whose length agrees). f32 (exact_f32): equal lengths
    but for at most 1 request in 16 one frame off; where equal, samples
    before the last generator_receptive_field frames more than 2 LSB apart
    at under 1% of them. bf16: a duration is round(exp(logd) - 1) of a bf16
    logd, and other kernels at another batch shape move logd by an ulp
    (~0.4%, ~0.04 of a 5-frame duration), so about one phoneme in ten may
    round the other way: lengths within max(2, 3%) frames of the run alone,
    samples only reported (one bf16 rounding apart is up to 128 LSB)."""
    import numpy as np
    import torch

    from tts_king_torch.ops.streaming import generator_receptive_field

    hop = king.cfg.preprocess.stft.hop_length
    edge = generator_receptive_field(king.cfg.vocoder) * hop
    off_frames, worst, t0 = {}, 0.0, time.perf_counter()
    n_wider = 0
    for i, ((phonemes, speaker, dctl), got) in enumerate(zip(requests,
                                                            wavs)):
        if got.dtype != np.int16 or got.ndim != 1 or len(got) % hop:
            fail(f"{what}: request {i}: {got.dtype} {got.shape}")
        alone = alone_wavs(king, phonemes, speaker, dctl)
        fracs = []
        for j, want in enumerate(alone):
            if len(want) != len(got):
                continue
            m = max(len(got) - edge, 0)
            fracs.append((float(np.mean(
                np.abs(got[:m].astype(np.int32)
                       - want[:m].astype(np.int32)) > 2)) if m else 0.0, j))
        if not fracs:
            diff = min((len(got) - len(w)) // hop for w in alone)
            n = len(alone[0]) // hop
            if (abs(diff) > 1 if exact_f32 else
                    abs(diff) > max(2, 0.03 * n)):
                fail(f"{what}: request {i}: {len(got) // hop} frames "
                     f"served, {n} alone")
            off_frames[i] = diff
            continue
        frac, j = min(fracs)
        n_wider += j
        worst = max(worst, frac)
        if exact_f32 and frac >= 0.01:
            fail(f"{what}: request {i}: {frac:.2%} of samples > 2 LSB off "
                 "the request run alone")
    if exact_f32 and len(off_frames) * 16 > len(requests):
        fail(f"{what}: requests {off_frames} one frame off the runs alone")
    torch.cuda.synchronize()
    return {"frames_off": off_frames, "worst_frac_off_gt2": worst,
            "matched_wider_padding": n_wider,
            "alone_total_s": time.perf_counter() - t0}


def http_checks(king, server, sr):
    """serve_http on port 0: /health, /stats, then one /tts and one /stream
    (with the ms to its first bytes: a handler thread is new for every
    request), each equal to server.submit / server.stream for the same
    body."""
    import io
    import threading
    import urllib.request
    import wave

    import numpy as np

    from tts_king_torch.serve import serve_http

    body = {"text": SENTENCES[0], "speaker": 1}
    httpd, hserver = serve_http(king, port=0, max_batch=4)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=300)

    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        with post("/tts") as r:
            with wave.open(io.BytesIO(r.read())) as w:
                rate = w.getframerate()
                wav = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        t0 = time.perf_counter()
        with post("/stream") as r:
            ctype = r.headers["Content-Type"]
            first = r.read(2)   # the first sample of the first chunk
            first_ms = (time.perf_counter() - t0) * 1e3
            pcm = np.frombuffer(first + r.read(), np.int16)
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        hserver.close()
        thread.join(timeout=30)
    want_wav = server.submit(text=body["text"],
                             speaker=body["speaker"]).result(timeout=300)
    want_pcm = np.concatenate(list(server.stream(text=body["text"],
                                                 speaker=body["speaker"])))
    ok = (health.get("ok") is True and rate == sr
          and ctype.startswith("audio/L16") and stats["completed"] == 1
          and np.array_equal(wav, want_wav)
          and np.array_equal(pcm, want_pcm))
    out = {"health": health, "stats": stats, "tts_samples": int(len(wav)),
           "stream_samples": int(len(pcm)), "stream_first_bytes_ms": first_ms,
           "tts_equals_submit": bool(np.array_equal(wav, want_wav)),
           "stream_equals_stream": bool(np.array_equal(pcm, want_pcm))}
    if not ok:
        fail(f"serve_http: {out}")
    return out


def phase_serving(kings, smi):
    """The serving layer (tts_king_torch/serve.py) at the shipped width:
    an f32 server (the CLI's default dtype) prewarmed for 64 phonemes
    serves a burst of 32 requests (SENTENCES and seeded rows, 3 speakers, 2
    duration controls) while one stream() of the 192-frame sentence runs,
    then serve_http answers /health, /stats, /tts and /stream; a bf16
    server (max_batch 16), prewarmed, serves a burst of 48. Checks: every
    served wav against its request run alone, the stream against
    TTSKing.speak_streaming at the JAX test's bound (> 1 LSB at under 0.1%
    of samples), the HTTP answers equal to submit / stream. Each burst
    follows one untimed burst of the same requests. Launch counts zeroed
    just before each server's timed burst and read just after it: f32
    gives rows 1f and 2f, bf16 rows 1 and 2."""
    import numpy as np
    import torch

    from tts_king_torch.serve import SynthesisServer

    cfg = kings["f32"].cfg
    sr = cfg.preprocess.audio.sampling_rate
    out, launches = {}, {}
    t_phase = time.perf_counter()
    for dname, max_batch, n_req in (("f32", 16, 32), ("bf16", 16, 48)):
        king = kings[dname]
        server = SynthesisServer(king, max_batch=max_batch)
        try:
            t0 = time.perf_counter()
            warmed = server.prewarm(max_phonemes=SERVE_MAX_PHONEMES,
                                    duration_controls=SERVE_CONTROLS)
            prewarm_s = time.perf_counter() - t0
            requests = serve_requests(king, n_req, seed=5)
            text = SENTENCES[1] if dname == "f32" else None
            # one untimed burst first, as the other paths make one untimed
            # call: the first burst after prewarm is slower (PERF.md §7)
            first_wall = serve_burst(server, requests)[2]
            n_before = len(server._trace_batches)
            zero_launch_counts()
            wavs, lat, wall, chunks, first_s = serve_burst(server, requests,
                                                           text)
            counts = launch_counts()   # read just after the traffic
            launches[dname] = {k: counts[k] for k in ("attention",
                                                      "mrf_stage")}
            res = {"prewarm_s": prewarm_s, "prewarmed": warmed,
                   "first_burst_wall_s": first_wall,
                   **serve_summary(server, requests, wavs, lat, wall, sr,
                                   n_before),
                   "launches": launches[dname]}
            if (res["stats"]["failed"]
                    or res["stats"]["completed"] != 2 * n_req):
                fail(f"serving {dname}: stats {res['stats']}")
            for name, n in launches[dname].items():
                if n == 0:
                    fail(f"serving {dname}: kernel {name} was not launched")
            res["vs_alone"] = check_served_alone(
                king, requests, wavs, f"serving {dname}",
                exact_f32=dname == "f32")
            if chunks:
                ref = np.concatenate(list(king.speak_streaming(text)))
                got = np.concatenate(chunks)
                frac = (float(np.mean(np.abs(got.astype(np.int32)
                                             - ref.astype(np.int32)) > 1))
                        if got.shape == ref.shape else 1.0)
                res["stream"] = {
                    "text": text, "chunks": len(chunks),
                    "first_chunk_ms": first_s * 1e3,
                    "samples": int(len(got)), "ref_samples": int(len(ref)),
                    "frac_off_gt1": frac}
                if got.shape != ref.shape or frac >= 1e-3:
                    fail(f"serving stream: {res['stream']}")
                res["http"] = http_checks(king, server, sr)
        finally:
            server.close()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out[dname] = res
        emit({"phase": "serving", "dtype": dname, "max_batch": max_batch,
              "nvidia_smi": smi, **res, "ok": True})
    emit({"phase": "serving", "launches": launches, "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase, "ok": True})
    return launches


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


def train_and_resume(cfg, device="cuda"):
    """train() of ``cfg`` for TRAIN_STEPS steps with validation, objective
    metrics and a checkpoint, then a resume for one more step. Every launch
    count is zeroed just before each train() call and read just after, and
    each step must launch one flash forward and backward per FFT block and
    microbatch. Returns the runs ((restore, steps, wall, launches) each),
    the train records, the val and objective records, the checkpoints and
    the resumed state."""
    import numpy as np
    import torch

    from tts_king_torch.train.loop import train

    tc = cfg.model.transformer
    per_step = ((tc.encoder_layer + tc.decoder_layer)
                * cfg.train.optimizer.grad_acc_step)
    runs = []
    for restore, steps in ((0, TRAIN_STEPS), (TRAIN_STEPS, TRAIN_STEPS + 1)):
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
    ckpts = sorted(os.listdir(cfg.train.ckpt_path))
    if ckpts != [f"step_{TRAIN_STEPS:08d}", f"step_{TRAIN_STEPS + 1:08d}"]:
        fail(f"train: checkpoints {ckpts}")
    return runs, train_recs, val[0], obj[0], ckpts, state


def emit_train_runs(path, runs):
    for restore, steps, wall, launches in runs:
        emit({"phase": "main_path", "path": path, "call": "train",
              "restore_step": restore, "steps": steps - restore,
              "wall_s": wall, "launches": launches,
              "flash_per_step": launches["flash_fwd"] // (steps - restore),
              "ok": True})


def phase_train_path(device="cuda"):
    """train() at the shipped width on a synthetic feature corpus
    (train_and_resume). Returns the first run's launch counts."""
    import shutil
    import tempfile

    from tts_king_torch.data.dataset import FS2Dataset

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        cfg = train_corpus_config(tmp)
        corpus_s = time.perf_counter() - t0
        runs, train_recs, val, obj, ckpts, _ = train_and_resume(cfg, device)
        # host time to read and collate one superbatch, as the loop does
        # between steps, by the loader train() picks and by the numpy one
        load_ms = {}
        for native in (None, False):
            ds = FS2Dataset("train.txt", cfg.preprocess, cfg.train,
                            max_mel_len=cfg.model.max_seq_len,
                            use_native_loader=native)
            t0 = time.perf_counter()
            n_sb = sum(1 for _ in ds.epoch_superbatches(seed=cfg.train.seed))
            load_ms["native" if ds.use_native_loader else "numpy"] = (
                (time.perf_counter() - t0) * 1e3 / n_sb)
        emit_train_runs("training", runs)
        emit({"phase": "main_path", "path": "training",
              "corpus_s": corpus_s,
              "losses": [r["total"] for r in train_recs],
              "sec_per_step": [r["sec_per_step"] for r in train_recs],
              "load_ms_per_superbatch": load_ms,
              "val_total": val["total"],
              "objective": {k: v for k, v in obj.items()
                            if k not in ("step", "t", "phase")},
              "checkpoints": ckpts, "ok": True})
        return runs[0][3]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------- data preparation + CWT

# the raw corpus of the CWT phase: 160 utterances (data/synthetic.py)
CWT_CORPUS = {"n_speakers": 4, "utts_per_speaker": 40, "seed": 0}


def prepare_features(cfg, out, backend, device):
    """Preprocessor(cfg.preprocess) of the raw corpus into ``out`` on
    ``device``; returns (wall seconds, the feature tree, the backend)."""
    import torch

    from tts_king_torch.data.features import Preprocessor

    cfg.preprocess.preprocessed_path = out
    t0 = time.perf_counter()
    pre = Preprocessor(cfg.preprocess, pitch_backend=backend, device=device)
    pre.build_from_path(seed=cfg.train.seed)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0, feature_tree(out), pre.pitch_backend


def golden_feature_tree():
    import numpy as np

    z = np.load(GOLDEN_FEATURES)
    tree = {k[len("tree::"):]: str(z[k]) if z[k].dtype.kind == "U" else z[k]
            for k in z.files if k.startswith("tree::")}
    return json.loads(str(z["meta::corpus"])), tree


def save_npz_weights(path, state_dict):
    """A state dict as the port's npz weights (``var::`` naming, the layout
    of scripts/export_flax_variables.py)."""
    import numpy as np

    from tts_king_torch.weights import torch_to_flax

    flat = {}

    def walk(coll, node, prefix):
        for key, value in node.items():
            p = f"{prefix}/{key}" if prefix else str(key)
            if hasattr(value, "items"):
                walk(coll, value, p)
            else:
                flat[f"var::{coll}::{p}"] = value

    for coll, tree in torch_to_flax(state_dict).items():
        walk(coll, tree, "")
    np.savez(path, **flat)


def phase_cwt_features(cfg, tmp, smi):
    """Steps 1-2 of the CWT phase: the raw corpus, its features on the card
    (YIN) held against the same corpus on the CPU, the golden's corpus on
    the card held against the JAX Preprocessor's golden, and the native DIO
    backend. Returns the card's feature directory."""
    from tts_king_torch.data.features import resolve_pitch_backend
    from tts_king_torch.data.synthetic import generate_corpus

    t0 = time.perf_counter()
    audio_s = generate_corpus(cfg.preprocess.raw_path, **CWT_CORPUS)
    corpus_s = time.perf_counter() - t0
    # a first run in the process (cuFFT plans, the allocator), then the one
    # whose tree is kept and timed
    cold_wall, _, _ = prepare_features(cfg, os.path.join(tmp, "cold"), "yin",
                                       "cuda")
    card_dir = os.path.join(tmp, "features_cuda")
    wall, card, backend = prepare_features(cfg, card_dir, "yin", "cuda")
    cpu_wall, cpu, _ = prepare_features(
        cfg, os.path.join(tmp, "features_cpu"), "yin", "cpu")
    vs_cpu = compare_feature_trees(card, cpu, yin=True)
    n_utts = sum(1 for k in card if k.startswith("mel"))
    emit({"phase": "cwt_path", "step": "features", "backend": backend,
          "device": "cuda", "utterances": n_utts, "audio_s": audio_s,
          "corpus_s": corpus_s, "wall_s": wall,
          "audio_s_per_wall_s": audio_s / wall, "first_run_wall_s": cold_wall,
          "cpu_wall_s": cpu_wall, "cpu_audio_s_per_wall_s": audio_s / cpu_wall,
          "vs_cpu": vs_cpu, "nvidia_smi": smi, "ok": True})

    corpus, want = golden_feature_tree()
    golden_cfg = main_config()
    golden_cfg.preprocess.raw_path = os.path.join(tmp, "golden_raw")
    generate_corpus(golden_cfg.preprocess.raw_path, **corpus)
    _, got, _ = prepare_features(golden_cfg, os.path.join(
        tmp, "golden_cuda"), "yin", "cuda")
    emit({"phase": "cwt_path", "step": "features_golden", "corpus": corpus,
          "vs_jax_golden": compare_feature_trees(got, want, yin=True),
          "ok": True})

    auto = resolve_pitch_backend("auto")
    native_wall, native_tree, _ = prepare_features(
        cfg, os.path.join(tmp, "features_native"), "native", "cuda")
    if native_tree["train.txt"] != card["train.txt"]:
        fail("features: the native backend kept other utterances")
    emit({"phase": "cwt_path", "step": "features", "backend": "native",
          "device": "cuda", "auto_backend": auto, "wall_s": native_wall,
          "audio_s_per_wall_s": audio_s / native_wall, "nvidia_smi": smi,
          "ok": True})
    cfg.preprocess.preprocessed_path = card_dir
    return card_dir


def phase_cwt_training(cfg, smi):
    """Step 3: train() of the CWT FastSpeech2 at the shipped width on the
    card's feature tree (train_and_resume), the ms of a train step on one
    of its superbatches, and the JAX CWT train-step golden replayed on the
    card. Returns the first run's launches and the resumed state."""
    import numpy as np
    import torch

    from tts_king_torch.data.dataset import FS2Dataset
    from tts_king_torch.train.loop import step_generator
    from tts_king_torch.train.state import Optimizer
    from tts_king_torch.train.step import make_train_step, to_device

    runs, train_recs, val, obj, ckpts, state = train_and_resume(cfg)
    emit_train_runs("cwt_training", runs)
    for r in train_recs:
        if not (np.isfinite(r["pitch_mean"]) and np.isfinite(r["pitch_std"])
                and r["pitch_mean"] > 0):
            fail(f"CWT train: mean/std losses {r}")
    ds = FS2Dataset("train.txt", cfg.preprocess, cfg.train,
                    max_mel_len=cfg.model.max_seq_len)
    sb = to_device(next(ds.epoch_superbatches(seed=cfg.train.seed)), "cuda")
    step = make_train_step(Optimizer(cfg.train.optimizer,
                                     cfg.model.transformer.encoder_hidden))
    times = []
    for i in range(4):
        t0 = time.perf_counter()
        losses = step(state, sb, step_generator(0, state.step, "cuda"))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not math.isfinite(float(losses.total)):
        fail(f"CWT train step: loss {float(losses.total)}")
    t0 = time.perf_counter()
    golden_losses, golden_errs = replay_train_step_golden(
        device="cuda", path=GOLDEN_CWT_TRAIN)
    emit({"phase": "cwt_path", "step": "training",
          "losses": [{k: r[k] for k in ("total", "mel", "pitch", "energy",
                                        "duration", "pitch_mean",
                                        "pitch_std")} for r in train_recs],
          "val": {k: v for k, v in val.items()
                  if k not in ("step", "t", "phase")},
          "objective": {k: v for k, v in obj.items()
                        if k not in ("step", "t", "phase")},
          "checkpoints": ckpts,
          "superbatch": {k: list(v.shape) for k, v in sb.items()
                         if k in ("texts", "mels")},
          "ms_per_step": sum(times[1:]) / 3, "ms_each": times,
          "flash_per_step": runs[0][3]["flash_fwd"] // TRAIN_STEPS,
          "golden": {"fixture": "golden_cwt_train_step", "losses":
                     golden_losses, "max_err": golden_errs,
                     "seconds": time.perf_counter() - t0},
          "cwt_fs2_golden_max_err": replay_cwt_fs2_golden(device="cuda"),
          "nvidia_smi": smi, "ok": True})
    return runs[0][3], state


def phase_cwt_speak(cfg, state, tmp, smi):
    """Step 4: TTSKing from the trained CWT FastSpeech2 (exported to npz
    beside the corpus's stats.json and speakers.json, the duration head set
    to about five frames a phoneme as in main_path_kings: 5 steps leave it
    near its random init) with the shipped HiFi-GAN in f32: speak on the
    three SENTENCES (launches counted), a warm median over 10 calls, a B = 4
    generate against the same model on the CPU, and a flat pitch at B = 1.
    Returns the launch counts of the three speak calls."""
    import shutil

    import numpy as np
    import torch

    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.ops.cwt import inverse_batch_cwt
    from tts_king_torch.pipeline import AcousticModel, TTSKing

    model_dir = os.path.join(tmp, "cwt_model")
    os.makedirs(model_dir)
    for name in ("stats.json", "speakers.json"):
        shutil.copy(os.path.join(cfg.preprocess.preprocessed_path, name),
                    model_dir)
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    head = "variance_adaptor.duration_predictor.linear_layer"
    sd[head + ".weight"] = sd[head + ".weight"] * 0.1
    sd[head + ".bias"] = torch.full_like(sd[head + ".bias"], math.log(6.0))
    cfg.acoustic.weights_path = os.path.join(model_dir, "fs2.npz")
    save_npz_weights(cfg.acoustic.weights_path, sd)
    cfg.preprocess.lexicon_path = os.path.join(E2E_DIR, "lexicon.dict")
    voc_vars = seeded_flax_variables(lambda: Generator(cfg.vocoder), seed=1)
    king = TTSKing(cfg, device="cuda", vocoder_variables=voc_vars)
    n_spk = len(king.speakers)
    hop = cfg.preprocess.stft.hop_length
    n_layers = (cfg.model.transformer.encoder_layer
                + cfg.model.transformer.decoder_layer)
    n_fused = len(fused_stages(cfg, BENCH_T))
    king.speak(SENTENCES[0])          # cuDNN's plans, the allocator's pools
    torch.cuda.synchronize()

    zero_launch_counts()
    calls = []
    for i, text in enumerate(SENTENCES):
        before = launch_counts()
        t0 = time.perf_counter()
        wav = king.speak(text, speaker=i % n_spk)[0]
        ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        d_att = after["attention"] - before["attention"]
        d_mrf = after["mrf_stage"] - before["mrf_stage"]
        if d_att < n_layers or d_mrf != n_fused:
            fail(f"CWT speak: attention launches {d_att} (>= {n_layers}), "
                 f"mrf {d_mrf} (== {n_fused})")
        if wav.dtype != np.int16 or wav.size == 0 or wav.size % hop:
            fail(f"CWT speak: {wav.dtype} {wav.shape}")
        calls.append({"text": text, "ms": ms, "samples": int(wav.size),
                      "launches": {"attention": d_att, "mrf_stage": d_mrf}})
    launches = launch_counts()   # read just after the path's run
    for name in ("attention", "mrf_stage"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the CWT speak path")

    warm = []
    for _ in range(10):
        t0 = time.perf_counter()
        king.speak(SENTENCES[1])
        warm.append((time.perf_counter() - t0) * 1e3)

    rng = np.random.RandomState(5)
    phonemes = rng.randint(1, 206, (4, 32))
    speakers = [i % n_spk for i in range(4)]
    cpu_model = AcousticModel(cfg, device="cpu")
    got = king.tts.generate(phonemes, speaker_name=speakers)
    want = cpu_model.generate(phonemes, speaker_name=speakers)
    got_lens = got["mel_lens"].cpu().numpy()
    want_lens = want["mel_lens"].numpy()
    if not np.array_equal(got_lens, want_lens):
        fail(f"CWT generate: card mel lengths {got_lens} vs CPU {want_lens}")
    maes = [float(np.mean(np.abs(got["postnet_mel"][b, :n].cpu().numpy()
                                 - want["postnet_mel"][b, :n].numpy())))
            for b, n in enumerate(want_lens)]
    if max(maes) >= 1e-3:
        fail(f"CWT generate: mel MAE card vs CPU {maes}")
    one = king.tts.generate(phonemes[:1], speaker_name=speakers[:1])
    if bool(inverse_batch_cwt(one["pitch_prediction"]).any()):
        fail("CWT generate: a batch of one has no flat pitch")
    emit({"phase": "cwt_path", "step": "speak", "dtype": "f32",
          "calls": calls, "warm_median_ms": float(np.median(warm)),
          "warm_ms": warm, "launches": launches,
          "generate_B4": {"mel_lens": [int(n) for n in want_lens],
                          "mel_mae_vs_cpu": maes},
          "flat_pitch_B1": True, "nvidia_smi": smi, "ok": True})
    return launches


def phase_cwt_path(smi):
    """The data-preparation path and the CWT FastSpeech2 on the card: a
    raw corpus (CWT_CORPUS) through the Preprocessor, train() of a
    use_cwt=True model at the shipped width on the card's features, and
    speak through it (phase_cwt_features, phase_cwt_training,
    phase_cwt_speak). Every launch count is zeroed just before each path
    and read just after. Returns the training and speak launch counts."""
    import shutil
    import tempfile

    from tts_king_torch.config import StepConfig

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cwt_")
    try:
        cfg = main_config()
        cfg.model.use_cwt = True
        cfg.preprocess.raw_path = os.path.join(tmp, "raw")
        cfg.train.ckpt_path = os.path.join(tmp, "ckpt")
        cfg.train.result_path = os.path.join(tmp, "result")
        cfg.train.step = StepConfig(total_step=TRAIN_STEPS, log_step=1,
                                    synth_step=10 ** 6, val_step=TRAIN_STEPS,
                                    save_step=TRAIN_STEPS)
        phase_cwt_features(cfg, tmp, smi)
        train_launches, state = phase_cwt_training(cfg, smi)
        speak_launches = phase_cwt_speak(cfg, state, tmp, smi)
        return {"train": train_launches, "speak": speak_launches}
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


# ----------------------------------------------------------- the GAN path

# The GAN step's shape at bench.py:350-399, the upstream recipe: batch 16 of
# 8192-sample segments (32 mel frames); bench.py:347's useful FLOPs of the
# JAX step there (XLA's cost analysis of its native-lowering f32 program),
# printed beside the port's count.
GAN_B = 16
GAN_JAX_USEFUL_FLOPS = 2.602e12
# train_vocoder's corpus (generate_corpus: 16 utterances of ~2 s; 2
# validate) and batch; the export check's mel length.
GAN_CORPUS = {"n_speakers": 2, "utts_per_speaker": 8, "seed": 3}
GAN_LOOP_BATCH = 8
GAN_EXPORT_T = 1000


def gan_bench_batch(cfg, B=None, device="cuda"):
    """bench.py's seeded GAN batch (B = GAN_B): mel and loss mel N(0, 1),
    wav N(0, 0.01)."""
    import numpy as np
    import torch

    B = B or GAN_B
    vc = cfg.vocoder
    frames = vc.segment_size // vc.hop_size
    rng = np.random.RandomState(6)
    batch = dict(
        mel=rng.randn(B, frames, vc.num_mels).astype(np.float32),
        wav=(rng.randn(B, vc.segment_size) * 0.1).astype(np.float32),
        mel_loss=rng.randn(B, frames, vc.num_mels).astype(np.float32))
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def gan_step_flops(state, batch):
    """FLOPs of one GAN step, reckoned from the conv shapes of one forward
    (2 per multiply-add; a conv's output elements, a transposed conv's input
    elements, times each weight's fan): the generator forward and its
    backward (data and weight gradients, 2x the forward); the
    discriminators on y and y_hat forward and backward in the
    discriminators' half (3x); in the generator's half forward and the data
    gradient of the y_hat half (1.5x). The STFT of the mel loss and the
    elementwise work are left out."""
    import torch

    from tts_king_torch.models.hifigan import WNConvTranspose1d

    total = {"gen": 0.0, "disc": 0.0}

    def hook(key):
        def count(module, inputs, out):
            w = module.v if hasattr(module, "v") and module.v.dim() > 1 \
                else module.weight_orig
            n = (inputs[0].numel() if isinstance(module, WNConvTranspose1d)
                 else out.numel())
            total[key] += 2.0 * n * w[0].numel()
        return count

    handles = []
    for key, root in (("gen", state.gen), ("disc", state.disc)):
        for m in root.modules():
            if hasattr(m, "weight_orig") or (hasattr(m, "v") and hasattr(
                    m, "g")):
                handles.append(m.register_forward_hook(hook(key)))
    try:
        with torch.no_grad():
            y_hat = state.gen(batch["mel"])
            state.disc.mpd(batch["wav"], y_hat, pair_batched=False)
            state.disc.msd(batch["wav"], y_hat, pair_batched=False)
    finally:
        for h in handles:
            h.remove()
    return {"gen_fwd": total["gen"], "disc_fwd_pair": total["disc"],
            "step": 3.0 * total["gen"] + 4.5 * total["disc"]}


def phase_gan_step_time(smi, device="cuda"):
    """Sustained ms per GAN step of VocoderTrainer at TTSConfig()'s width
    (MPD channels (32, 128, 512, 1024, 1024), the 3-scale MSD at width 1)
    on gan_bench_batch, f32 (TF32 off) and with compute_dtype bf16: host
    clock around each of 6 steps that end in a synchronize, after 2; the
    median. Peak memory, FLOPs per step and their share of the dtype's
    peak."""
    import numpy as np
    import torch

    from tts_king_torch.train.vocoder import VocoderTrainer

    cfg = main_config()
    out = {}
    for dname, dtype, peak in (("f32", None, PEAK_F32_OPS),
                               ("bf16", torch.bfloat16, PEAK_BF16_OPS)):
        trainer = VocoderTrainer(cfg.vocoder, compute_dtype=dtype,
                                 device=device)
        state = trainer.init_state(cfg.vocoder.seed)
        batch = gan_bench_batch(cfg, device=device)
        flops = gan_step_flops(state, batch)
        step = trainer.make_train_step()
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            losses = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in zip(losses._fields, losses)}
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"GAN step {dname}: losses {vals}")
        ms = float(np.median(times))
        out[dname] = {
            "phase": "gan_path", "step": "step_time", "dtype": dname,
            "shape": {"B": GAN_B, "segment": cfg.vocoder.segment_size,
                      "frames": cfg.vocoder.segment_size
                      // cfg.vocoder.hop_size},
            "ms_per_step": ms, "ms_each": times, "losses": vals,
            "flops_per_step": flops["step"], "flops": flops,
            "jax_useful_flops_per_step": GAN_JAX_USEFUL_FLOPS,
            "share_of_peak": flops["step"] / (ms / 1e3) / peak,
            "peak": peak,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "nvidia_smi": smi, "ok": True}
        emit(out[dname])
        del state, batch, step, trainer
        torch.cuda.empty_cache()
    return out


def phase_gan_train_vocoder(tmp, smi, device="cuda"):
    """train_vocoder() at TTSConfig()'s width on GAN_CORPUS's wavs, batch
    GAN_LOOP_BATCH: 4 steps with validation and a checkpoint, then a resume
    from step 4 for one more. Checks the metrics' phases, the checkpoint's
    GAN state (the first run's spectral buffers and weights, Adam counts 4)
    and the resumed state. Returns the final state."""
    import numpy as np
    import torch

    from tts_king_torch.data.synthetic import generate_corpus
    from tts_king_torch.train.checkpoint import restore_vocoder_state
    from tts_king_torch.train.vocoder_loop import train_vocoder

    cfg = main_config()
    cfg.vocoder.batch_size = GAN_LOOP_BATCH
    cfg.train.ckpt_path = os.path.join(tmp, "ckpt")
    cfg.train.result_path = os.path.join(tmp, "result")
    raw = os.path.join(tmp, "wavs")
    audio_s = generate_corpus(raw, **GAN_CORPUS)
    wavs = sorted(os.path.join(root, n) for root, _, names in os.walk(raw)
                  for n in names if n.endswith(".wav"))
    runs = []
    for restore, steps in ((None, TRAIN_STEPS), (TRAIN_STEPS,
                                                 TRAIN_STEPS + 1)):
        t0 = time.perf_counter()
        state = train_vocoder(cfg, wavs[2:], val_paths=wavs[:2],
                              max_steps=steps, log_every=1,
                              save_every=TRAIN_STEPS, restore_step=restore,
                              device=device)
        torch.cuda.synchronize()
        runs.append({"restore_step": restore, "steps": steps,
                     "wall_s": time.perf_counter() - t0})
        if state.step != steps or state.gen_opt.count != steps \
                or state.disc_opt.count != steps:
            fail(f"train_vocoder: step {state.step}, Adam counts "
                 f"{state.gen_opt.count} / {state.disc_opt.count}, not "
                 f"{steps}")
        if restore is None:
            first = {k: v.detach().cpu() for k, v in
                     state.disc.state_dict().items()}
    ckpt_dir = os.path.join(cfg.train.ckpt_path, "vocoder")
    payload = restore_vocoder_state(ckpt_dir, TRAIN_STEPS)
    gan = payload["gan_state"]
    if (gan["step"] != TRAIN_STEPS or gan["gen_opt"]["count"] != TRAIN_STEPS
            or gan["disc_opt"]["count"] != TRAIN_STEPS
            or any(not torch.equal(gan["disc"][k], v)
                   for k, v in first.items())):
        fail("train_vocoder: the step-4 checkpoint is not the run's state")
    with open(os.path.join(cfg.train.result_path,
                           f"{cfg.exp_name}_vocoder.metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    phases = [r["phase"] for r in recs]
    want = (["vocoder"] * TRAIN_STEPS + ["vocoder_val"] * 2
            + ["vocoder", "vocoder_val"])
    mel_l1 = [r["mel_l1"] for r in recs if r["phase"] == "vocoder"]
    val = [r["val_mel_l1"] for r in recs if r["phase"] == "vocoder_val"]
    if phases != want or not np.all(np.isfinite(mel_l1 + val)):
        fail(f"train_vocoder: metrics {phases}, mel L1 {mel_l1}, val {val}")
    emit({"phase": "gan_path", "step": "train_vocoder", "batch":
          GAN_LOOP_BATCH, "wavs": len(wavs), "audio_s": audio_s, "runs": runs,
          "mel_l1": mel_l1, "val_mel_l1": val,
          "checkpoints": sorted(os.listdir(ckpt_dir)),
          "spectral_buffers_restored": True, "nvidia_smi": smi, "ok": True})
    return state


def phase_gan_export(state, smi, device="cuda"):
    """The trained generator folded (export_inference_params) into
    Generator(mrf_backend="fused"), in f32 and cast to bf16, on one
    GAN_EXPORT_T-frame mel, held against the plain weight-norm route in the
    same compute dtype: f32 at TOL[mrf_stage, f32], bf16 at TOL[mrf_stage,
    bf16], relative to max(1, the waveform's peak). Each Generator call's
    launches are counted from 0: one MRF stage launch per fused stage (3 at
    the shipped width). Returns the launches per dtype."""
    import numpy as np
    import torch

    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.train.vocoder import export_inference_params
    from tts_king_torch.weights import load_into

    vc = main_config().vocoder
    n_fused = len(fused_stages(main_config(), GAN_EXPORT_T))
    folded = export_inference_params(state.gen)
    mel = torch.from_numpy(np.random.RandomState(9).randn(
        1, GAN_EXPORT_T, vc.num_mels).astype(np.float32)).to(device)
    launches = {}
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        fused = load_into(Generator(vc), folded).to(device, dtype).eval()
        wn = Generator(vc, mrf_backend="plain", weight_norm=True,
                       compute_dtype=dtype)
        wn = load_into(wn, {k: v.cpu() for k, v in
                            state.gen.state_dict().items()}).to(device)
        with torch.inference_mode():
            ref = wn(mel)
            zero_launch_counts()
            got = fused(mel)
            torch.cuda.synchronize()
            launches[dname] = launch_counts()["mrf_stage"]
            ms = cuda_ms(lambda: fused(mel), warmup=1, reps=3)
            plain_ms = cuda_ms(lambda: wn(mel), warmup=1, reps=3)
        scale = max(1.0, float(ref.abs().max()))
        err = float((got - ref).abs().max())
        tol = TOL[("mrf_stage", dname)] * scale
        if not (bool(torch.isfinite(got).all()) and err <= tol):
            fail(f"GAN export {dname}: max err {err} > {tol}")
        if launches[dname] != n_fused:
            fail(f"GAN export {dname}: {launches[dname]} MRF launches in one "
                 f"Generator call, not {n_fused}")
        emit({"phase": "gan_path", "step": "export", "dtype": dname,
              "T_mel": GAN_EXPORT_T, "max_abs_err": err, "tol": tol,
              "wav_peak": float(ref.abs().max()), "mrf_launches": launches[
                  dname], "fused_ms": ms, "plain_wn_ms": plain_ms,
              "nvidia_smi": smi, "ok": True})
        del fused, wn
    return launches


def phase_gan_path(smi):
    """HiFi-GAN GAN training on the card: (a) the JAX GAN step of
    golden_gan_step.npz replayed in f32 at the CPU test's bounds; (b) the
    step's time at bench.py's shape, f32 and bf16; (c) train_vocoder with a
    resume; (d) its generator folded into the fused inference Generator.
    Returns the export's MRF launches per dtype."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    losses, errs = replay_gan_step_golden(device="cuda")
    emit({"phase": "gan_path", "step": "golden", "losses": losses,
          "max_err": errs, "tol": "tests/test_torch_vocoder_training.py "
          "(compare_gan_step)", "seconds": time.perf_counter() - t0,
          "ok": True})
    phase_gan_step_time(smi)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gan_")
    try:
        state = phase_gan_train_vocoder(tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = phase_gan_export(state, smi)
    emit({"phase": "gan_path", "step": "done",
          "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------- phase 6


# f32 operations as 3xTF32 on the tensor cores: three TF32 products each.
PEAK_TF32_OPS = 495e12
# TTSKing.speak's decoder call for the 192-frame sentence: the 256 bucket.
SPEAK_T, SPEAK_LEN = 256, 192


def attention_timing_row(cfg, launches, errs, mel_lens):
    """Row 1: the inference attention kernel at the batched decoder call
    (bf16, B=32, H=2, T=1000, D=128, key mask from the batched run's mel
    lengths) and at speak's decoder call (f32, B=1, T=256, 192 valid keys),
    beside the plain version and SDPA with the same additive mask; the
    kernel is held against the plain version on these inputs first. Bounds
    count the valid keys only (padded key tiles are skipped): 4 D
    operations per query row and valid key, bf16 over the bf16 peak, f32 as
    3xTF32 (3 x operations over the TF32 peak) with the f32 CUDA-core bound
    beside it; bytes Q and O whole, K and V at the valid keys, the mask."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tts_king_torch.ops.kernels import attention as attn

    tc = cfg.model.transformer
    H = tc.decoder_head
    D = tc.decoder_hidden // H
    out = {}
    for dname, dtype, B, T, lens in (
            ("bf16", torch.bfloat16, BENCH_B, BENCH_T, mel_lens),
            ("f32", torch.float32, 1, SPEAK_T, [SPEAK_LEN])):
        (q, k, v), _ = attention_inputs(B, H, T, D, dtype, seed=7)
        mask = torch.from_numpy(np.arange(T)[None] >=
                                np.asarray(lens)[:, None]).cuda()
        additive = torch.zeros((B, 1, 1, T), dtype=dtype, device="cuda")
        additive.masked_fill_(mask[:, None, None, :], -1e9)
        got = attn.attention(q, k, v, mask).float()
        ref = attn.attention_plain(q, k, v, mask).float()
        err = float((got - ref).abs().max())
        tol = TOL[("attention", dname)]
        if not (bool(torch.isfinite(got).all()) and err <= tol):
            fail(f"attention {dname} {[B, H, T, D]} timed inputs: max err "
                 f"{err} > {tol}")
        del got, ref
        ms = cuda_ms(lambda: attn.attention(q, k, v, mask), warmup=3,
                     reps=20)
        plain_ms = cuda_ms(lambda: attn.attention_plain(q, k, v, mask),
                           warmup=3, reps=20)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=additive), warmup=3, reps=20)
        n_keys = float(np.sum(lens))
        ops = 4.0 * H * D * T * n_keys
        nbytes = q.element_size() * (2.0 * B * H * T * D +
                                     2.0 * H * D * n_keys) + B * T
        t_bytes = nbytes / PEAK_BYTES
        t_ops = ops / PEAK_BF16_OPS if dname == "bf16" else \
            3 * ops / PEAK_TF32_OPS
        out[dname] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": err, "checks_max_abs_err": errs[dname],
            "shape": [B, H, T, D], "valid_keys": int(n_keys)}
        if dname == "f32":
            out[dname]["bound_f32_ffma_ms"] = max(
                ops / PEAK_F32_OPS, t_bytes) * 1e3
        del q, k, v
    row = {"name": "attention", "route": "cuda",
           "source": "tts_king_torch/csrc/attention.cu",
           "replaces": "tts_king_tpu/ops/pallas/attention.py:29",
           "launches": launches["attention"], "dtype": "bf16",
           **out["bf16"], "f32": out["f32"],
           "note": "ms, plain_ms, library_ms, bound_ms, max_abs_err: bf16 at "
                   "the batched shape; f32: speak's decoder call; "
                   "checks_max_abs_err: the largest at ATTN_CHECKS"}
    return row


def mrf_timing_row(cfg, launches, mrf_runs, check_errs):
    """Row 2: the MRF kernel's bf16 route at the bench shape's fused stages
    (B = 32, T_mel = 1000), and row 2f: its f32 route at speak's 192-frame
    sentence (B = 1, T_mel = 192), each the sum of one call per stage on
    the stage packed once, as the Generator runs it (in f32 a call launches
    a pass per dilation pair and the branch mean). The kernel is held
    against mrf_stage_plain on these very inputs first, at TOL. Beside it:
    the plain version (cuDNN's default algorithms) and cudnn_chain_ms, the
    same 18 convs and elementwise ops with cudnn.benchmark on (cuDNN's
    fastest algorithm for each conv; TF32 off): a yardstick, not library_ms,
    since it is not one call. Bounds: 2 * 6 * sum(k) * C^2 operations per
    time step, bf16 over the bf16 peak; f32 as 3xTF32 (3 x operations over
    the TF32 peak) with the f32 CUDA-core bound beside it; bytes: x and y
    once, the packed taps and biases once."""
    import torch

    from tts_king_torch.ops.kernels import mrf

    out = {}
    for dname, dtype, B, t_mel in (
            ("bf16", torch.bfloat16, BENCH_B, BENCH_T),
            ("f32", torch.float32, 1, SPEAK_LEN)):
        stages = fused_stages(cfg, t_mel)
        stage_ms, plain_ms, chain_ms, grid = [], 0.0, 0.0, []
        ops = nbytes = err = 0.0
        for C, Tw in stages:
            x, stage = mrf_inputs(B, C, Tw, dtype, seed=C)
            packed = mrf.pack_stage(stage)
            got = mrf.mrf_stage(x, packed).float()
            ref = mrf.mrf_stage_plain(x, stage).float()
            scale = max(1.0, float(ref.abs().max()))
            e = float((got - ref).abs().max())
            tol = TOL[("mrf_stage", dname)] * scale
            if not (bool(torch.isfinite(got).all()) and e <= tol):
                fail(f"mrf_stage {dname} {[B, Tw, C]} timed inputs: max err "
                     f"{e} > {tol}")
            err = max(err, e)
            del got, ref
            stage_ms.append(cuda_ms(lambda: mrf.mrf_stage(x, packed),
                                    warmup=1, reps=3))
            plain_ms += cuda_ms(lambda: mrf.mrf_stage_plain(x, stage),
                                warmup=1, reps=2)
            torch.backends.cudnn.benchmark = True
            chain_ms += cuda_ms(lambda: mrf.mrf_stage_plain(x, stage),
                                warmup=2, reps=2)
            torch.backends.cudnn.benchmark = False
            plan = mrf.tile_plan(Tw, C, dtype, stage.kernel_sizes,
                                 stage.dilations)
            grid.append({"C": C, "T": Tw, "tt": plan.tt,
                         "blocks": plan.blocks(B, Tw), "slots": plan.slots,
                         "work_factor": plan.work_factor})
            if dname == "f32":
                grid[-1]["launches_per_call"] = plan.n_launches
            ops += 2.0 * 6 * sum(stage.kernel_sizes) * C * C * Tw * B
            nbytes += (2 * B * Tw * C * x.element_size()
                       + (packed.taps.numel() + packed.biases.numel())
                       * packed.taps.element_size())
            del x, stage, packed
            torch.cuda.empty_cache()
        t_bytes = nbytes / PEAK_BYTES
        t_ops = (ops / PEAK_BF16_OPS if dname == "bf16"
                 else 3 * ops / PEAK_TF32_OPS)
        out[dname] = {
            "ms": sum(stage_ms), "stage_ms": stage_ms, "plain_ms": plain_ms,
            "cudnn_chain_ms": chain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": err, "checks_max_abs_err": check_errs[dname],
            "launches": mrf_runs[dname], "grid": grid,
            "shape": {"B": B, "T_mel": t_mel, "stages_C_T": stages}}
        if dname == "f32":
            out[dname]["bound_f32_ffma_ms"] = max(ops / PEAK_F32_OPS,
                                                  t_bytes) * 1e3
    return {"name": "mrf_stage", "route": "cuda",
            "source": "tts_king_torch/csrc/mrf_stage.cu",
            "replaces": "tts_king_tpu/ops/pallas/mrf_packed.py:172",
            "dtype": "bf16", **out["bf16"],
            "launches": launches["mrf_stage"],
            "launches_bf16": out["bf16"]["launches"],
            "library_ms": None, "f32": out["f32"],
            "note": "ms, plain_ms, cudnn_chain_ms, bound_ms, max_abs_err: "
                    "bf16 at the bench shape, the sum of one launch per "
                    "fused stage; launches: the main path's (speak f32 + "
                    "batched bf16); f32: row 2f at speak's 192-frame "
                    "sentence; checks_max_abs_err: the largest at "
                    "MRF_CHECKS"}


def phase_timing(cfg, launches, train_launches, errs, mel_lens, mrf_runs):
    rows = [attention_timing_row(cfg, launches, errs["attention"], mel_lens),
            mrf_timing_row(cfg, launches, mrf_runs, errs["mrf_stage"]),
            flash_timing_row(cfg, train_launches, errs["flash_attention"])]
    return rows


def flash_timing_row(cfg, launches, max_err):
    """The flash kernels at the decoder's call of the bench training step
    (B=16, H=2, T=640, D=128, key mask from the bench superbatch's mel
    lengths): forward, backward (dQ then dK/dV), the plain version forward
    + autograd backward, and SDPA forward + backward with the same boolean
    key mask; the kernels are held against the plain version on these
    inputs first. The bound counts the valid keys only, the work this mask
    needs: 4 D operations per (row, valid key) forward and 10 backward (S
    and dP recomputed, dV, dQ, dK), as 3xTF32 (3 x operations over the TF32
    peak), with the f32 CUDA-core bound beside it; bytes: each input read
    and each output written once, K and V read at the valid keys only."""
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
    got = (o,) + fa._backward_cuda(qd, kd, vd, m8, o, lse, g)
    ref = fa.flash_attention_plain(q, k, v, mask)
    ref = (ref,) + torch.autograd.grad(ref, (q, k, v), g)
    errs = {name: float((a - b).detach().abs().max())
            for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref)}
    pad = mask[:, None, :, None].expand_as(got[2])
    tol = TOL[("flash_attention", "f32")]
    if not (max(errs.values()) <= tol and all(
            bool(torch.isfinite(t).all()) for t in got)
            and not bool(got[2][pad].any()) and not bool(got[3][pad].any())):
        fail(f"flash_attention {[B, H, T, D]} timed inputs: errors {errs}")
    del got, ref
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
    elems, kv = B * H * T * D, 2.0 * H * D * n_keys
    # forward: q read, o written, k and v read at the valid keys, lse
    # written, the mask; backward: q, o and dO read, dq, dk and dv written,
    # k and v read at the valid keys, lse read, the mask
    bytes_f = 4.0 * (2 * elems + kv + B * H * T) + B * T
    bytes_b = 4.0 * (6 * elems + kv + B * H * T) + B * T
    t_ops = 3 * (ops_f + ops_b) / PEAK_TF32_OPS
    t_bytes = (bytes_f + bytes_b) / PEAK_BYTES

    def bound(ops, nbytes, peak):
        return max(ops / peak, nbytes / PEAK_BYTES) * 1e3

    return {
        "name": "flash_attention", "route": "cuda",
        "source": "tts_king_torch/csrc/flash_attention.cu",
        "replaces": "tts_king_tpu/ops/pallas/attention.py:102",
        "launches": launches["flash_fwd"], "launches_fwd":
        launches["flash_fwd"], "launches_bwd": launches["flash_bwd"],
        "max_abs_err": max(errs.values()), "checks_max_abs_err": max_err,
        "ms": fwd_ms + bwd_ms,
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "fwd_bound_ms": bound(3 * ops_f, bytes_f, PEAK_TF32_OPS),
        "bwd_bound_ms": bound(3 * ops_b, bytes_b, PEAK_TF32_OPS),
        "bound_f32_ffma_ms": bound(ops_f + ops_b, bytes_f + bytes_b,
                                   PEAK_F32_OPS),
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
    errs["mrf_stage_int8"] = phase_int8_vs_plain()
    errs["flash_attention"] = phase_flash_vs_plain()
    phase_goldens()
    phase_int8_golden()
    phase_vocoders()
    t0 = time.perf_counter()
    losses, golden_errs = replay_train_step_golden(device="cuda")
    emit({"phase": "golden", "fixture": "golden_train_step",
          "loss_total": losses["total"], "max_err": golden_errs,
          "tol": "tests/test_torch_train.py (compare_train_step)",
          "seconds": time.perf_counter() - t0, "ok": True})
    launches, mel_lens, mrf_runs, kings = phase_main_path()
    serving_launches = phase_serving(kings, smi)
    del kings
    torch.cuda.empty_cache()
    int8_launches = phase_int8_vocoder(main_config())
    train_launches = phase_train_path()
    cwt_launches = phase_cwt_path(smi)
    torch.cuda.empty_cache()
    gan_launches = phase_gan_path(smi)
    torch.cuda.empty_cache()
    phase_train_step_time(smi)
    rows = phase_timing(main_config(), launches, train_launches, errs,
                        mel_lens, mrf_runs)
    for row in rows[:2]:   # attention (rows 1, 1f), mrf_stage (2, 2f)
        row["launches_serving"] = {dname: serving_launches[dname][row["name"]]
                                   for dname in ("bf16", "f32")}
        # the CWT model's 3 speak calls (f32) and its training run
        # (validation's attention)
        row["launches_cwt"] = {p: cwt_launches[p][row["name"]]
                               for p in ("speak", "train")}
    rows[-1]["launches_cwt"] = {k: cwt_launches["train"][k]
                                for k in ("flash_fwd", "flash_bwd")}
    # the GAN path's export check: one fused Generator call per dtype
    rows[1]["launches_gan"] = gan_launches["bf16"]
    rows[1]["f32"]["launches_gan"] = gan_launches["f32"]
    rows.insert(2, int8_timing_row(main_config(), int8_launches,
                                   errs["mrf_stage_int8"]["bf16"]))
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
