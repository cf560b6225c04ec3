#!/usr/bin/env python3
"""The PyTorch port's main paths on one CUDA card, checked end to end:
synthesis (TTSKing.speak, speak_streaming, batched generate + vocode), the
int8 vocoder (Generator(mrf_backend="fused_int8")), the other vocoder paths
(MelGAN, upstream .pth.tar checkpoints), FastSpeech2 training (train()
from a preprocessed corpus, with resume), the data-preparation path and the
CWT model, HiFi-GAN GAN training (VocoderTrainer, train_vocoder), and data,
tensor and sequence parallelism (tts_king_torch/parallel).

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
               autograd; the attention and flash kernels' bf16-probability
               mode (ModelConfig.attention_probs_bf16) at the same checks
               and PROBS_EXTRA_CHECKS (the largest T, D = 64), within
               PROBS_TOL's max and mean, its control outside;
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
               sentences (f32), one batched FastSpeech2 + vocode at the
               bench shape B=32, L=128, T_mel=1000 in bench.py's form (the
               model computed in bf16), and speak_streaming on one sentence
               (f32); serving through an f32 and a bf16 SynthesisServer
               (the bf16 AcousticModel computes FastSpeech2 in f32 on
               bf16-rounded variables, as the JAX one does); (b) the int8
               Generator at config 2b of bench.py (B=8, T_mel=1000, bf16)
               beside the fused bf16 Generator; (c) training: train() for 4 optimizer steps of
               16 x 4 on a synthetic preprocessed corpus written to a
               temporary directory (L = 96, T = 640), with validation,
               objective metrics and a checkpoint, then a resume for one
               more step; (d) attention_probs_bf16 (phase_probs_bf16_path):
               TTSKing.speak, the f32 batched generate at the bench shape
               and train() for 4 steps with validation, every attention
               and flash launch in the kernels' mode, a batch of 4 against
               the CPU. Every kernel launch count is zeroed just before
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
               B = 1; then fine-tuning on the acoustic model's mels on the
               same corpus (phase_finetune_path): train() of the non-CWT
               FastSpeech2 with synthesis previews through an f32
               Vocoder, make_base_mels, train_vocoder(fine_tuning=True),
               the export into the fused Generator (f32 and bf16), and
               the synthesize and evaluate --objective CLIs;
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
  9. parallel path — two gloo ranks sharing the card (spawned, joined with
               a timeout): the collectives on CUDA tensors, a dp=2 and a
               tp=2 FastSpeech2 step, Vocoder.generate_long of a 4000-frame
               utterance 2 ways (f32, bf16), train() and train_vocoder on 2
               ranks; NCCL at world size 1 (train() through the
               distributed route); AcousticModel and a SynthesisServer over
               2 replicas on the card; the tp=2 step with
               attention_probs_bf16; a CWT model over the 2 ranks and a
               single-process mesh, pad row included; each held to one
               process (phase_parallel_path says how);
 11. validation tools — tools/validate_training.py and
               validate_vocoder_training.py at VALIDATION_STEPS steps:
               finite, the mel loss falling;
 12. kernels — kernel time, plain time, library time and the card's bound at
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
               the GAN export's launches (launches_gan), and rows 1f, 2f, 2
               and 3 those of the fine-tuning path (launches_finetune),
               every row those of the parallel path (launches_parallel);
               rows 1p and 3p the kernels' bf16-probability mode at the
               batched and speak shapes and the train step's (library:
               none; SDPA's f32 time beside); row 4, BigVGAN-v2's fused
               anti-aliased SnakeBeta (amp_act_timing_row) on (B, T, C)
               signals, checked against its plain version with each
               prologue (none, a conv's bias, the bias and a residual) and
               timed with each at its six stages' shapes (B = 32, T_mel =
               1000) beside the unfused PyTorch chain, and its counters
               (launches, bias_in, residual_in) held against the trace of
               one bf16 Vocoder.generate(mel, lengths) at B 32 and T_mel
               1000; row 4m, the stage mean over the AMP blocks
               (amp_mean_timing_row) at the six stages in bf16 and f32,
               bit for bit, timed in bf16 beside its bound and the PyTorch
               route it replaces;
               then BigVGAN-v2's folded AMP convs (phase_amp_conv): each
               conv that dilated_conv.folds folds, at its stage's (32, C,
               T), held against cuDNN's dilated conv in bf16 and f32, and
               the AMP conv counters of one traced bf16
               Vocoder.generate(mel, lengths) against its spans.

The last line is {"ok": true, "device": {...}}. Without CUDA, or outside a
checkout, it prints no result and exits 1. The JAX package is not imported.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# The kernels' bf16-probability mode (ModelConfig.attention_probs_bf16),
# attention and flash forward and backward, against its plain version: the
# kernel's exp (ex2.approx) and sums differ from torch's by ulps, so a
# probability (or dP) next to a bf16 rounding boundary may round the other
# way, which moves an output by up to 2^-8 of p |v|. So the max and the mean
# of |kernel - plain| are held. Readings on an NVIDIA H100 80GB HBM3 (700 W)
# at ATTN_CHECKS and FLASH_CHECKS: max 1.34e-3, mean 7.9e-7 at most; the
# control, the unrounded function against the mode's plain version, reads a
# mean of 6.9e-5 at least, and must miss the mean bound in every check.
PROBS_TOL = {"max": 4e-3, "mean": 5e-6}

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
# BENCH_B sentences' mel frames at 5 frames a phoneme, 42-192 phonemes
# (median 100): row 2 runs the bf16 MRF stages with the rows these leave.
BULK_FRAMES = [210, 245, 270, 295, 315, 325, 340, 370, 380, 400, 415, 430,
               445, 460, 470, 485, 500, 520, 530, 545, 565, 595, 615, 635,
               660, 685, 715, 750, 785, 850, 960, 960]
# H = 1 is the shipped 2 heads split over tp = 2 (the parallel path).
ATTN_CHECKS = [(8, 2, 128, 128, "suffix"), (8, 2, 1000, 128, "suffix"),
               (3, 2, 77, 16, "suffix"), (5, 2, 200, 128, "edge"),
               (5, 2, 77, 16, "edge"), (5, 2, 100, 64, "edge"),
               (5, 1, 50, 32, "edge"), (8, 1, 1000, 128, "suffix"),
               (5, 1, 200, 128, "edge")]
MRF_CHECKS = [(2, 128, 64000), (2, 64, 128000), (2, 32, 256000),
              (3, 16, 4001)]
# Training: the superbatch of bench.py:286-301, and the flash kernels'
# shapes on that path (decoder T = 640, encoder L = 96) plus a ragged one.
TRAIN_ACC, TRAIN_B, TRAIN_L, TRAIN_T = 4, 16, 96, 640
FLASH_CHECKS = [(16, 2, 640, 128, "suffix"), (16, 2, 96, 128, "suffix"),
                (3, 2, 77, 16, "suffix"), (5, 2, 200, 128, "edge"),
                (5, 2, 77, 16, "edge"), (5, 2, 50, 4, "edge"),
                (8, 1, 640, 128, "suffix"), (8, 1, 96, 128, "suffix"),
                (5, 1, 200, 128, "edge")]
TRAIN_STEPS = 4
# The bf16-probability mode's kernels also at the largest T the port's
# attention reaches (max_seq_len and the top mel bucket, 1000) with the
# validation tools' half-width heads (D = 64), and the flash kernels at
# that T with the shipped D = 128.
PROBS_EXTRA_CHECKS = {"attention": [(5, 2, 1000, 64, "edge")],
                      "flash": [(4, 2, 1000, 128, "suffix"),
                                (5, 2, 1000, 64, "edge")]}

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
            convert_hifigan_checkpoint(pth, cfg.vocoder)))
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
    edge = king.vocoder.halo_frames * hop
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


def compare_train_step(got, want, lr, stats_atol=1e-6, loss_rtol=1e-5):
    """A port step (numpy, state-dict names) against a JAX step (flax trees:
    losses, params, batch_stats, count, mu, nu); raises on a mismatch and
    returns the largest errors.

    Tolerances, f32 on both sides with sums in other orders: losses rtol
    ``loss_rtol`` (1e-5; a parallel step's, 1e-4 as the JAX package holds its
    sharded step, tests/test_train.py:163-189); the Adam moments and the
    clipped grads mu / (1 - b1) rtol 1e-4 with an atol of 1e-5 of the largest
    magnitude over all parameters (entries near 0 carry the rounding of the
    large ones); running stats rtol 1e-5, atol ``stats_atol``; new params atol
    1e-3 * lr. Adam moves each weight by lr * m_hat / (sqrt(v_hat) + eps),
    which a gradient error d moves by up to lr * d / eps: the optimizers of
    these checks use eps = 1e-3, so that the gradients' rounding (d < 1e-8
    here; the weights whose gradient is 0 in exact arithmetic, the key
    projection's bias and the conv biases in front of BatchNorm, get such
    rounding noise as their whole gradient) moves a weight by ~1e-4 * lr at
    most (5e-5 * lr measured on the CPU), while a wrong learning rate, bias
    correction or decay moves it by a visible share of lr."""
    import numpy as np

    from tts_king_torch.weights import flax_adam_to_torch, flax_to_torch

    errs = {"loss_rel": 0.0, "param_abs": 0.0, "stats_abs": 0.0,
            "grad_rel_top": 0.0}
    for name, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][name], v, rtol=loss_rtol,
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


_SEEDED = {}   # seeded_flax_variables' draws, by seed and shapes


def seeded_flax_variables(build, seed):
    """Seeded numpy weights in the flax layout, for a module built by
    ``build`` (on the meta device: shapes only). The draw depends on the
    seed and the state dict's names and shapes alone, so each is drawn once
    and handed out as copies (callers adjust them in place)."""
    import copy

    import torch

    from tts_king_torch.weights import seeded_state_dict, torch_to_flax

    with torch.device("meta"):
        module = build()
    key = (seed, tuple((k, tuple(v.shape))
                       for k, v in module.state_dict().items()))
    if key not in _SEEDED:
        _SEEDED[key] = torch_to_flax(seeded_state_dict(module, seed))
    return copy.deepcopy(_SEEDED[key])


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


MAIN_STATS = {"pitch": [-3.0, 9.5], "energy": [-1.5, 6.1]}


def main_path_variables(cfg, n_spk=66):
    """Seeded flax-layout weights of ``cfg``'s FastSpeech2 (n_spk
    speakers, MAIN_STATS) and HiFi-GAN Generator."""
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.models.hifigan import Generator

    fs2_vars = seeded_flax_variables(
        lambda: build_fastspeech2(cfg.model, MAIN_STATS, n_spk), seed=0)
    # Random weights predict log-durations near 0, i.e. next to no frames; a
    # head of bias log(1 + 5) and a tenth of its random weight gives each
    # phoneme about five frames, as a trained model does, so the decoder and
    # the vocoder run at speech-like lengths.
    head = fs2_vars["params"]["variance_adaptor"]["duration_predictor"]
    head["linear_layer"]["kernel"] *= 0.1
    head["linear_layer"]["bias"][:] = math.log(6.0)
    voc_vars = seeded_flax_variables(lambda: Generator(cfg.vocoder), seed=1)
    return fs2_vars, voc_vars


def main_path_kings(cfg, n_spk=66):
    """TTSKing in f32 and in bf16 at ``cfg``'s width, with seeded weights
    brought in through weights.flax_to_torch. The bf16 king computes
    FastSpeech2 in f32 on bf16-rounded variables (as the JAX AcousticModel
    does) and the vocoder in bf16."""
    import torch

    from tts_king_torch.pipeline import TTSKing

    fs2_vars, voc_vars = main_path_variables(cfg, n_spk)
    return {dname: TTSKing(cfg, dtype=dtype, device="cuda",
                           acoustic_variables=fs2_vars,
                           vocoder_variables=voc_vars, n_speakers=n_spk)
            for dname, dtype in (("f32", torch.float32),
                                 ("bf16", torch.bfloat16))}


def bench_fs2(cfg, n_spk=66):
    """FastSpeech2 built and run in bf16 on the card, the form of the JAX
    bench (bench.py:119-124, build_fastspeech2(dtype=bf16)), with
    main_path_kings' seeded weights."""
    import torch

    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.weights import flax_to_torch, load_into

    with torch.device("meta"):
        model = build_fastspeech2(cfg.model, MAIN_STATS, n_spk)
    model = load_into(model.to_empty(device="cuda"), flax_to_torch(
        main_path_variables(cfg, n_spk)[0]))
    return model.to(torch.bfloat16).eval()


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

    return {"attention": attention.launches,
            "attention_bf16": attention.launches_bf16,
            "attention_probs_bf16": attention.launches_probs_bf16,
            "mrf_stage": mrf.launches, "mrf_stage_int8": mrf_int8.launches,
            "flash_fwd": flash_attention.launches_fwd,
            "flash_bwd": flash_attention.launches_bwd,
            "flash_fwd_probs_bf16": flash_attention.launches_fwd_probs_bf16,
            "flash_bwd_probs_bf16": flash_attention.launches_bwd_probs_bf16}


def zero_launch_counts():
    from tts_king_torch.ops.kernels import (attention, flash_attention, mrf,
                                            mrf_int8)

    attention.launches = attention.launches_bf16 = 0
    attention.launches_probs_bf16 = 0
    mrf.launches = mrf_int8.launches = 0
    flash_attention.launches_fwd = flash_attention.launches_bwd = 0
    flash_attention.launches_fwd_probs_bf16 = 0
    flash_attention.launches_bwd_probs_bf16 = 0


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
    fs2_bf16, voc = bench_fs2(cfg, n_spk), kings["bf16"].vocoder
    phonemes, speakers = bench_batch(n_spk)
    bench_in = (torch.tensor(speakers, device="cuda"),
                torch.from_numpy(phonemes).cuda(),
                torch.full((B,), L, dtype=torch.int32, device="cuda"))

    def bench_generate():   # bench.py:139-147
        with torch.inference_mode():
            return fs2_bf16(*bench_in, max_mel_len=T)

    # one untimed call of each run: cuDNN's plans and the allocator's pools
    for king in kings.values():
        king.speak(SENTENCES[0])
    voc(bench_generate()["postnet_mel"])
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
    out = bench_generate()
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
        d_bf16 = after["attention_bf16"] - before["attention_bf16"]
        d_mrf = after["mrf_stage"] - before["mrf_stage"]
        if d_att < n_layers or d_bf16 or d_mrf != n_fused:
            fail(f"speak: attention launches {d_att} (>= {n_layers}; "
                 f"{d_bf16} bf16, == 0), mrf {d_mrf} (== {n_fused})")
        mrf_runs["f32"] += d_mrf
        emit({"phase": "main_path", "call": "TTSKing.speak", "dtype": "f32",
              "text": text, "mel_len": n, "samples": int(w.shape[0]),
              "wall_ms": ms, "rtf": ms / 1e3 / (w.shape[0] / sr),
              "launches": {"attention": d_att, "attention_bf16": d_bf16,
                           "mrf_stage": d_mrf}, "ok": True})

    mel_lens = out["mel_lens"].cpu().numpy()
    if (tuple(out["postnet_mel"].shape) != (B, T, 80)
            or out["postnet_mel"].dtype != torch.bfloat16):
        fail(f"batched mel {out['postnet_mel'].dtype} "
             f"{tuple(out['postnet_mel'].shape)}: bf16 (B, T, 80)")
    if not bool(torch.isfinite(wav_f).all()):
        fail("batched: non-finite waveform")
    if wav_i16.dtype != torch.int16 or tuple(wav_i16.shape) != (B, T * hop):
        fail(f"batched: {wav_i16.dtype} {tuple(wav_i16.shape)}")
    trimmed = [w[:n] for w, n in zip(wav_i16.cpu().numpy(), mel_lens * hop)]
    if any(len(w) != n * hop for w, n in zip(trimmed, mel_lens)):
        fail("batched: trimmed lengths are not mel_len * hop")
    d_att = after_b["attention"] - before_b["attention"]
    d_bf16 = after_b["attention_bf16"] - before_b["attention_bf16"]
    d_mrf = after_b["mrf_stage"] - before_b["mrf_stage"]
    if d_att != n_layers or d_bf16 != n_layers or d_mrf != n_fused:
        fail(f"batched: attention launches {d_att} ({d_bf16} bf16; both == "
             f"{n_layers}), mrf {d_mrf} (== {n_fused})")
    mrf_runs["bf16"] = d_mrf
    emit({"phase": "main_path", "call": "FastSpeech2+vocode",
          "form": "bench.py's bf16 FastSpeech2", "dtype": "bf16",
          "shape": {"B": B, "L": L, "T_mel": T}, "wall_ms": batch_ms,
          "rtf": batch_ms / 1e3 / (B * T * hop / sr),
          "mel_lens_min_max": [int(mel_lens.min()), int(mel_lens.max())],
          "launches": {"attention": d_att, "attention_bf16": d_bf16,
                       "mrf_stage": d_mrf}, "ok": True})
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


def check_served_alone(king, requests, wavs, what, exact_samples=True):
    """Each served wav against the same request run alone (alone_wavs, the
    run of its padding whose length agrees). Lengths, f32 and bf16 servers
    alike (both compute FastSpeech2 in f32, the bf16 one on bf16-rounded
    variables, as the JAX AcousticModel does): equal but for at most 1
    request in 16 one frame off. Samples (exact_samples, the f32 server):
    where the lengths are equal, samples before the last
    halo_frames (the vocoder's) more than 2 LSB apart at under 1% of
    them; the bf16 server's vocoder computes in bf16, and other kernels at
    another batch shape round otherwise (one bf16 rounding apart is up to
    128 LSB), so its samples are only reported."""
    import numpy as np
    import torch

    hop = king.cfg.preprocess.stft.hop_length
    edge = king.vocoder.halo_frames * hop
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
            if abs(diff) > 1:
                fail(f"{what}: request {i}: {len(got) // hop} frames "
                     f"served, {[len(w) // hop for w in alone]} alone")
            off_frames[i] = diff
            continue
        frac, j = min(fracs)
        n_wider += j
        worst = max(worst, frac)
        if exact_samples and frac >= 0.01:
            fail(f"{what}: request {i}: {frac:.2%} of samples > 2 LSB off "
                 "the request run alone")
    if len(off_frames) * 16 > len(requests):
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
    just before each server's timed burst and read just after it: both
    servers' FastSpeech2 computes in f32 (row 1f); the f32 server's
    vocoder gives row 2f, the bf16 one's row 2."""
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
            # both servers' FastSpeech2 computes in f32 (the JAX
            # AcousticModel's semantics): no bf16 attention launch
            if counts["attention_bf16"]:
                fail(f"serving {dname}: {counts['attention_bf16']} attention "
                     "launches on bf16 inputs; FastSpeech2 computes in f32")
            launches[dname]["attention_bf16"] = counts["attention_bf16"]
            res = {"prewarm_s": prewarm_s, "prewarmed": warmed,
                   "first_burst_wall_s": first_wall,
                   **serve_summary(server, requests, wavs, lat, wall, sr,
                                   n_before),
                   "launches": launches[dname]}
            if (res["stats"]["failed"]
                    or res["stats"]["completed"] != 2 * n_req):
                fail(f"serving {dname}: stats {res['stats']}")
            for name in ("attention", "mrf_stage"):
                if launches[dname][name] == 0:
                    fail(f"serving {dname}: kernel {name} was not launched")
            res["vs_alone"] = check_served_alone(
                king, requests, wavs, f"serving {dname}",
                exact_samples=dname == "f32")
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


def phase_cwt_path(smi, tmp):
    """The data-preparation path and the CWT FastSpeech2 on the card: a
    raw corpus (CWT_CORPUS) through the Preprocessor, train() of a
    use_cwt=True model at the shipped width on the card's features, and
    speak through it (phase_cwt_features, phase_cwt_training,
    phase_cwt_speak), under ``tmp``. Every launch count is zeroed just
    before each path and read just after. Returns the training and speak
    launch counts, and the raw corpus and its card features (kept under
    ``tmp`` for phase_finetune_path)."""
    from tts_king_torch.config import StepConfig

    cfg = main_config()
    cfg.model.use_cwt = True
    cfg.preprocess.raw_path = os.path.join(tmp, "raw")
    cfg.train.ckpt_path = os.path.join(tmp, "ckpt")
    cfg.train.result_path = os.path.join(tmp, "result")
    cfg.train.step = StepConfig(total_step=TRAIN_STEPS, log_step=1,
                                synth_step=10 ** 6, val_step=TRAIN_STEPS,
                                save_step=TRAIN_STEPS)
    features = phase_cwt_features(cfg, tmp, smi)
    train_launches, state = phase_cwt_training(cfg, smi)
    speak_launches = phase_cwt_speak(cfg, state, tmp, smi)
    return ({"train": train_launches, "speak": speak_launches},
            cfg.preprocess.raw_path, features)


# ------------------------------------------------ fine-tuning on FS2 mels

FT_SYNTH_STEP = 2      # train()'s previews at steps 2 and 4
FT_MEL_BATCH = 16      # make_base_mels' batch
FT_OBJECTIVE_UTTS = 4  # evaluate --objective's utterances


class PreviewRecorder:
    """A Vocoder whose generate() calls (the previews) are recorded."""

    def __init__(self, vocoder):
        self.vocoder, self.calls = vocoder, []

    def generate(self, mel, lengths=None):
        wavs = self.vocoder.generate(mel, lengths)
        self.calls.append((mel, list(lengths), wavs))
        return wavs


def quietly(fn, *args, **kw):
    """fn(*args, **kw) in this process with its stdout captured (this
    script's stdout carries its JSON lines); returns (result, stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kw)
    return result, buf.getvalue()


def finetune_train(cfg, voc_vars):
    """Stage 1: train() of the shipped FastSpeech2 (no CWT) for
    TRAIN_STEPS steps, previews every FT_SYNTH_STEP through an f32 Vocoder:
    each preview's wav is Vocoder.generate of its mel. Returns (state,
    record)."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from tts_king_torch.pipeline import Vocoder
    from tts_king_torch.train.loop import train
    from tts_king_torch.utils.plotting import matplotlib_available

    rec = PreviewRecorder(Vocoder(cfg, voc_vars, device="cuda"))
    tc = cfg.model.transformer
    per_step = ((tc.encoder_layer + tc.decoder_layer)
                * cfg.train.optimizer.grad_acc_step)
    zero_launch_counts()
    t0 = time.perf_counter()
    state = train(cfg, max_steps=TRAIN_STEPS, vocoder=rec, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()   # read just after the path's run
    if state.step != TRAIN_STEPS:
        fail(f"finetune train: ended at step {state.step}")
    if (launches["flash_fwd"] != per_step * TRAIN_STEPS
            or launches["flash_bwd"] != per_step * TRAIN_STEPS):
        fail(f"finetune train: flash launches {launches}")
    steps = list(range(FT_SYNTH_STEP, TRAIN_STEPS + 1, FT_SYNTH_STEP))
    result = cfg.train.result_path
    previews, calls = [], iter(rec.calls)
    hop = cfg.preprocess.stft.hop_length
    plots = matplotlib_available()
    for step in steps:
        _, wav = wavfile.read(os.path.join(result, f"step_{step}.wav"))
        png = os.path.exists(os.path.join(result, f"step_{step}.png"))
        if png != plots:
            fail(f"finetune preview {step}: png {png}, matplotlib {plots}")
        frames = len(wav) // hop
        if frames:
            mel, lengths, wavs = next(calls)
            again = rec.vocoder.generate(mel, lengths=lengths)[0]
            if not (np.array_equal(wav, wavs[0])
                    and np.array_equal(wav, again)
                    and lengths == [mel.shape[1] * hop] == [len(wav)]):
                fail(f"finetune preview {step}: the wav is not "
                     "Vocoder.generate of its mel")
        previews.append({"step": step, "frames": frames, "png": png})
    if not plots:
        print("chip_smoke: matplotlib is not installed; the previews' "
              "PNGs were skipped", file=sys.stderr, flush=True)
    n_fused = len(fused_stages(cfg, BENCH_T))
    if not rec.calls or launches["mrf_stage"] != n_fused * len(rec.calls):
        fail(f"finetune train: {len(rec.calls)} vocoded previews, mrf "
             f"launches {launches['mrf_stage']}")
    return state, {"wall_s": wall, "previews": previews, "pngs": plots,
                   "launches": launches}


def finetune_base_mels(cfg):
    """Stage 2: make_base_mels at batch FT_MEL_BATCH over every utterance:
    one mel and one wav each, the mel the ground-truth mel's frames, the
    wav T * hop samples."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from tts_king_torch.tools.make_base_mels import make_base_mels

    zero_launch_counts()
    t0 = time.perf_counter()
    out_dir, out = quietly(make_base_mels, cfg, batch_size=FT_MEL_BATCH,
                           device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    root = cfg.preprocess.preprocessed_path
    per_split = []
    for name in ("train.txt", "val.txt"):
        with open(os.path.join(root, name), encoding="utf-8") as f:
            per_split.append(sum(1 for _ in f))
    n_utts = sum(per_split)
    mels = sorted(os.listdir(os.path.join(out_dir, "mels")))
    wavs = sorted(os.listdir(os.path.join(out_dir, "wavs")))
    if len(mels) != n_utts or [m[:-4] for m in mels] != [w[:-4]
                                                         for w in wavs]:
        fail(f"make_base_mels: {len(mels)} mels, {len(wavs)} wavs, "
             f"{n_utts} utterances")
    hop = cfg.preprocess.stft.hop_length
    for m in mels:
        mel = np.load(os.path.join(out_dir, "mels", m))
        _, wav = wavfile.read(os.path.join(out_dir, "wavs", m[:-4] + ".wav"))
        spk, utt = m[:-4].split("-", 1)
        gt = np.load(os.path.join(root, "mel", f"{spk}-mel-{utt}.npy"),
                     mmap_mode="r")
        if (mel.shape != (min(gt.shape[0], cfg.model.max_seq_len), 80)
                or not np.isfinite(mel).all() or wav.dtype != np.int16
                or len(wav) != mel.shape[0] * hop):
            fail(f"make_base_mels {m}: mel {mel.shape}, ground truth "
                 f"{gt.shape}, wav {wav.dtype} {wav.shape}")
    n_batches = sum(-(-n // FT_MEL_BATCH) for n in per_split)
    tc = cfg.model.transformer
    if launches["attention"] != n_batches * (tc.encoder_layer
                                             + tc.decoder_layer):
        fail(f"make_base_mels: attention launches {launches['attention']} "
             f"for {n_batches} batches")
    return out_dir, {"wall_s": wall, "utterances": len(mels),
                     "batches": n_batches, "launches": launches,
                     "log": out.strip().splitlines()[-1]}


def finetune_vocoder(cfg, out_dir):
    """Stage 3: train_vocoder(fine_tuning=True) on the (ground-truth wav,
    FastSpeech2 mel) pairs, TRAIN_STEPS steps at batch GAN_LOOP_BATCH, the
    published discriminator widths (phase_gan_train_vocoder's settings)."""
    import numpy as np
    import torch

    from tts_king_torch.train.vocoder_loop import train_vocoder

    wavs = sorted(os.path.join(out_dir, "wavs", n)
                  for n in os.listdir(os.path.join(out_dir, "wavs")))
    cfg.vocoder.batch_size = GAN_LOOP_BATCH
    zero_launch_counts()
    t0 = time.perf_counter()
    state = train_vocoder(cfg, wavs[2:], val_paths=wavs[:2],
                          max_steps=TRAIN_STEPS, log_every=1,
                          save_every=TRAIN_STEPS, fine_tuning=True,
                          base_mels_path=os.path.join(out_dir, "mels"),
                          device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    with open(os.path.join(cfg.train.result_path,
                           f"{cfg.exp_name}_vocoder.metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    mel_l1 = [r["mel_l1"] for r in recs if r["phase"] == "vocoder"]
    if (state.step != TRAIN_STEPS or len(mel_l1) != TRAIN_STEPS
            or not np.all(np.isfinite(mel_l1))):
        fail(f"finetune train_vocoder: step {state.step}, mel L1 {mel_l1}")
    return state, {"wall_s": wall, "wavs": len(wavs), "mel_l1": mel_l1,
                   "val_mel_l1": [r["val_mel_l1"] for r in recs
                                  if r["phase"] == "vocoder_val"],
                   "launches": launches}


def finetune_clis(cfg, fs2_state, gan_state, tmp):
    """Stage 6: the trained FastSpeech2 and the fine-tuned vocoder through
    ``python -m tts_king_torch.tools.synthesize`` (held against
    TTSKing.speak at golden_e2e's bound) and ``evaluate --objective`` (F0
    through the vocoder and YIN on the card), in this process, from a config
    file written as JSON (which YAML reads): the FastSpeech2 as npz beside
    its stats.json and speakers.json and as a checkpoint, its duration head
    set to about five frames a phoneme as in phase_cwt_speak (4 steps leave
    it near its random init); the vocoder folded, as npz."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from scipy.io import wavfile

    from tts_king_torch.pipeline import TTSKing
    from tts_king_torch.tools import evaluate, synthesize
    from tts_king_torch.train.checkpoint import save_train_state
    from tts_king_torch.train.vocoder import export_inference_params

    model_dir = os.path.join(tmp, "ft_model")
    os.makedirs(model_dir)
    for name in ("stats.json", "speakers.json"):
        shutil.copy(os.path.join(cfg.preprocess.preprocessed_path, name),
                    model_dir)
    head = fs2_state.model.variance_adaptor.duration_predictor.linear_layer
    with torch.no_grad():
        head.weight.mul_(0.1)
        head.bias.fill_(math.log(6.0))
    cfg.train.ckpt_path = os.path.join(tmp, "ft_ckpt_cli")
    save_train_state(cfg.train.ckpt_path, fs2_state.step, fs2_state)
    cfg.acoustic.weights_path = os.path.join(model_dir, "fs2.npz")
    save_npz_weights(cfg.acoustic.weights_path,
                     {k: v.cpu() for k, v in
                      fs2_state.model.state_dict().items()})
    cfg.vocoder.weights_path = os.path.join(model_dir, "generator.npz")
    save_npz_weights(cfg.vocoder.weights_path,
                     {k: v.cpu() for k, v in
                      export_inference_params(gan_state.gen).items()})
    cfg.preprocess.lexicon_path = os.path.join(E2E_DIR, "lexicon.dict")
    path = os.path.join(tmp, "ft_config.yaml")
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)

    out = {}
    text, out_dir = SENTENCES[1], os.path.join(tmp, "ft_synth")
    zero_launch_counts()
    t0 = time.perf_counter()
    code, log = quietly(synthesize.main, ["--config", path, "--text", text,
                                          "--out", out_dir,
                                          "--device", "cuda"])
    torch.cuda.synchronize()
    launches = launch_counts()
    _, wav = wavfile.read(os.path.join(out_dir, "utt_0.wav"))
    want = TTSKing(path, device="cuda").speak(text)[0]
    frac = (float(np.mean(np.abs(wav.astype(np.int32) - want) > 2))
            if wav.shape == want.shape else 1.0)
    if code != 0 or not len(wav) or frac >= 1e-3:
        fail(f"synthesize: exit {code}, {wav.shape} vs speak {want.shape}, "
             f"{frac:.2%} of samples > 2 LSB off")
    out["synthesize"] = {"wall_s": time.perf_counter() - t0,
                         "samples": int(len(wav)), "frac_off_gt2": frac,
                         "launches": launches}

    zero_launch_counts()
    t0 = time.perf_counter()
    code, log = quietly(evaluate.main, [path, "--objective",
                                        "--objective-utts",
                                        str(FT_OBJECTIVE_UTTS),
                                        "--device", "cuda"])
    torch.cuda.synchronize()
    launches = launch_counts()
    report = json.loads(log.strip().splitlines()[-1])
    keys = ("total", "mel", "mcd_db", "duration_mae_frames", "f0_rmse_hz",
            "vuv_f1")
    if code != 0 or any(report.get(k) is None for k in keys) \
            or report["step"] != TRAIN_STEPS:
        fail(f"evaluate --objective: exit {code}, {report}")
    out["evaluate"] = {"wall_s": time.perf_counter() - t0,
                       "report": report, "launches": launches}
    return out


def phase_finetune_path(smi, raw, features, tmp):
    """Fine-tuning HiFi-GAN on the acoustic model's own mels, the recipe
    of scripts/make_base_mels.py then train_vocoder --fine-tuning, at the
    shipped width on the CWT phase's corpus (raw wavs and TextGrids under
    ``raw``, card features under ``features``): (1) train() of the
    non-CWT FastSpeech2 with previews; (2) make_base_mels; (3)
    train_vocoder(fine_tuning=True); (4-5) the export into the fused
    Generator, f32 and bf16, against the weight-norm route; (6) the
    synthesize and evaluate --objective CLIs. Counts zeroed just before
    each stage and read just after. Returns each stage's launches (the
    export's: MRF launches per dtype)."""
    from tts_king_torch.config import StepConfig
    from tts_king_torch.models.hifigan import Generator

    t_phase = time.perf_counter()
    cfg = main_config()
    cfg.preprocess.raw_path = raw
    cfg.preprocess.preprocessed_path = features
    cfg.train.ckpt_path = os.path.join(tmp, "ft_ckpt")
    cfg.train.result_path = os.path.join(tmp, "ft_result")
    cfg.train.step = StepConfig(total_step=TRAIN_STEPS, log_step=1,
                                synth_step=FT_SYNTH_STEP,
                                val_step=TRAIN_STEPS, save_step=TRAIN_STEPS)
    voc_vars = seeded_flax_variables(lambda: Generator(cfg.vocoder), seed=1)
    stages = {}
    fs2_state, stages["train"] = finetune_train(cfg, voc_vars)
    out_dir, stages["base_mels"] = finetune_base_mels(cfg)
    state, stages["train_vocoder"] = finetune_vocoder(cfg, out_dir)
    t0 = time.perf_counter()
    export = phase_gan_export(state, smi, phase="finetune_path")
    stages["export"] = {"wall_s": time.perf_counter() - t0,
                        "launches": export}
    stages.update(finetune_clis(cfg, fs2_state, state, tmp))
    emit({"phase": "finetune_path", "stages": stages,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi,
          "ok": True})
    return {name: stage["launches"] for name, stage in stages.items()}


WIDTH_STATS = {"pitch": [-7.0, 9.5], "energy": [-1.4, 6.1]}


def train_state_at_width(device="cuda"):
    """A TrainState of TTSConfig()'s FastSpeech2 on the card, initialized as
    train() does, with the bench's pitch/energy bins."""
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.train.state import (Optimizer, TrainState,
                                            init_state_dict)
    from tts_king_torch.weights import load_into

    import torch

    cfg = main_config()
    with torch.device("meta"):
        model = build_fastspeech2(cfg.model, WIDTH_STATS, 66)
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


def phase_gan_export(state, smi, device="cuda", phase="gan_path"):
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
        emit({"phase": phase, "step": "export", "dtype": dname,
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
           "launches": launches["attention"],
           "launches_bf16": launches["attention_bf16"], "dtype": "bf16",
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
    once, the packed taps and biases once.

    bf16 with rows: each stage again with the rows that the Generator
    passes for BULK_FRAMES, held against the launch without rows (equal
    bit for bit below each item's rows, zero past them) and timed: rows_ms,
    rows_stage_ms; rows_blocks (mrf_rows_blocks) counts the blocks that
    ran on the card."""
    import torch

    from tts_king_torch.models.hifigan import needed_rows
    from tts_king_torch.ops.kernels import mrf

    out = {}
    for dname, dtype, B, t_mel in (
            ("bf16", torch.bfloat16, BENCH_B, BENCH_T),
            ("f32", torch.float32, 1, SPEAK_LEN)):
        stages = fused_stages(cfg, t_mel)
        stage_ms, plain_ms, chain_ms, grid = [], 0.0, 0.0, []
        rows_ms = []
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
            del ref
            if dname == "bf16":
                rows = needed_rows(cfg.vocoder, BULK_FRAMES, Tw // t_mel, Tw)
                cut = mrf.mrf_stage(x, packed, rows)
                for b, r in enumerate(rows):
                    if not (torch.equal(cut[b, :r].float(), got[b, :r])
                            and not cut[b, r:].any()):
                        fail(f"mrf_stage bf16 {[B, Tw, C]} with rows: item "
                             f"{b} (rows {r}) differs from the launch "
                             "without rows")
                del cut
                rows_ms.append(cuda_ms(lambda: mrf.mrf_stage(x, packed, rows),
                                       warmup=1, reps=3))
            del got
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
        else:
            out[dname].update(rows_ms=sum(rows_ms), rows_stage_ms=rows_ms,
                              rows_blocks=mrf_rows_blocks(cfg))
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


def mrf_rows_blocks(cfg):
    """The bf16 kernel's blocks with BULK_FRAMES' rows, counted on the card:
    the source built again with -DTK_PROFILE_PHASES, whose blocks add one
    to a device counter as they run their tile or exit, each stage launched
    once through mrf.mrf_stage with both counters (the device's and the
    wrapper's tiles_run / tiles_total) zeroed just before. Fails unless the
    device's counts are the wrapper's. Returns the blocks that ran, the
    blocks launched and their share over the three stages."""
    import ctypes

    import torch

    from tts_king_torch.models.hifigan import needed_rows
    from tts_king_torch.ops.kernels import _build, mrf

    path = os.path.join(_build.build_dir(), "mrf_stage-blocks.so")
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DTK_PROFILE_PHASES", "-o",
         path, os.path.join(_build.CSRC_DIR, _build.SOURCES["mrf_stage"])],
        capture_output=True, text=True)
    if proc.returncode:
        fail(f"nvcc -DTK_PROFILE_PHASES mrf_stage.cu:\n{proc.stdout}"
             f"{proc.stderr}")
    lib = _build.bind("mrf_stage", path)
    lib.tk_mrf_block_counts.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * 2)()
    repo_lib = _build.load("mrf_stage")
    ran = launched = 0
    try:
        _build._libs["mrf_stage"] = lib
        for C, Tw in fused_stages(cfg, BENCH_T):
            x, stage = mrf_inputs(BENCH_B, C, Tw, torch.bfloat16, seed=C)
            rows = needed_rows(cfg.vocoder, BULK_FRAMES, Tw // BENCH_T, Tw)
            packed = mrf.pack_stage(stage)
            torch.cuda.synchronize()
            _build.check(lib, lib.tk_mrf_block_counts(counts), "block counts")
            mrf.tiles_run = mrf.tiles_total = 0
            mrf.mrf_stage(x, packed, rows)
            torch.cuda.synchronize()
            _build.check(lib, lib.tk_mrf_block_counts(counts), "block counts")
            dev_run, dev_exited = int(counts[0]), int(counts[1])
            if (dev_run, dev_run + dev_exited) != (mrf.tiles_run,
                                                  mrf.tiles_total):
                fail(f"mrf_stage bf16 {[BENCH_B, Tw, C]} with rows: the card "
                     f"ran {dev_run} of {dev_run + dev_exited} blocks, the "
                     f"wrapper counts {mrf.tiles_run} of {mrf.tiles_total}")
            ran += dev_run
            launched += dev_run + dev_exited
            del x, stage, packed
    finally:
        _build._libs["mrf_stage"] = repo_lib
    torch.cuda.empty_cache()
    return {"ran": ran, "launched": launched, "share": ran / launched}


# BigVGAN-v2's anti-aliased activation (row 4): the stages' (C, T) at the
# bulk cell's mel bucket 1000 (rates 4 4 2 2 2 2 from 1536 channels), run
# at B 32, and shapes that take the kernel's general path: T no multiple
# of 8, shorter than a tile, a tile and a sample past one.
AMP_STAGES = [(768, 4000), (384, 16000), (192, 32000), (96, 64000),
              (48, 128000), (24, 256000)]
AMP_CHECKS = [(3, 5, 1), (2, 7, 13), (3, 9, 1027), (2, 24, 2053),
              (2, 16, 3072), (1, 32, 5000)]


def amp_act_unfused(x, alpha, beta):
    """Upstream's torch Activation1d(SnakeBeta) as PyTorch ops in x's dtype
    (NVIDIA/BigVGAN alias_free_activation/torch): the yardstick that the
    fused kernel replaces."""
    import torch
    import torch.nn.functional as F

    from tts_king_torch.ops.kernels.amp_act import lowpass_filter

    C = x.shape[1]
    w = lowpass_filter().to(x.device, x.dtype).view(1, 1, 12).expand(C, 1, 12)
    u = F.pad(x, (5, 5), mode="replicate")
    u = 2 * F.conv_transpose1d(u, w, stride=2, groups=C)[..., 15:-15]
    a = torch.exp(alpha)[None, :, None]
    b = torch.exp(beta)[None, :, None]
    u = u + (1.0 / (b + 1e-9)) * torch.sin(u * a) ** 2
    return F.conv1d(F.pad(u, (5, 6), mode="replicate"), w, stride=2,
                    groups=C)


def amp_act_inputs(B, C, T, seed):
    """x (B, C, T) in (B, T, C) memory, as BigVGAN holds its signals; a and
    b (alpha, beta), the bias (C,) and a residual like x."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = 3.0 * torch.randn((B, T, C), generator=g, device="cuda")
    a = 0.3 * torch.randn(C, generator=g, device="cuda")
    b = 0.3 * torch.randn(C, generator=g, device="cuda")
    bias = torch.randn(C, generator=g, device="cuda")
    r = torch.randn((B, T, C), generator=g, device="cuda")
    return x.transpose(1, 2), a, b, bias, r.transpose(1, 2)


def ulp_of(t, bits):
    """One ulp at each value of t for a float of ``bits`` stored mantissa
    bits (bf16 7, f32 23): 2^(e - bits)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(
        t.float().abs().clamp(min=2.0 ** -126))) - bits)


def ulp_errors(got, want, scale, ulp):
    """Errors of got against want where each value's room is ``ulp`` there
    (a tensor) or 1e-5 of ``scale``, whichever is larger: (the most ulps
    where one ulp is the room, the largest error over scale where 1e-5 of
    it is, the largest excess over the room, <= 0 when every error is
    within it)."""
    import torch

    err = (got.float() - want.float()).abs()
    room = torch.maximum(ulp, torch.full_like(err, 1e-5 * scale))
    by_ulp = ulp >= 1e-5 * scale
    ulps = float((err / ulp)[by_ulp].max()) if bool(by_ulp.any()) else 0.0
    cancel = (float(err[~by_ulp].max()) / scale
              if not bool(by_ulp.all()) else 0.0)
    return ulps, cancel, float((err - room).max())


AMP_PROLOGUES = ("none", "bias", "residual")


def amp_act_prologue(prologue, bias, r):
    """amp_act's optional arguments for a prologue: none, a conv's bias, or
    the bias and a residual."""
    return {"none": (), "bias": (bias,), "residual": (bias, r)}[prologue]


def amp_act_check(x, a, b, bias, r):
    """Hold the fused activation to its plain version of the f32 sum of its
    inputs, with each prologue (none, bias, bias and residual), on the f32
    inputs x (B, C, T) in (B, T, C) memory, a, b and bias (C,), r like x
    (f32 signals laid out (B, C, T) first, as f32 BigVGAN holds them), and
    on them rounded to bf16: f32 within 1e-6 of the plain version's
    largest value; bf16 within one bf16 ulp of the plain f32 result rounded
    once (or 1e-5 of the largest value where the sums cancel to near zero);
    the stored sum equal to the f32 sum rounded once. Fails the run past
    any; returns the errors, the largest over the prologues."""
    import torch

    from tts_king_torch.ops.dilated_conv import laid_out
    from tts_king_torch.ops.kernels import amp_act as amp

    out = {"f32_rel_err": 0.0, "bf16_max_ulps": 0.0,
           "bf16_cancel_rel_err": 0.0}
    for prologue in AMP_PROLOGUES:
        for dtype in (torch.float32, torch.bfloat16):
            ins = [laid_out(t.to(dtype)) if t.dim() == 3 else t.to(dtype)
                   for t in (x, a, b, bias, r)]
            s = ins[0].float()
            if prologue != "none":
                s = s + ins[3].float()[:, None]
            if prologue == "residual":
                s = s + ins[4].float()
            got = amp.amp_act(*ins[:3], *amp_act_prologue(prologue,
                                                          *ins[3:]))
            if prologue == "residual":
                total, got = got
                if not torch.equal(total, s.to(dtype)):
                    fail(f"amp_act {list(x.shape)} {dtype}: the stored sum "
                         "is not the f32 sum rounded once")
                del total
            ref = amp.amp_act_plain(s, ins[1].float(), ins[2].float())
            del s
            scale = float(ref.abs().max())
            if dtype == torch.float32:
                err32 = float((got - ref).abs().max()) / scale
                out["f32_rel_err"] = max(out["f32_rel_err"], err32)
                ok = err32 <= 1e-6
            else:
                rounded = ref.bfloat16().float()
                ulps, cancel, past = ulp_errors(got.float(), rounded, scale,
                                                ulp_of(rounded, 7))
                out["bf16_max_ulps"] = max(out["bf16_max_ulps"], ulps)
                out["bf16_cancel_rel_err"] = max(out["bf16_cancel_rel_err"],
                                                 cancel)
                ok = past <= 0 and bool(torch.isfinite(got).all())
                del rounded
            if not ok:
                fail(f"amp_act {list(x.shape)} {dtype} {prologue}: "
                     f"{out}")
            del got, ref, ins
    # bf16: the most ulps where one ulp is the room, and the largest error
    # over the largest value where 1e-5 of it is
    return out


def amp_chain_kernels(events, span, ops):
    """Device kernels in a trace launched by one of ``ops`` (aten operator
    names) inside ``span``."""
    n = 0
    for e in events:
        chain, p = set(), e
        while p is not None:
            chain.add(p.name)
            p = p.cpu_parent
        if span in chain and chain & set(ops):
            n += len(getattr(e, "kernels", []))
    return n


def amp_act_timing_row(smi):
    """Row 4: the fused anti-aliased SnakeBeta (csrc/amp_act.cu) on signals
    in their dtype's layout (bf16 (B, T, C), the tile kernel; f32 (B, C,
    T), the row kernel). Checks (amp_act_check, each prologue) at
    AMP_CHECKS, then at each stage of AMP_STAGES at B 32 the check, the f32
    row kernel's ms without a prologue (ms_f32) and,
    bf16: the kernel's ms with each prologue beside its bound (bytes over
    HBM: the input read and the output written once, 2 bytes an element, the
    bias's C elements read, and with a residual its read and the sum's write
    too; operations over the CUDA cores' f32 peak: 24 multiply-adds and two
    sines an element, and the prologue's adds), the plain version's ms and
    the unfused PyTorch chain's in bf16 (no prologue). Last, one bf16
    BigVGAN-v2 Vocoder.generate(mel, lengths) at the published widths, B 32
    and the mel bucket 1000 with BULK_FRAMES' lengths (the bulk cell's
    call), under the profiler: the wrapper's counters (amp_act.launches,
    elements, bias_in, residual_in, mean_launches, zeroed just before)
    against the kernels' launches in the trace, the vocoder.act spans and
    the layout's counts (109 launches, 90 with a bias, 36 with a residual,
    6 stage means), and no bias add left inside a vocoder.amp_conv span."""
    import numpy as np
    import torch

    from tts_king_torch.config import TTSConfig, VocoderModelConfig
    from tts_king_torch.models.bigvgan import BigVGAN
    from tts_king_torch.ops.dilated_conv import laid_out
    from tts_king_torch.ops.kernels import amp_act as amp
    from tts_king_torch.pipeline import Vocoder
    from tts_king_torch.weights import seeded_state_dict

    checks = {}
    for B, C, T in AMP_CHECKS:
        ins = amp_act_inputs(B, C, T, seed=B * C + T)
        checks[f"{B}x{C}x{T}"] = amp_act_check(*ins)
        del ins
    stages = []
    for C, T in AMP_STAGES:
        ins = amp_act_inputs(BENCH_B, C, T, seed=C)
        checks[f"{BENCH_B}x{C}x{T}"] = amp_act_check(*ins)
        x32 = laid_out(ins[0])
        stage = {"shape": [BENCH_B, C, T], "ms_f32": cuda_ms(
            lambda: amp.amp_act(x32, *ins[1:3]), warmup=3, reps=10)}
        del x32
        x, a, b, bias, r = [t.bfloat16() for t in ins]
        del ins
        n = float(x.numel())
        for prologue in AMP_PROLOGUES:
            extra = amp_act_prologue(prologue, bias, r)
            ms = cuda_ms(lambda: amp.amp_act(x, a, b, *extra), warmup=3,
                         reps=10)
            moved = 2 * 2 * n + (2 * C if extra else 0) + (
                2 * 2 * n if prologue == "residual" else 0)
            t_bytes = moved / PEAK_BYTES
            t_ops = (24 * 2 + 2 * 4 + len(extra)) * n / PEAK_F32_OPS
            key = "" if prologue == "none" else f"_{prologue}"
            stage[f"ms{key}"] = ms
            stage[f"bound_ms{key}"] = max(t_bytes, t_ops) * 1e3
            stage[f"bound_by{key}"] = ("bytes" if t_bytes >= t_ops
                                       else "operations")
        stage["plain_ms"] = cuda_ms(lambda: amp.amp_act_plain(x, a, b),
                                    warmup=1, reps=3)
        stage["library_ms"] = cuda_ms(lambda: amp_act_unfused(x, a, b),
                                      warmup=1, reps=3)
        stages.append(stage)
        del x, r
        torch.cuda.empty_cache()
    emit({"phase": "kernel_vs_plain", "kernel": "amp_act", "checks": checks,
          "ok": True})
    tc = TTSConfig()
    tc.model.vocoder_model = "BigVGAN"
    tc.vocoder = VocoderModelConfig(
        upsample_rates=[4, 4, 2, 2, 2, 2],
        upsample_kernel_sizes=[8, 8, 4, 4, 4, 4],
        upsample_initial_channel=1536, max_wav_value=32767.0)
    with torch.device("meta"):
        sd = seeded_state_dict(BigVGAN(tc.vocoder), 0)
    # conv_post at 1/80 of its draw, as the benchmark's weight rule
    sd["conv_post.weight"] = sd["conv_post.weight"] / 80
    voc = Vocoder(tc, variables=sd, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    mel = torch.randn(BENCH_B, BENCH_T, 80, generator=g, device="cuda") - 5
    lengths = np.asarray(BULK_FRAMES) * 256
    voc.generate(mel, lengths)
    torch.cuda.synchronize()
    names = ("launches", "elements", "bias_in", "residual_in",
             "mean_launches")
    for name in names:
        setattr(amp, name, 0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wavs = voc.generate(mel, lengths)
        torch.cuda.synchronize()
    counted = {name: getattr(amp, name) for name in names}
    events = prof.events()
    traced = sum(1 for e in events if "amp_act_kernel" in e.name
                 and e.device_type == torch.autograd.DeviceType.CUDA)
    traced_means = sum(1 for e in events if "amp_mean_kernel" in e.name
                       and e.device_type == torch.autograd.DeviceType.CUDA)
    spans = sum(1 for e in events if e.name == "vocoder.act"
                and e.device_type == torch.autograd.DeviceType.CPU)
    conv_bias_adds = amp_chain_kernels(events, "vocoder.amp_conv",
                                       ("aten::add_", "aten::add"))
    want_elements = BENCH_B * BENCH_T * (sum(
        C * T // 1000 * 18 for C, T in AMP_STAGES) + 24 * 256)
    if not (counted["launches"] == traced == spans == 109
            and counted["elements"] == want_elements
            and (counted["bias_in"], counted["residual_in"]) == (90, 36)
            and counted["mean_launches"] == traced_means == 6
            and conv_bias_adds == 0
            and [len(w) for w in wavs] == list(lengths)):
        fail(f"amp_act counters {counted} against the trace: {traced} "
             f"launches, {spans} vocoder.act spans, {traced_means} stage "
             f"means, {conv_bias_adds} adds inside vocoder.amp_conv (109, "
             f"{want_elements} elements, 90 with a bias, 36 with a "
             "residual, 6 means and no add wanted)")
    row = {"name": "amp_act", "route": "cuda",
           "source": "tts_king_torch/csrc/amp_act.cu",
           "replaces": "none (BigVGAN's Activation1d(SnakeBeta); the JAX "
                       "package has no BigVGAN)", "dtype": "bf16",
           "ms": sum(s["ms"] for s in stages),
           "bound_ms": sum(s["bound_ms"] for s in stages),
           "ms_bias": sum(s["ms_bias"] for s in stages),
           "bound_ms_bias": sum(s["bound_ms_bias"] for s in stages),
           "ms_residual": sum(s["ms_residual"] for s in stages),
           "ms_f32": sum(s["ms_f32"] for s in stages),
           "bound_ms_residual": sum(s["bound_ms_residual"] for s in stages),
           "plain_ms": sum(s["plain_ms"] for s in stages),
           "library_ms": sum(s["library_ms"] for s in stages),
           "stages": stages, "checks": checks,
           "generate_call": dict(counted, traced_launches=traced,
                                 spans=spans, traced_means=traced_means,
                                 adds_in_amp_conv=conv_bias_adds),
           "nvidia_smi": smi,
           "note": "ms, bound_ms, plain_ms, library_ms: one activation at "
                   "each of the six stages at B 32 (T_mel 1000) on (B, T, C) "
                   "signals, summed; a stage runs 18 of them a generator "
                   "call, 15 with a bias (_bias), 6 of those with a "
                   "residual too (_residual); library: the unfused PyTorch "
                   "chain in bf16"}
    del voc
    torch.cuda.empty_cache()
    return row


def stage_mean_pytorch(parts):
    """An upsampling stage's mean over its AMP blocks' parts (a, bias, x)
    as PyTorch ops in the parts' dtype: each block's output (a + bias) + x
    in two adds, their sum, divided by n (the route that amp_mean
    replaces)."""
    acc = None
    for a, b, x in parts:
        out = (a + b[:, None]) + x
        acc = out if acc is None else acc + out
    return acc / len(parts)


def amp_mean_timing_row(smi):
    """Row 4m: an upsampling stage's mean over its 3 AMP blocks
    (amp_act.amp_mean, amp_mean_kernel in csrc/amp_act.cu) at each stage of
    AMP_STAGES at B 32, in bf16 ((B, T, C) memory) and f32 ((B, C, T)):
    bit for bit the f32 sum of the parts, (a + bias) + x a block, divided
    by n and rounded once. bf16: its ms beside its bound (bytes over HBM:
    each block's a and x read, 2 bytes an element, and its bias, the mean
    written) and the PyTorch route's ms (``stage_mean_pytorch``). Fails the
    run past any check."""
    import torch

    from tts_king_torch.ops.dilated_conv import laid_out
    from tts_king_torch.ops.kernels import amp_act as amp

    stages = []
    for C, T in AMP_STAGES:
        g = torch.Generator(device="cuda").manual_seed(C + 1)
        stage = {"shape": [BENCH_B, C, T]}
        for dtype in (torch.float32, torch.bfloat16):
            parts = [tuple(laid_out(t.to(dtype)) if t.dim() == 3
                           else t.to(dtype) for t in (
                torch.randn(BENCH_B, T, C, generator=g,
                            device="cuda").transpose(1, 2),
                torch.randn(C, generator=g, device="cuda"),
                torch.randn(BENCH_B, T, C, generator=g,
                            device="cuda").transpose(1, 2)))
                for _ in range(3)]
            s = 0
            for a, b, x in parts:
                s = s + ((a.float() + b.float()[:, None]) + x.float())
            # a divisor on the card: PyTorch multiplies by the reciprocal
            # of a Python scalar there, where the kernel divides
            want = (s / torch.full((), 3.0, device="cuda")).to(dtype)
            del s
            got = amp.amp_mean(parts)
            if not (torch.equal(got, want) and laid_out(got) is got):
                fail(f"amp_mean {[BENCH_B, C, T]} {dtype}: not the f32 sum "
                     "of its parts over n rounded once, in its layout")
            del got, want
            if dtype == torch.bfloat16:
                n = float(BENCH_B * C * T)
                stage["ms"] = cuda_ms(lambda: amp.amp_mean(parts), warmup=3,
                                      reps=10)
                stage["bound_ms"] = (3 * (2 * 2 * n + 2 * C) + 2 * n) / (
                    PEAK_BYTES) * 1e3
                stage["pytorch_ms"] = cuda_ms(
                    lambda: stage_mean_pytorch(parts), warmup=1, reps=5)
            del parts
            torch.cuda.empty_cache()
        stages.append(stage)
    return {"name": "amp_mean", "route": "cuda",
            "source": "tts_king_torch/csrc/amp_act.cu",
            "replaces": "none (BigVGAN's mean over a stage's AMP blocks; "
                        "the JAX package has no BigVGAN)", "dtype": "bf16",
            "ms": sum(s["ms"] for s in stages),
            "bound_ms": sum(s["bound_ms"] for s in stages),
            "pytorch_ms": sum(s["pytorch_ms"] for s in stages),
            "stages": stages, "checks": "bit for bit, bf16 and f32",
            "nvidia_smi": smi,
            "note": "one stage mean (3 blocks) at each of the six stages at "
                    "B 32 (T_mel 1000), summed: a generator call's 6 "
                    "launches; pytorch: the blocks' last sums and their "
                    "mean as PyTorch ops in bf16"}


def phase_amp_conv(smi):
    """BigVGAN-v2's AMP convs folded by their dilation (ops/dilated_conv.py).
    Each conv of the published layout that dilated_conv.folds folds in
    bf16, at its stage's (B 32, C, T) at T_mel 1000, input and weight
    channels-last as the generator holds them: the fold against
    cuDNN's dilated conv on the same inputs, in bf16 within one bf16 ulp of
    the larger of the two values (or 1e-5 of the largest value where the
    sums cancel), and in f32 within one f32 ulp (or 1e-5 of the largest
    value); the bf16 fold also against the f32 dilated conv on the bf16
    inputs rounded once, within one bf16 ulp. The bf16 sums are compared
    without the bias: PyTorch adds a conv's bias after cuDNN's conv, in the
    output's dtype, by the same op on either route, so a bf16 result with
    it is rounded twice (the f32 check keeps the bias). Then one bf16
    BigVGAN-v2 Vocoder.generate(mel, lengths) at B 32, T_mel 1000 with
    BULK_FRAMES' lengths under the profiler: bigvgan.amp_conv_calls and
    amp_conv_folded (zeroed just before) against the vocoder.amp_conv spans
    (108) and the rule's count. Fails the run past any of them."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tts_king_torch.config import TTSConfig, VocoderModelConfig
    from tts_king_torch.models import bigvgan
    from tts_king_torch.ops.dilated_conv import (channels_last,
                                                 dilated_conv1d, folds)
    from tts_king_torch.pipeline import Vocoder
    from tts_king_torch.weights import seeded_state_dict

    def within(got, want, scale, bits):
        ulp = ulp_of(torch.maximum(got.float().abs(), want.float().abs()),
                     bits)
        return ulp_errors(got, want, scale, ulp)

    tc = TTSConfig()
    tc.model.vocoder_model = "BigVGAN"
    tc.vocoder = VocoderModelConfig(
        upsample_rates=[4, 4, 2, 2, 2, 2],
        upsample_kernel_sizes=[8, 8, 4, 4, 4, 4],
        upsample_initial_channel=1536, max_wav_value=32767.0)
    with torch.device("meta"):
        meta = bigvgan.BigVGAN(tc.vocoder)
    T, C, want_folded, checks = BENCH_T, 1536, 0, {}
    for i, u in enumerate(tc.vocoder.upsample_rates):
        T, C = T * u, C // 2
        for k, dils in zip(tc.vocoder.resblock_kernel_sizes,
                           tc.vocoder.resblock_dilation_sizes):
            for d in dils:
                if not folds(C, k, d, torch.bfloat16):
                    continue
                want_folded += 1
                g = torch.Generator(device="cuda").manual_seed(C * k + d)
                x = torch.randn(BENCH_B, T, C, generator=g,
                                device="cuda").transpose(1, 2)
                w = channels_last(torch.randn(C, C, k, generator=g,
                                              device="cuda") / math.sqrt(C * k))
                b = 0.1 * torch.randn(C, generator=g, device="cuda")
                p = d * (k - 1) // 2
                got = dilated_conv1d(x, w, b, d, p)
                ref = F.conv1d(x, w, b, padding=p, dilation=d)
                f32 = within(got, ref, float(ref.abs().max()), 23)
                del got, ref
                xb, wb = x.bfloat16(), w.bfloat16()
                del x
                got = dilated_conv1d(xb, wb, None, d, p)
                ref = F.conv1d(xb, wb, None, padding=p, dilation=d)
                bf16 = within(got, ref, float(ref.float().abs().max()), 7)
                del ref
                exact = F.conv1d(xb.float(), wb.float(), None, padding=p,
                                 dilation=d)
                once = within(got, exact.bfloat16(),
                              float(exact.abs().max()), 7)
                del got, exact, xb
                name = f"{BENCH_B}x{C}x{T} k{k} d{d}"
                checks[name] = {
                    "f32_max_ulps": f32[0], "f32_cancel_rel_err": f32[1],
                    "bf16_max_ulps": bf16[0], "bf16_cancel_rel_err": bf16[1],
                    "bf16_vs_rounded_once_max_ulps": once[0],
                    "bf16_vs_rounded_once_cancel_rel_err": once[1]}
                if max(f32[2], bf16[2], once[2]) > 0:
                    fail(f"amp_conv fold {name}: {checks[name]}")
                torch.cuda.empty_cache()
    with torch.device("meta"):
        sd = seeded_state_dict(meta, 0)
    sd["conv_post.weight"] = sd["conv_post.weight"] / 80
    voc = Vocoder(tc, variables=sd, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    mel = torch.randn(BENCH_B, BENCH_T, 80, generator=g, device="cuda") - 5
    lengths = np.asarray(BULK_FRAMES) * 256
    voc.generate(mel, lengths)
    torch.cuda.synchronize()
    bigvgan.amp_conv_calls = bigvgan.amp_conv_folded = 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wavs = voc.generate(mel, lengths)
        torch.cuda.synchronize()
    counted = {"calls": bigvgan.amp_conv_calls,
               "folded": bigvgan.amp_conv_folded}
    spans = sum(1 for e in prof.events() if e.name == "vocoder.amp_conv"
                and e.device_type == torch.autograd.DeviceType.CPU)
    if not (counted["calls"] == spans == 108
            and counted["folded"] == want_folded
            and [len(w) for w in wavs] == list(lengths)):
        fail(f"amp_conv counters {counted} against {spans} vocoder.amp_conv "
             f"spans (108 calls and {want_folded} folded wanted)")
    emit({"phase": "amp_conv", "checks": checks,
          "generate_call": dict(counted, spans=spans), "nvidia_smi": smi,
          "ok": True})
    del voc
    torch.cuda.empty_cache()


def phase_timing(cfg, launches, train_launches, errs, mel_lens, mrf_runs):
    rows = [attention_timing_row(cfg, launches, errs["attention"], mel_lens),
            mrf_timing_row(cfg, launches, mrf_runs, errs["mrf_stage"]),
            flash_timing_row(cfg, train_launches, errs["flash_attention"])]
    return rows


def flash_timing_row(cfg, launches, max_err, probs_bf16=False):
    """The flash kernels at the decoder's call of the bench training step
    (B=16, H=2, T=640, D=128, key mask from the bench superbatch's mel
    lengths): forward, backward (dQ then dK/dV), the plain version forward
    + autograd backward, and SDPA forward + backward with the same boolean
    key mask; the kernels are held against the plain version on these
    inputs first. The bound counts the valid keys only, the work this mask
    needs: 4 D operations per (row, valid key) forward and 10 backward (S
    and dP recomputed, dV, dQ, dK), as 3xTF32 (3 x operations over the TF32
    peak), with the f32 CUDA-core bound beside it; bytes: each input read
    and each output written once, K and V read at the valid keys only.

    probs_bf16: row 3p, the kernels' bf16-probability mode
    (csrc/attention_round.cuh), held at PROBS_TOL. The products with
    round(P), forward round(P) V and dV = round(P)^T dO, count 2 TF32
    passes: round(P) is exact in TF32, its low split 0 (the kernels skip
    that pass). The function's autodiff (jax.vjp of the XLA route) keeps P
    from the forward, so its bound is the lesser of two ways to compute it:
    P kept (the backward's units dP 3, dS K 3, dV 2, dK 3; P written by the
    forward and read by the backward, 4 bytes each way per query row and
    valid key, among the bytes) or recomputed (S 3 and dP 3 more, no P
    bytes; bound_recompute_ms); fwd_bound_ms and bwd_bound_ms are the
    lesser way's. No PyTorch call rounds the normalized probabilities, so
    library_ms is None and SDPA's f32 time stands beside it as
    sdpa_f32_ms."""
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
    pb = probs_bf16
    saved = fa._forward_cuda(qd, kd, vd, m8, pb)   # (O, lse, P or None)
    g = fa._out_like(qd).copy_(g)
    got = saved[:1] + fa._backward_cuda(qd, kd, vd, m8, *saved, g)
    ref = fa.flash_attention_plain(q, k, v, mask, pb)
    ref = (ref,) + torch.autograd.grad(ref, (q, k, v), g)
    errs = {name: float((a - b).detach().abs().max())
            for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref)}
    means = {name: float((a - b).detach().abs().mean())
             for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref)}
    pad = mask[:, None, :, None].expand_as(got[2])
    tol = PROBS_TOL["max"] if pb else TOL[("flash_attention", "f32")]
    if not (max(errs.values()) <= tol
            and (not pb or max(means.values()) <= PROBS_TOL["mean"])
            and all(bool(torch.isfinite(t).all()) for t in got)
            and not bool(got[2][pad].any()) and not bool(got[3][pad].any())):
        fail(f"flash_attention {[B, H, T, D]} probs_bf16 {pb} timed inputs: "
             f"errors {errs}, mean {means}")
    del got, ref
    fwd_ms = cuda_ms(lambda: fa._forward_cuda(qd, kd, vd, m8, pb), warmup=2,
                     reps=10)
    bwd_ms = cuda_ms(lambda: fa._backward_cuda(qd, kd, vd, m8, *saved, g),
                     warmup=2, reps=10)

    def plain():
        out = fa.flash_attention_plain(q, k, v, mask, pb)
        torch.autograd.grad(out, (q, k, v), g)

    keep = (~mask)[:, None, None, :]

    def sdpa():
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        torch.autograd.grad(out, (q, k, v), g)

    plain_ms = cuda_ms(plain, warmup=2, reps=10)
    lib_ms = cuda_ms(sdpa, warmup=2, reps=10)
    n_keys = float(np.sum(lens))
    pairs = H * D * T * n_keys
    ops_f, ops_b = 4.0 * pairs, 10.0 * pairs
    # TF32 passes: 3 a product; 2 for the products with round(P)
    passes_f = (3 * 2 + 2 * 2) * pairs if pb else 3 * ops_f
    passes_b = (3 * 8 + 2 * 2) * pairs if pb else 3 * ops_b
    elems, kv = B * H * T * D, 2.0 * H * D * n_keys
    # forward: q read, o written, k and v read at the valid keys, lse
    # written, the mask; backward: q, o and dO read, dq, dk and dv written,
    # k and v read at the valid keys, lse read, the mask
    bytes_f = 4.0 * (2 * elems + kv + B * H * T) + B * T
    bytes_b = 4.0 * (6 * elems + kv + B * H * T) + B * T

    def bound(ops, nbytes, peak=PEAK_TF32_OPS):
        return max(ops / peak, nbytes / PEAK_BYTES) * 1e3

    recompute_ms = bound(passes_f + passes_b, bytes_f + bytes_b)
    if pb:
        # P kept: the backward's dP, dS K, dV, dK (11 units), P's f32
        # written by the forward and read by the backward
        p_bytes = 4.0 * H * T * n_keys
        keep_b = (3 * 6 + 2 * 2) * pairs
        keep_ms = bound(passes_f + keep_b, bytes_f + bytes_b + 2 * p_bytes)
        if keep_ms < recompute_ms:
            passes_b, bytes_f, bytes_b = (keep_b, bytes_f + p_bytes,
                                          bytes_b + p_bytes)
    t_ops = (passes_f + passes_b) / PEAK_TF32_OPS
    t_bytes = (bytes_f + bytes_b) / PEAK_BYTES

    mode = "_probs_bf16" if pb else ""
    return {
        "name": "flash_attention" + mode, "route": "cuda",
        "source": ("tts_king_torch/csrc/attention_round.cuh" if pb else
                   "tts_king_torch/csrc/flash_attention.cu"),
        "replaces": "tts_king_tpu/ops/pallas/attention.py:102",
        "launches": launches["flash_fwd" + mode], "launches_fwd":
        launches["flash_fwd" + mode], "launches_bwd":
        launches["flash_bwd" + mode],
        "max_abs_err": max(errs.values()), "checks_max_abs_err": max_err,
        **({"mean_abs_err": max(means.values())} if pb else {}),
        "ms": fwd_ms + bwd_ms,
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        **({"bound_recompute_ms": recompute_ms} if pb else {}),
        "fwd_bound_ms": bound(passes_f, bytes_f),
        "bwd_bound_ms": bound(passes_b, bytes_b),
        "bound_f32_ffma_ms": bound(ops_f + ops_b, bytes_f + bytes_b,
                                   PEAK_F32_OPS),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None if pb else lib_ms,
        **({"sdpa_f32_ms": lib_ms} if pb else {}),
        "dtype": "f32", "shape": [B, H, T, D],
        "note": "ms, plain_ms, library_ms: forward + backward; launches "
                "from the training path's run" + (
                    " with attention_probs_bf16; library: none (no "
                    "PyTorch call rounds the normalized probabilities), "
                    "SDPA's f32 time as sdpa_f32_ms" if pb else "")}


# ------------------------------------------- bf16 attention probabilities


def _mode_errs(got, ref):
    d = (got.detach().float() - ref.detach().float()).abs()
    return float(d.max()), float(d.mean())


def phase_probs_bf16_vs_plain():
    """The kernels' bf16-probability mode (attention_probs_bf16) against
    the plain versions: the inference kernel at ATTN_CHECKS (f32), the
    flash kernels forward and backward at FLASH_CHECKS, both also at
    PROBS_EXTRA_CHECKS (against
    flash_attention_plain and autograd), within PROBS_TOL's max and mean;
    the control, the unrounded function against the mode's plain version,
    must miss the mean bound, so the check tells the two apart. Returns
    the largest errors per kernel."""
    import torch

    from tts_king_torch.ops.kernels import attention as attn
    from tts_king_torch.ops.kernels import flash_attention as fa

    worst = {"attention": [0.0, 0.0], "flash_attention": [0.0, 0.0]}
    for B, H, T, D, kind in ATTN_CHECKS + PROBS_EXTRA_CHECKS["attention"]:
        (q, k, v), mask = attention_inputs(B, H, T, D, torch.float32, seed=T,
                                           kind=kind)
        got = attn.attention(q, k, v, mask, probs_bf16=True)
        ref = attn.attention_plain(q, k, v, mask, probs_bf16=True)
        control = _mode_errs(attn.attention_plain(q, k, v, mask), ref)
        torch.cuda.synchronize()
        err = _mode_errs(got, ref)
        ok = (bool(torch.isfinite(got).all()) and err[0] <= PROBS_TOL["max"]
              and err[1] <= PROBS_TOL["mean"]
              and control[1] > PROBS_TOL["mean"])
        emit({"phase": "kernel_vs_plain", "kernel": "attention",
              "mode": "probs_bf16", "dtype": "f32", "shape": [B, H, T, D],
              "mask": kind, "max_abs_err": err[0], "mean_abs_err": err[1],
              "control_mean_abs_err": control[1], "tol": PROBS_TOL,
              "ok": ok})
        if not ok:
            fail(f"attention probs_bf16 {[B, H, T, D]} {kind}: errors {err},"
                 f" control {control}")
        worst["attention"] = [max(a, b) for a, b in
                              zip(worst["attention"], err)]
    for B, H, T, D, kind in FLASH_CHECKS + PROBS_EXTRA_CHECKS["flash"]:
        (q, k, v), mask, g = flash_inputs(B, H, T, D, seed=T, kind=kind)
        out = fa.flash_attention(q, k, v, mask, probs_bf16=True)
        got = (out,) + torch.autograd.grad(out, (q, k, v), g)
        ref = fa.flash_attention_plain(q, k, v, mask, probs_bf16=True)
        ref = (ref,) + torch.autograd.grad(ref, (q, k, v), g)
        f32 = fa.flash_attention_plain(q, k, v, mask)
        f32 = (f32,) + torch.autograd.grad(f32, (q, k, v), g)
        torch.cuda.synchronize()
        names = ("o", "dq", "dk", "dv")
        errs = {n: _mode_errs(a, b) for n, a, b in zip(names, got, ref)}
        control = {n: _mode_errs(a, b)[1] for n, a, b in zip(names, f32, ref)}
        pad = mask[:, None, :, None].expand_as(got[2])
        pad_zero = not bool(got[2][pad].any()) and not bool(got[3][pad].any())
        ok = (pad_zero and all(bool(torch.isfinite(t).all()) for t in got)
              and max(e[0] for e in errs.values()) <= PROBS_TOL["max"]
              and max(e[1] for e in errs.values()) <= PROBS_TOL["mean"]
              and min(control.values()) > PROBS_TOL["mean"])
        emit({"phase": "kernel_vs_plain", "kernel": "flash_attention",
              "mode": "probs_bf16", "dtype": "f32", "shape": [B, H, T, D],
              "mask": kind, "max_abs_err": {n: e[0] for n, e in errs.items()},
              "mean_abs_err": {n: e[1] for n, e in errs.items()},
              "control_mean_abs_err": control,
              "padded_key_grads_zero": pad_zero, "tol": PROBS_TOL, "ok": ok})
        if not ok:
            fail(f"flash_attention probs_bf16 {[B, H, T, D]} {kind}: errors "
                 f"{errs}, control {control}, padded key grads zero "
                 f"{pad_zero}")
        worst["flash_attention"] = [
            max(worst["flash_attention"][0], *(e[0] for e in errs.values())),
            max(worst["flash_attention"][1], *(e[1] for e in errs.values()))]
    return worst


def attention_probs_timing_row(cfg, launches, errs, mel_lens):
    """Row 1p: the inference kernel's bf16-probability mode, f32, at the
    batched decoder call's shape (B=32, H=2, T=1000, D=128, the batched
    run's mel lengths: the f32 AcousticModel's batched call with the flag)
    and at speak's decoder call (B=1, T=256, 192 valid keys), held against
    attention_probs_bf16_plain on these inputs first, beside the plain
    version, the unrounded kernel and SDPA's f32 time (no PyTorch call
    rounds the normalized probabilities: library_ms None). The bound
    counts the function's products as row 1f does (4 D operations per
    query row and valid key): q k^T at 3 TF32 passes, round(P) V at 2
    (round(P) is exact in TF32, its low split 0, and the kernel skips that
    pass); the kernel's S round trip through its scratch is not counted."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tts_king_torch.ops.kernels import attention as attn

    tc = cfg.model.transformer
    H = tc.decoder_head
    D = tc.decoder_hidden // H
    out = {}
    for where, B, T, lens in (("batched", BENCH_B, BENCH_T, mel_lens),
                              ("speak", 1, SPEAK_T, [SPEAK_LEN])):
        (q, k, v), _ = attention_inputs(B, H, T, D, torch.float32, seed=7)
        mask = torch.from_numpy(np.arange(T)[None] >=
                                np.asarray(lens)[:, None]).cuda()
        additive = torch.zeros((B, 1, 1, T), device="cuda")
        additive.masked_fill_(mask[:, None, None, :], -1e9)
        err = _mode_errs(attn.attention(q, k, v, mask, probs_bf16=True),
                         attn.attention_plain(q, k, v, mask, True))
        if err[0] > PROBS_TOL["max"] or err[1] > PROBS_TOL["mean"]:
            fail(f"attention probs_bf16 {[B, H, T, D]} timed inputs: "
                 f"errors {err}")
        ms = cuda_ms(lambda: attn.attention(q, k, v, mask, probs_bf16=True),
                     warmup=3, reps=20)
        unrounded_ms = cuda_ms(lambda: attn.attention(q, k, v, mask),
                               warmup=3, reps=20)
        plain_ms = cuda_ms(lambda: attn.attention_plain(q, k, v, mask, True),
                           warmup=3, reps=20)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=additive), warmup=3, reps=20)
        n_keys = float(np.sum(lens))
        passes = (3 * 2 + 2 * 2) * H * D * T * n_keys
        nbytes = 4.0 * (2.0 * B * H * T * D + 2.0 * H * D * n_keys) + B * T
        t_ops, t_bytes = passes / PEAK_TF32_OPS, nbytes / PEAK_BYTES
        out[where] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "sdpa_f32_ms": sdpa_ms, "unrounded_kernel_ms": unrounded_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": err[0], "mean_abs_err": err[1],
            "shape": [B, H, T, D], "valid_keys": int(n_keys)}
        del q, k, v
    return {"name": "attention_probs_bf16", "route": "cuda",
            "source": "tts_king_torch/csrc/attention_round.cuh",
            "replaces": "tts_king_tpu/ops/pallas/attention.py:29",
            "launches": launches["speak"] + launches["batched"],
            "launches_by_path": launches, "dtype": "f32",
            **out["batched"], "speak": out["speak"],
            "checks_max_abs_err": errs[0], "checks_mean_abs_err": errs[1],
            "note": "ModelConfig.attention_probs_bf16 on the JAX package's "
                    "XLA route (tts_king_tpu/models/layers.py:82-96); ms, "
                    "plain_ms, bound_ms: the batched shape, speak's call in "
                    "'speak'; library: none, SDPA's f32 time as sdpa_f32_ms"}


def probs_bf16_config(cfg):
    """``cfg`` with ModelConfig.attention_probs_bf16 on."""
    import dataclasses

    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, attention_probs_bf16=True))


def phase_probs_bf16_path(smi, tmp):
    """attention_probs_bf16 on the main paths at the shipped width (the
    default flags: every call rounds, the JAX package's XLA route):
    TTSKing.speak on the three sentences, the f32 AcousticModel's batched
    generate at the bench shape (B=32, L=128, T=1000), and train() for
    TRAIN_STEPS steps of 16 x 4 with validation and objective metrics.
    Each path's counts are zeroed just before it and read just after: every
    attention launch must be a mode launch (10 a speak call, 10 the batched
    call; the validation's), and every flash launch a mode launch (40 each
    way a step). Checks: the speak waveforms' shapes, finite values; a
    batch of 4 on the card against the same model on the CPU (the plain
    versions): lengths equal, mel MAE < 1e-3 (the CWT phase's bound).
    Returns the mode's launches by path."""
    import numpy as np
    import torch

    from tts_king_torch.pipeline import AcousticModel, TTSKing
    from tts_king_torch.train.loop import train

    cfg = probs_bf16_config(main_config())
    cfg.preprocess.lexicon_path = os.path.join(E2E_DIR, "lexicon.dict")
    fs2_vars, voc_vars = main_path_variables(cfg)
    king = TTSKing(cfg, device="cuda", acoustic_variables=fs2_vars,
                   vocoder_variables=voc_vars, n_speakers=66)
    hop = cfg.preprocess.stft.hop_length
    tc = cfg.model.transformer
    n_layers = tc.encoder_layer + tc.decoder_layer
    king.speak(SENTENCES[0])   # cuDNN's plans, the allocator's pools
    phonemes, speakers = bench_batch()
    torch.cuda.synchronize()
    out, launches = {}, {}

    zero_launch_counts()
    t0 = time.perf_counter()
    wavs = [king.speak(text, speaker=i)[0]
            for i, text in enumerate(SENTENCES)]
    torch.cuda.synchronize()
    speak_s = time.perf_counter() - t0
    c = launches["speak"] = launch_counts()   # just after the path's run
    if (c["attention_probs_bf16"] != c["attention"]
            or c["attention"] < n_layers * len(SENTENCES)):
        fail(f"probs_bf16 speak: launches {c}")
    for text, w in zip(SENTENCES, wavs):
        mel, mel_lens = king.generate_mel(text)
        if (w.dtype != np.int16 or w.shape != (int(mel_lens[0]) * hop,)
                or not bool(torch.isfinite(mel).all())):
            fail(f"probs_bf16 speak {text!r}: {w.dtype} {w.shape}")
    out["speak"] = {"wall_s": speak_s,
                    "samples": [int(w.shape[0]) for w in wavs]}

    zero_launch_counts()
    t0 = time.perf_counter()
    res = king.tts.generate(phonemes, speaker_name=speakers,
                            max_mel_len=BENCH_T)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    c = launches["batched"] = launch_counts()
    if c["attention_probs_bf16"] != n_layers or c["attention"] != n_layers:
        fail(f"probs_bf16 batched: launches {c}")
    if not bool(torch.isfinite(res["postnet_mel"]).all()):
        fail("probs_bf16 batched: non-finite mel")
    mel_lens = [int(n) for n in res["mel_lens"].cpu()]
    cpu = AcousticModel(cfg, variables=fs2_vars, n_speakers=66, device="cpu")
    got = king.tts.generate(phonemes[:4], speaker_name=speakers[:4])
    want = cpu.generate(phonemes[:4], speaker_name=speakers[:4])
    want_lens = want["mel_lens"].numpy()
    if not np.array_equal(got["mel_lens"].cpu().numpy(), want_lens):
        fail(f"probs_bf16 generate: card lengths {got['mel_lens']} vs CPU "
             f"{want_lens}")
    maes = [float(np.mean(np.abs(got["postnet_mel"][b, :n].cpu().numpy()
                                 - want["postnet_mel"][b, :n].numpy())))
            for b, n in enumerate(want_lens)]
    if max(maes) >= 1e-3:
        fail(f"probs_bf16 generate: mel MAE card vs CPU {maes}")
    out["batched"] = {"wall_s": batched_s, "shape": [BENCH_B, BENCH_L,
                                                     BENCH_T],
                      "mel_lens_min_max": [min(mel_lens), max(mel_lens)],
                      "generate_B4_mel_mae_vs_cpu": maes}
    del king, cpu, res
    torch.cuda.empty_cache()

    tcfg = probs_bf16_config(train_corpus_config(os.path.join(tmp, "fs2")))
    per_step = n_layers * tcfg.train.optimizer.grad_acc_step
    zero_launch_counts()
    t0 = time.perf_counter()
    state = train(tcfg, max_steps=TRAIN_STEPS, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    c = launches["train"] = launch_counts()
    if (state.step != TRAIN_STEPS
            or c["flash_fwd_probs_bf16"] != per_step * TRAIN_STEPS
            or c["flash_bwd_probs_bf16"] != per_step * TRAIN_STEPS
            or c["flash_fwd"] != c["flash_fwd_probs_bf16"]
            or c["attention"] == 0
            or c["attention_probs_bf16"] != c["attention"]):
        fail(f"probs_bf16 train: step {state.step}, launches {c}")
    with open(os.path.join(tcfg.train.result_path,
                           f"{tcfg.exp_name}.metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["total"] for r in recs if r["phase"] == "train"]
    val = [r["total"] for r in recs if r["phase"] == "val"]
    if (len(losses) != TRAIN_STEPS or len(val) != 1
            or not np.all(np.isfinite(losses + val))):
        fail(f"probs_bf16 train: losses {losses}, val {val}")
    out["train"] = {"wall_s": train_s, "losses": losses, "val_total": val[0]}
    emit({"phase": "probs_bf16_path", **out, "launches": launches,
          "nvidia_smi": smi, "ok": True})
    return {"1p": {p: launches[p]["attention_probs_bf16"]
                   for p in ("speak", "batched", "train")},
            "3p": {k: launches["train"][k] for k in ("flash_fwd_probs_bf16",
                                                      "flash_bwd_probs_bf16")},
            "mel_lens": mel_lens}


# ------------------------------------------- training-dynamics validation

# The validation tools' depth here; their 2000-step runs are made by the
# tools themselves (results/torch_*training_validation.json). Corpora cut
# to 4 x 12 utterances (FastSpeech2: 16 for validation) and 4 x 10 wavs.
VALIDATION_STEPS = 100


def phase_validation_tools(smi, tmp):
    """Both training-dynamics validation tools at VALIDATION_STEPS steps on
    the card, at their default widths and batches: each record's losses
    must be finite and its mel loss must fall (FastSpeech2: the last
    logged train mel below the first, logged every 10 steps; HiFi-GAN: the
    summary's mel_improved and all_finite)."""
    import numpy as np

    from tts_king_torch.tools.validate_training import validate_training
    from tts_king_torch.tools.validate_vocoder_training import \
        validate_vocoder_training

    out = {}
    t0 = time.perf_counter()
    fs2 = validate_training(
        steps=VALIDATION_STEPS, speakers=4, utts=12,
        root=os.path.join(tmp, "fs2"), out=os.path.join(tmp, "fs2.json"),
        log_step=10, val_step=50, device="cuda")
    with open(os.path.join(tmp, "fs2.json")) as f:
        curve = json.load(f)["train_curve"]
    totals = [r["total"] for r in curve] + [r["mel"] for r in curve]
    if not (np.all(np.isfinite(totals))
            and fs2["mel_last"] < fs2["mel_first"]):
        fail(f"validate_training: {fs2}")
    out["fs2"] = {"wall_s": time.perf_counter() - t0, **fs2}
    t0 = time.perf_counter()
    voc = validate_vocoder_training(
        steps=VALIDATION_STEPS, speakers=4, utts=10,
        root=os.path.join(tmp, "voc"), out=os.path.join(tmp, "voc.json"),
        log_every=10, device="cuda")
    if not (voc["all_finite"] and voc["mel_improved"]):
        fail(f"validate_vocoder_training: {voc}")
    out["vocoder"] = {"wall_s": time.perf_counter() - t0, **voc}
    emit({"phase": "validation_tools", "steps": VALIDATION_STEPS, **out,
          "nvidia_smi": smi, "ok": True})


# ---------------------------------------------------------- parallel path

# Ranks of the parallel path: two gloo processes sharing the one card (NCCL
# refuses two ranks on one device; gloo reduces CUDA tensors in place and
# gathers them through pinned host memory, parallel/comm.py), and NCCL at
# world size 1. Each rank's wall time ends in a join with a timeout.
PAR_RANKS = 2
PAR_TIMEOUT_S = 420
PAR_LONG_FRAMES = 4000     # one utterance, ~46 s of audio
# part (d)'s train_vocoder after its first step: each net's distance to one
# process, relative to the length of one process's step, at most this.
# AdamW's first step moves nearly every weight by +-lr, so rounding moves
# only the few weights whose gradient is ~0 (one process's own two runs,
# cuDNN deterministic, read 0; dp=2 at half the batch reads 0.0128 for
# the generator, 3.5e-4 and 1.3e-5 for the MPD and MSD); the planted
# fault, a generator whose gradients are not averaged over dp, moves a
# large share (0.61) and must read above it
PAR_VOC_STEP_REL = 0.05


def worker_device(spec):
    """A rank's device: the CPU, or the card with TF32 off (as the parent
    runs)."""
    import torch

    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def _host(tree):
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in tree.items()}


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def collectives_check(rank, spec):
    """The mesh and its collectives on one rank of the group, on
    ``spec["device"]``: each rank's (dp, tp) position on a dp x tp mesh of
    the world (spec["tp"]), a store barrier used twice under one name,
    all_reduce and all_gather (staged through host memory on gloo with
    CUDA tensors) over each mesh axis and over the whole group (an axis
    of size 1 has no group: the world axis runs the backend's collectives
    at world size 1 too), and the gradients of copy_to, reduce_from and
    sum_over. Returns what each produced, as numpy, and the backend."""
    import torch
    import torch.distributed as dist

    from tts_king_torch.parallel import comm, lockstep
    from tts_king_torch.parallel.mesh import build_mesh

    device = worker_device(spec)
    mesh = build_mesh(dp=-1, tp=spec["tp"])
    for _ in range(2):
        lockstep.coordination_barrier("collectives_check")
    out = {"position": (mesh.dp_axis.index, mesh.tp_axis.index),
           "backend": dist.get_backend()}
    world = comm.Axis(dist.group.WORLD, dist.get_world_size(), rank)
    out["grouped"] = {}
    for name in ("dp", "tp", "world"):
        ax = world if name == "world" else mesh.axis(name)
        out["grouped"][name] = ax.group is not None
        x = torch.arange(3, dtype=torch.float32, device=device) + rank
        out[f"all_reduce_{name}"] = comm.all_reduce(x.clone(), ax).cpu()
        out[f"all_gather_{name}"] = torch.stack(
            comm.all_gather(x, ax)).cpu()
        # d/dx of sum(f(x) * (rank + 1)) through each autograd function
        for fn in ("copy_to", "reduce_from", "sum_over"):
            leaf = x.clone().requires_grad_(True)
            y = getattr(comm, fn)(leaf, ax)
            (y * (rank + 1)).sum().backward()
            out[f"{fn}_{name}"] = (y.detach().cpu(), leaf.grad.cpu())
    return {k: (tuple(t.numpy() for t in v) if isinstance(v, tuple)
                and hasattr(v[0], "numpy") else
                v.numpy() if hasattr(v, "numpy") else v)
            for k, v in out.items()}


def fs2_parallel_steps(rank, spec):
    """FastSpeech2 train steps of one rank of a dp x tp mesh (``spec["dp"]``
    None: one process, no mesh). The model: ``spec["model_cfg"]`` (a
    ModelConfig or a dict of its fields) with ``spec["variables"]`` (a flax
    tree or a state dict), ``stats`` and ``n_speakers``; dropout at the
    config's rates where ``spec["dropout"]``, else off. One optimizer step
    per global numpy superbatch of ``spec["superbatches"]``, each rank on
    its rows, dropout from step_generator(spec["seed"], i). ``spec["naive"]``
    replaces the global-batch loss by the average of each rank's own means
    (DDP's reduction; the tests' guard). Returns the losses of each step,
    the launch counts and, on rank 0, the full state after the last step
    (chip_smoke.compare_train_step's ``got``)."""
    import torch

    from tts_king_torch import config as pcfg
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.models.layers import Dropout
    from tts_king_torch.parallel.mesh import (build_mesh, shard_batch,
                                              shard_train_state,
                                              unshard_state_dict)
    from tts_king_torch.pipeline import _state_dict
    from tts_king_torch.train import step as step_mod
    from tts_king_torch.train.loop import step_generator
    from tts_king_torch.train.loss import FS2Losses
    from tts_king_torch.train.state import Optimizer, TrainState
    from tts_king_torch.weights import load_into

    device = worker_device(spec)
    mc = spec["model_cfg"]
    if isinstance(mc, dict):
        mc = pcfg._build(pcfg.ModelConfig, mc)
    opt_cfg = spec["opt_cfg"]
    if isinstance(opt_cfg, dict):
        opt_cfg = pcfg._build(pcfg.OptimizerConfig, opt_cfg)
    mesh = (build_mesh(dp=spec["dp"], tp=spec["tp"])
            if spec.get("dp") else None)
    with torch.device("meta"):
        model = build_fastspeech2(mc, spec["stats"], spec["n_speakers"])
    if not spec.get("dropout"):
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    model = load_into(model.to_empty(device=device),
                      _state_dict(spec["variables"]))
    optimizer = Optimizer(opt_cfg, mc.transformer.encoder_hidden)
    state = TrainState(model, optimizer.init(model))
    if mesh is not None:
        shard_train_state(state, mesh)
    exact = step_mod.forward_loss
    if spec.get("naive"):
        def naive(model, batch, generator, dp):
            own = exact(model, batch, generator)
            return FS2Losses(*(t / dp.size for t in own))

        step_mod.forward_loss = naive
    step = step_mod.make_train_step(optimizer, mesh)
    losses_each = []
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        for i, sb in enumerate(spec["superbatches"]):
            t = step_mod.to_device(sb, device)
            if mesh is not None:
                t = shard_batch(t, mesh, extra_leading_axis=True)
            losses = step(state, t, step_generator(spec["seed"], i, device))
            losses_each.append(dict(zip(losses._fields,
                                        (float(x) for x in losses))))
    finally:
        step_mod.forward_loss = exact
    _sync(device)
    out = {"losses_each": losses_each, "launches": launch_counts(),
           "wall_s": time.perf_counter() - t0}
    if mesh is not None:
        out["position"] = (mesh.dp_axis.index, mesh.tp_axis.index)
    sd, mu, nu = (state.model.state_dict(), state.opt_state.mu,
                  state.opt_state.nu)
    if mesh is not None:
        sd, mu, nu = (unshard_state_dict(t, mesh) for t in (sd, mu, nu))
    if rank == 0:
        out.update(losses=losses_each[-1], state_dict=_host(sd),
                   count=state.opt_state.count, mu=_host(mu), nu=_host(nu))
    return out


def compare_perturbed_step(got, want, pert, lr):
    """A port step (fs2_parallel_steps' result) against one process's step
    ``want``, where the step's arithmetic is reassociated throughout (tp's
    row-split products and their all-reduces): the losses at rtol 1e-4;
    each parameter, running stat and Adam moment within compare_train_step's
    bound or within twice the largest move of its kind between ``want``
    and ``pert``, one process's step from the same weights with one
    encoder weight perturbed by 1e-7 relative, whichever is larger. At the
    shipped width such a perturbation flips ReLU kinks in the variance
    predictors, which moves a few hundred of their weights by ~4e-3 lr
    (measured on the CPU: the same tensors and counts as tp=2's); a wrong
    reduction moves every weight downstream by a share of lr. Returns the
    largest error of each kind and its bound."""
    import numpy as np

    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-4, atol=1e-7,
                                   err_msg=f"loss {k}")
    out = {}
    for coll in ("state_dict", "mu", "nu"):
        top = max(float(np.abs(v).max()) for v in want[coll].values())
        move = max(float(np.abs(pert[coll][k] - v).max())
                   for k, v in want[coll].items())
        worst = 0.0
        for k, v in want[coll].items():
            if coll == "state_dict":
                stat = "running" in k
                rtol, atol = (1e-5, 1e-6) if stat else (0.0, 1e-3 * lr)
            else:
                rtol, atol = 1e-4, 1e-5 * top
            np.testing.assert_allclose(got[coll][k], v, rtol=rtol,
                                       atol=max(atol, 2 * move),
                                       err_msg=f"{coll} {k}")
            worst = max(worst, float(np.abs(got[coll][k] - v).max()))
        out[coll] = {"max_abs_err": worst, "perturbed_move": move}
    return out


def port_step_as_want(res):
    """A port step's result (fs2_parallel_steps) in the layout of a JAX
    one, for compare_train_step."""
    from tts_king_torch.weights import torch_to_flax

    tree = torch_to_flax(res["state_dict"])
    return {"losses": res["losses"], "params": tree["params"],
            "batch_stats": tree["batch_stats"], "count": res["count"],
            "mu": torch_to_flax(res["mu"])["params"],
            "nu": torch_to_flax(res["nu"])["params"]}


def time_sharded_vocode(rank, spec):
    """One rank's time-sharded vocoding (ops/time_parallel.py) over a dp
    mesh of every rank of the group, or, with ``spec["devices"]``, a
    single-process mesh over those devices. The Vocoder of ``spec["cfg"]``
    (``spec["variables"]``, ``spec["dtype"]``) on ``spec["mel"]``:
    ``spec["what"]`` "float" is vocoder_time_sharded on the generator (the
    mel as given, ``spec["halo"]`` or the configuration's family's
    receptive field),
    "int16" is Vocoder.generate_long. With ``spec["melgan"]`` (the
    MelGANGenerator's arguments) the generator is that MelGAN, "float"
    only. Returns the waveform (numpy) and the launch counts."""
    import numpy as np
    import torch

    from tts_king_torch.models.melgan import MelGANGenerator
    from tts_king_torch.ops.time_parallel import vocoder_time_sharded
    from tts_king_torch.parallel.mesh import build_mesh
    from tts_king_torch.pipeline import Vocoder, _state_dict, vocoder_family
    from tts_king_torch.weights import load_into

    device = worker_device(spec)
    cfg = spec["cfg"]
    if "melgan" in spec:
        with torch.device("meta"):
            gen = MelGANGenerator(**spec["melgan"])
        gen = load_into(gen.to_empty(device=device),
                        _state_dict(spec["variables"])).eval()
        up = int(np.prod(spec["melgan"]["ratios"]))
    else:
        voc = Vocoder(cfg, variables=spec["variables"],
                      dtype=getattr(torch, spec.get("dtype", "float32")),
                      device=device)
        gen, up = voc.model, int(np.prod(cfg.vocoder.upsample_rates))
    mesh = build_mesh(dp=-1, devices=spec.get("devices"))
    zero_launch_counts()
    t0 = time.perf_counter()
    if spec.get("what", "int16") == "int16":
        wav = voc.generate_long(spec["mel"], mesh)
    else:
        halo = spec.get("halo") or vocoder_family(
            cfg.model.vocoder_model).receptive_field(cfg.vocoder)
        with torch.inference_mode():
            wav = vocoder_time_sharded(
                gen, torch.from_numpy(spec["mel"]).to(device), mesh,
                halo_frames=halo, upsample=up)
            wav = wav[0].float().cpu().numpy()
    _sync(device)
    return {"wav": wav, "launches": launch_counts(),
            "wall_s": time.perf_counter() - t0}


def dp_generate(rank, spec):
    """AcousticModel.generate over a dp mesh of every rank of the group:
    ``spec["cfg"]``, ``spec["variables"]``, ``spec["n_speakers"]``, on
    ``spec["phonemes"]`` and ``spec["speakers"]``. Returns the mel lengths
    and the postnet mel (numpy), the whole batch on every rank."""
    from tts_king_torch.parallel.mesh import build_mesh
    from tts_king_torch.pipeline import AcousticModel

    device = worker_device(spec)
    am = AcousticModel(spec["cfg"], variables=spec["variables"],
                       n_speakers=spec["n_speakers"], device=device,
                       mesh=build_mesh(dp=-1))
    zero_launch_counts()
    t0 = time.perf_counter()
    out = am.generate(spec["phonemes"], speaker_name=spec["speakers"])
    _sync(device)
    return {"mel_lens": out["mel_lens"].cpu().numpy(),
            "postnet_mel": out["postnet_mel"].float().cpu().numpy(),
            "launches": launch_counts(), "wall_s": time.perf_counter() - t0}


def train_loop_runs(rank, spec):
    """train() of ``spec["cfg"]`` on one rank: each (restore_step, steps)
    of ``spec["runs"]`` in turn. Returns the launch counts of each run and,
    on rank 0, the metrics records."""
    from tts_king_torch.train.loop import train

    device = worker_device(spec)
    cfg = spec["cfg"]
    runs = []
    for restore, steps in spec["runs"]:
        cfg.acoustic.restore_step = restore
        zero_launch_counts()
        t0 = time.perf_counter()
        state = train(cfg, max_steps=steps, device=device)
        _sync(device)
        runs.append({"restore_step": restore, "steps": steps,
                     "step": state.step, "launches": launch_counts(),
                     "wall_s": time.perf_counter() - t0})
    out = {"runs": runs}
    if rank == 0:
        with open(os.path.join(cfg.train.result_path,
                               f"{cfg.exp_name}.metrics.jsonl")) as f:
            out["records"] = [json.loads(line) for line in f]
    return out


def vocoder_loop_run(rank, spec):
    """train_vocoder of ``spec["cfg"]`` on ``spec["wavs"]`` (the first two
    validate), data-parallel over the group where ``spec["distributed"]``:
    ``spec["steps"]`` steps, after a first run of one step and a resume
    where ``spec["first"]``. ``spec["fault"]`` plants a fault, the guard
    of the comparisons: the generator's gradients are not averaged over dp
    (each rank steps on its own rows). ``spec["deterministic"]``: cuDNN's
    deterministic algorithms, benchmark off, for the run. Returns the
    launch counts, and each net's (gen, mpd, msd) state digest on this rank
    after each run; on rank 0 also the metrics records, the final
    generator's state dict and, where ``spec["first"]``, every net's state
    dict after the first step (the generator's alone under a fault)."""
    import hashlib

    import torch

    from tts_king_torch.train import vocoder as vmod
    from tts_king_torch.train.vocoder_loop import train_vocoder

    device = worker_device(spec)
    cfg, wavs = spec["cfg"], spec["wavs"]
    runs = ([(None, 1), (1, spec["steps"])] if spec.get("first")
            else [(None, spec["steps"])])
    exact = vmod._mean_over
    calls = []

    def unreduced_gen(tensors, dp):
        # per step: the discriminators' gradients, then the generator's
        tensors = list(tensors)
        if len(tensors) > 1:
            calls.append(None)
            if len(calls) % 2 == 0:
                return tensors
        return exact(tensors, dp)

    if spec.get("fault") == "gen":
        vmod._mean_over = unreduced_gen
    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    if spec.get("deterministic"):
        cudnn.deterministic, cudnn.benchmark = True, False
    zero_launch_counts()
    t0 = time.perf_counter()
    out = {"digests": []}
    try:
        for restore, steps in runs:
            state = train_vocoder(cfg, wavs[2:], val_paths=wavs[:2],
                                  max_steps=steps, log_every=1,
                                  save_every=steps, restore_step=restore,
                                  device=device,
                                  distributed=spec.get("distributed", False),
                                  **spec.get("disc", {}))
            _sync(device)
            nets = {"gen": state.gen, "mpd": state.disc.mpd,
                    "msd": state.disc.msd}
            # every rank's nets must be the same after a dp step, the
            # spectral norms' power-iteration buffers included
            out["digests"].append({k: hashlib.sha1(b"".join(
                v.detach().cpu().numpy().tobytes() for v in
                m.state_dict().values())).hexdigest() for k, m in nets.items()})
            if rank == 0 and steps == 1:
                out["first"] = {k: _host(dict(m.named_parameters()))
                                for k, m in nets.items()
                                if k == "gen" or not spec.get("fault")}
    finally:
        vmod._mean_over = exact
        cudnn.deterministic, cudnn.benchmark = flags
    out.update(launches=launch_counts(), wall_s=time.perf_counter() - t0,
               step=state.step)
    if rank == 0:
        out["gen"] = _host(state.gen.state_dict())
        with open(os.path.join(cfg.train.result_path,
                               f"{cfg.exp_name}_vocoder.metrics.jsonl")) as f:
            out["records"] = [json.loads(line) for line in f]
    return out


def parallel_tasks(rank, tasks):
    """Several of the workers above in one process of a group, in turn:
    ``tasks`` is a list of (name, spec), every rank running them in one
    order. Returns {name: result}."""
    return {name: globals()[name.split(":")[0]](rank, spec)
            for name, spec in tasks}


def _width_state_dict(cfg):
    """The initial FastSpeech2 weights of train_state_at_width, as numpy."""
    import torch

    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.train.state import init_state_dict

    with torch.device("meta"):
        model = build_fastspeech2(cfg.model, WIDTH_STATS, 66)
    return {k: v.numpy() for k, v in
            init_state_dict(model, cfg.train.seed).items()}


def _max_errs(got, want):
    """Largest |got - want| of each kind between two fs2_parallel_steps
    results (rank 0's)."""
    import numpy as np

    out = {"loss_rel": max(abs(got["losses"][k] - v) / max(abs(v), 1e-30)
                           for k, v in want["losses"].items())}
    for key in ("state_dict", "mu", "nu"):
        out[key] = max(float(np.abs(got[key][k] - v).max())
                       for k, v in want[key].items())
    return out


def width_step_spec(cfg, device):
    """fs2_parallel_steps' spec of parts (a) and (b): train_state_at_width's
    weights, dropout on, the bench superbatch, one process (``dp`` None)."""
    import dataclasses

    opt = dataclasses.asdict(cfg.train.optimizer)
    # eps 1e-3 as compare_train_step's checks use: with Adam's 1e-9 a
    # weight whose gradient is rounding noise moves by a full lr either way
    opt["eps"] = 1e-3
    # a learning rate the parameter check can see (1e-3 of it, at f32
    # weights of order 0.1): the tests' warm-up of 4 steps
    opt["warm_up_step"] = 4
    spec = {"model_cfg": cfg.model, "opt_cfg": opt,
            "variables": _width_state_dict(cfg),
            "superbatches": [bench_train_superbatch()], "seed": 0,
            "dropout": True, "stats": WIDTH_STATS, "n_speakers": 66,
            "device": device, "dp": None, "tp": 1}
    return spec


def phase_parallel_path(smi, tmp, device="cuda:0"):
    """Data, tensor and sequence parallelism at the shipped width, on
    PAR_RANKS gloo processes sharing the one card (one launch, the parts in
    turn on every rank), then NCCL at world size 1, then a single-process
    mesh of two replicas on the card. Each part is held to one process:

      (a) a dp=2 FastSpeech2 step on the bench superbatch (acc 4 x 16,
          L = 96, T = 640; 8 rows a rank) from train_state_at_width's
          weights, dropout on: losses rtol 1e-4, parameters, Adam moments
          and BatchNorm stats at compare_train_step's tolerances, 40 flash
          launches each way a rank;
      (b) the same step at dp=1 x tp=2 (one head a rank): the losses and
          launches as (a), the state within compare_train_step's bound or
          twice one process's own move under a 1e-7 nudge of one weight
          (compare_perturbed_step: tp reassociates every FFT block's
          products, which flips ReLU kinks in the variance predictors);
      (c) Vocoder.generate_long over 2 ranks on one 4000-frame utterance
          (~46 s), f32 (row 2f) and bf16 (row 2), against Vocoder.generate
          of the whole and of the whole between halo zero frames (the
          time-sharded contract at the ends: mel-space zero padding): in
          f32 the interior within 1 LSB of the whole, and every sample
          within 1 LSB of the zero-halo pass (the streaming phase's bound:
          cuDNN may pick another algorithm at a window's length); in bf16,
          whose every conv rounds, the RMS error to the f32 pass within
          1.25 times the whole bf16 pass's, in the interior and at the
          ends; the ends against the whole pass reported (this mel sits at
          -5, so a zero frame is far from its frames, unlike the JAX
          test's N(0, 1) mel whose 0.2 bound assumes near ones);
      (d) train() on 2 ranks (4 steps of 16 x 4 on train_corpus_config's
          corpus, validation, checkpoints, a resume to 5) against one
          process: every train and val loss rtol 1e-4; train_vocoder on 2
          ranks (batch 8, the published discriminators, cuDNN
          deterministic; one step, a resume to 4) against one process run
          twice, by vocoder_dp_check: both ranks' nets equal, each net
          after the first step within PAR_VOC_STEP_REL of one process's
          step, a planted fault (the generator's gradients not averaged)
          above it, the first losses at 1e-5, the later losses reported
          beside one process's own spread;
      (e) NCCL at world size 1: collectives_check (NCCL's all_reduce and
          all_gather over the group, on the card) and train() for 2 steps
          through the distributed route, its losses at rtol 1e-4 of (d)'s
          one-process run's first two;
      (f) AcousticModel over a mesh of two replicas on the card against
          one device on a ragged batch of 6 (mel lengths equal, mels rtol
          1e-4 / atol 1e-5), and a SynthesisServer over that mesh against
          the single-device server on one batch of 8 requests: served
          mels at rtol 1e-4 / atol 1e-5 with equal lengths, and the wavs
          bit for bit where the mels are (else within the streaming
          phase's 1 LSB: FastSpeech2's half batch may round otherwise in
          cuBLAS's and cuDNN's algorithms for that shape; the witness,
          each replica's rows bit for bit one device's at the half
          batch, must hold);
      (g) a CWT FastSpeech2 (cwt_mesh_spec) on a batch of 5 over the 2
          gloo ranks and over a single-process mesh of dp = 2
          (cwt_mesh_check, which runs the padded batch whole on one
          device): the pitch standardized over the padded batch of 6, as
          one process on it.
    (b) runs again with attention_probs_bf16 (the kernels' mode at H = 1),
    held as (b) to one process with the flag, 40 mode launches each way a
    rank.

    Every rank zeroes the launch counts just before each part and reads
    them just after. Returns the launches of each kernel row."""
    import dataclasses

    import numpy as np
    import torch

    from tts_king_torch import config as pcfg
    from tts_king_torch.config import MeshConfig
    from tts_king_torch.data.synthetic import generate_corpus
    from tts_king_torch.parallel import launch
    from tts_king_torch.train.state import Optimizer

    cfg = main_config()
    t_phase = time.perf_counter()
    spec = width_step_spec(cfg, device)

    # (d)'s corpus and configs
    dcfg = train_corpus_config(os.path.join(tmp, "fs2"))
    one_cfg = dataclasses.replace(dcfg, train=dataclasses.replace(
        dcfg.train, ckpt_path=os.path.join(tmp, "one_ckpt"),
        result_path=os.path.join(tmp, "one_result")))
    par_cfg = dataclasses.replace(dcfg, mesh=MeshConfig(dp=PAR_RANKS))
    nccl_cfg = dataclasses.replace(dcfg, train=dataclasses.replace(
        dcfg.train, ckpt_path=os.path.join(tmp, "nccl_ckpt"),
        result_path=os.path.join(tmp, "nccl_result")))
    vcfg = main_config()
    vcfg.vocoder.batch_size = GAN_LOOP_BATCH
    raw = os.path.join(tmp, "wavs")
    generate_corpus(raw, **GAN_CORPUS)
    wavs = sorted(os.path.join(root, n) for root, _, names in os.walk(raw)
                  for n in names if n.endswith(".wav"))
    # train_vocoder's own (the published) discriminators, cuDNN's
    # deterministic algorithms on both sides: one step, a resume to 4
    voc_spec = {"cfg": vcfg, "wavs": wavs, "steps": TRAIN_STEPS,
                "first": True, "deterministic": True, "device": device}

    def voc_cfg(name):
        return dataclasses.replace(vcfg, train=dataclasses.replace(
            vcfg.train, ckpt_path=os.path.join(tmp, name),
            result_path=os.path.join(tmp, name + "_r")))

    long_mel = (np.random.RandomState(11).randn(1, PAR_LONG_FRAMES, 80)
                * 2.0 - 5.0).astype(np.float32)
    long_spec = {"cfg": cfg, "variables": None, "mel": long_mel,
                 "what": "int16", "device": device}

    # (b) with attention_probs_bf16: the kernels' mode at H = 1
    spec_p = dict(spec, model_cfg=probs_bf16_config(cfg).model)
    cwt = cwt_mesh_spec(cfg, device)
    tasks = [("collectives_check", {"tp": PAR_RANKS, "device": device}),
             ("fs2_parallel_steps:a", dict(spec, dp=PAR_RANKS, tp=1)),
             ("fs2_parallel_steps:b", dict(spec, dp=1, tp=PAR_RANKS)),
             ("fs2_parallel_steps:bp", dict(spec_p, dp=1, tp=PAR_RANKS)),
             ("dp_generate:cwt", cwt),
             ("time_sharded_vocode:f32", dict(long_spec, dtype="float32")),
             ("time_sharded_vocode:bf16", dict(long_spec, dtype="bfloat16")),
             ("train_loop_runs", {"cfg": par_cfg, "device": device,
                                  "runs": [(0, TRAIN_STEPS),
                                           (TRAIN_STEPS, TRAIN_STEPS + 1)]}),
             ("vocoder_loop_run", dict(voc_spec, distributed=True,
                                       cfg=voc_cfg("voc_par"))),
             ("vocoder_loop_run:fault", dict(
                 voc_spec, distributed=True, steps=1, first=False,
                 fault="gen", cfg=voc_cfg("voc_fault")))]
    t0 = time.perf_counter()
    ranks = launch.run(parallel_tasks, PAR_RANKS, (tasks,),
                       timeout_s=PAR_TIMEOUT_S, threads=0)
    launch_s = time.perf_counter() - t0
    walls = {name: [r[name].get("wall_s") for r in ranks]
             for name, _ in tasks}
    emit({"phase": "parallel_path", "part": "launch", "ranks": PAR_RANKS,
          "backend": "gloo", "device": device, "wall_s": launch_s,
          "task_wall_s": walls, "ok": True})

    check_collectives(ranks, PAR_RANKS, device)

    # (a), (b): against one process from the same weights and superbatch
    ref = fs2_parallel_steps(0, spec)
    lr = Optimizer(pcfg._build(pcfg.OptimizerConfig, spec["opt_cfg"]),
                   cfg.model.transformer.encoder_hidden).lr(0)
    tc = cfg.model.transformer
    per_step = (tc.encoder_layer + tc.decoder_layer) * TRAIN_ACC
    key = "encoder.layer_0.slf_attn.fc.weight"
    rng = np.random.RandomState(0)
    nudged = dict(spec["variables"])
    nudged[key] = (nudged[key] * (1 + 1e-7 * rng.standard_normal(
        nudged[key].shape))).astype(np.float32)
    pert = fs2_parallel_steps(0, dict(spec, variables=nudged))
    for part, name in (("a", "fs2_parallel_steps:a"),
                       ("b", "fs2_parallel_steps:b")):
        got = ranks[0][name]
        if any(r[name]["losses_each"] != got["losses_each"] for r in ranks):
            fail(f"parallel {part}: the ranks report other losses")
        if part == "a":
            compare_train_step(got, port_step_as_want(ref), lr,
                               loss_rtol=1e-4)
            bounds = None
        else:
            bounds = compare_perturbed_step(got, ref, pert, lr)
        per_rank = [r[name]["launches"] for r in ranks]
        if any(c["flash_fwd"] != per_step or c["flash_bwd"] != per_step
               for c in per_rank):
            fail(f"parallel {part}: flash launches {per_rank}, want "
                 f"{per_step} each way a rank")
        emit({"phase": "parallel_path", "part": part,
              "mesh": {"dp": PAR_RANKS, "tp": 1} if part == "a" else
              {"dp": 1, "tp": PAR_RANKS},
              "heads_per_rank": tc.encoder_head // (1 if part == "a"
                                                    else PAR_RANKS),
              "rows_per_rank": TRAIN_B // (PAR_RANKS if part == "a" else 1),
              "loss_total": got["losses"]["total"],
              "one_process_loss_total": ref["losses"]["total"],
              "max_err": _max_errs(got, ref), "perturbed_bounds": bounds,
              "wall_s": [r[name]["wall_s"] for r in ranks],
              "one_process_wall_s": ref["wall_s"],
              "launches": per_rank, "ok": True})

    # (b) with attention_probs_bf16 against one process with it
    ref_p = fs2_parallel_steps(0, spec_p)
    pert_p = fs2_parallel_steps(0, dict(spec_p, variables=nudged))
    got = ranks[0]["fs2_parallel_steps:bp"]
    if any(r["fs2_parallel_steps:bp"]["losses_each"] != got["losses_each"]
           for r in ranks):
        fail("parallel b probs_bf16: the ranks report other losses")
    bounds = compare_perturbed_step(got, ref_p, pert_p, lr)
    per_rank = [r["fs2_parallel_steps:bp"]["launches"] for r in ranks]
    if any(c["flash_fwd_probs_bf16"] != per_step
           or c["flash_bwd_probs_bf16"] != per_step
           or c["flash_fwd"] != per_step for c in per_rank):
        fail(f"parallel b probs_bf16: launches {per_rank}, want {per_step} "
             "mode launches each way a rank")
    emit({"phase": "parallel_path", "part": "b", "attention_probs_bf16": True,
          "mesh": {"dp": 1, "tp": PAR_RANKS},
          "heads_per_rank": tc.encoder_head // PAR_RANKS,
          "loss_total": got["losses"]["total"],
          "one_process_loss_total": ref_p["losses"]["total"],
          "max_err": _max_errs(got, ref_p), "perturbed_bounds": bounds,
          "wall_s": [r["fs2_parallel_steps:bp"]["wall_s"] for r in ranks],
          "launches": per_rank, "ok": True})

    # (c): against the whole utterance on one device
    from tts_king_torch.pipeline import Vocoder, vocoder_family

    hop = cfg.preprocess.stft.hop_length
    halo = vocoder_family(cfg.model.vocoder_model).receptive_field(cfg.vocoder)
    edge = halo * hop
    # the whole utterance on one device, and the whole utterance between
    # halo zero frames (the time-sharded contract at the sequence's ends:
    # mel-space zero padding), its centre
    pad_mel = np.pad(long_mel, ((0, 0), (halo, halo), (0, 0)))
    full, zero_halo = {}, {}
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        voc = Vocoder(cfg, dtype=dtype, device=device)
        full[dname] = voc.generate(long_mel)[0].astype(np.int32)
        zero_halo[dname] = voc.generate(pad_mel)[0][edge:-edge].astype(
            np.int32)

    def rms(a):
        return float(np.sqrt(np.mean(a.astype(np.float64) ** 2)))

    for dname in ("f32", "bf16"):
        name = f"time_sharded_vocode:{dname}"
        wav = ranks[0][name]["wav"].astype(np.int32)
        diff = np.abs(wav - full[dname])
        inner = diff[edge:-edge]
        # against the zero-halo pass everywhere, the ends included
        ends = np.abs(wav - zero_halo[dname])
        # bf16 rounds every conv's output, and cuDNN picks its algorithm by
        # the window's length: a window is another rounding of the same
        # bf16 computation, held to the whole bf16 pass's own error
        # against f32, in the interior and at the ends
        to_f32 = {"time_sharded": rms((wav - full["f32"])[edge:-edge]),
                  "whole": rms((full[dname] - full["f32"])[edge:-edge]),
                  "time_sharded_ends": rms(np.concatenate([
                      (wav - zero_halo["f32"])[:edge],
                      (wav - zero_halo["f32"])[-edge:]])),
                  "zero_halo_ends": rms(np.concatenate([
                      (zero_halo[dname] - zero_halo["f32"])[:edge],
                      (zero_halo[dname] - zero_halo["f32"])[-edge:]]))}
        per_rank = [r[name]["launches"] for r in ranks]
        ok = (wav.shape == full[dname].shape == (PAR_LONG_FRAMES * hop,)
              and all(np.array_equal(r[name]["wav"], wav) for r in ranks)
              and (int(inner.max()) <= 1 and int(ends.max()) <= 1
                   if dname == "f32" else
                   to_f32["time_sharded"] <= 1.25 * to_f32["whole"]
                   and to_f32["time_sharded_ends"]
                   <= 1.25 * to_f32["zero_halo_ends"])
              and all(c["mrf_stage"] == 3 for c in per_rank))
        emit({"phase": "parallel_path", "part": "c", "dtype": dname,
              "frames": PAR_LONG_FRAMES, "audio_s": len(wav) / 22050.0,
              "halo_frames": halo,
              "interior_max_lsb": int(inner.max()),
              "interior_frac_off": float(np.mean(inner > 0)),
              "zero_halo_max_lsb": int(ends.max()),
              "zero_halo_edge_max_lsb": int(max(ends[:edge].max(),
                                                ends[-edge:].max())),
              "edge_max_lsb_to_whole": int(max(diff[:edge].max(),
                                               diff[-edge:].max())),
              "rms_lsb_to_f32": to_f32,
              "wall_s": [r[name]["wall_s"] for r in ranks],
              "launches": per_rank, "ok": ok})
        if not ok:
            fail(f"parallel c {dname}: shape {wav.shape}, interior "
                 f"{int(inner.max())} LSB, zero-halo {int(ends.max())} LSB, "
                 f"rms to f32 {to_f32}, launches {per_rank}")

    # (d): train() and train_vocoder against one process
    t0 = time.perf_counter()
    one = train_loop_runs(0, {"cfg": one_cfg, "device": device,
                              "runs": [(0, TRAIN_STEPS),
                                       (TRAIN_STEPS, TRAIN_STEPS + 1)]})
    one_s = time.perf_counter() - t0
    got_recs = ranks[0]["train_loop_runs"]["records"]
    errs = _compare_records(got_recs, one["records"], "parallel d train()")
    per_rank = [[run["launches"] for run in r["train_loop_runs"]["runs"]]
                for r in ranks]
    for runs in per_rank:
        for run, n in zip(runs, (TRAIN_STEPS, 1)):
            if (run["flash_fwd"] != per_step * n
                    or run["flash_bwd"] != per_step * n):
                fail(f"parallel d: flash launches {per_rank}")
        if runs[0]["attention"] == 0:
            fail("parallel d: validation launched no attention kernel")
    emit({"phase": "parallel_path", "part": "d", "call": "train",
          "max_rel_err": errs,
          "val_total": [r["total"] for r in got_recs if r["phase"] == "val"],
          "wall_s": [[run["wall_s"] for run in r["train_loop_runs"]["runs"]]
                     for r in ranks], "one_process_wall_s": one_s,
          "launches": per_rank, "ok": True})
    # one process twice: the dp run's distance after one step is held to
    # the length of one process's step, beside one process's own spread
    voc_one = []
    for i in range(2):
        t0 = time.perf_counter()
        voc_one.append(vocoder_loop_run(0, dict(voc_spec,
                                                cfg=voc_cfg(f"voc_one{i}"))))
        voc_one_s = time.perf_counter() - t0
    voc_check = vocoder_dp_check(ranks, voc_one, voc_spec)
    emit({"phase": "parallel_path", "part": "d", "call": "train_vocoder",
          "batch": GAN_LOOP_BATCH, **voc_check,
          "wall_s": [r["vocoder_loop_run"]["wall_s"] for r in ranks],
          "one_process_wall_s": voc_one_s,
          "launches": [r["vocoder_loop_run"]["launches"] for r in ranks],
          "ok": True})

    # (e): NCCL at world size 1 through the distributed route
    # (a mesh axis of size 1 runs no collective: collectives_check's world
    # axis puts NCCL's all_reduce and all_gather on the card)
    t0 = time.perf_counter()
    nccl_tasks = [("collectives_check", {"tp": 1, "device": device}),
                  ("train_loop_runs", {"cfg": nccl_cfg, "device": device,
                                       "runs": [(0, 2)]})]
    nccl_all = launch.run(parallel_tasks, 1, (nccl_tasks,),
                          timeout_s=PAR_TIMEOUT_S, threads=0,
                          backend=("nccl" if torch.device(device).type
                                   == "cuda" else "gloo"))[0]
    nccl_s = time.perf_counter() - t0
    check_collectives([nccl_all], 1, device)
    nccl = nccl_all["train_loop_runs"]
    got = [r for r in nccl["records"] if r["phase"] == "train"]
    ref = [r for r in one["records"] if r["phase"] == "train"][:2]
    errs = _compare_records(got, ref, "parallel e NCCL train()")
    run = nccl["runs"][0]
    if run["step"] != 2 or run["launches"]["flash_fwd"] != 2 * per_step:
        fail(f"parallel e: {run}")
    emit({"phase": "parallel_path", "part": "e",
          "backend": nccl_all["collectives_check"]["backend"],
          "world_size": 1, "steps": 2, "max_rel_err": errs,
          "wall_s": nccl_s, "launches": run["launches"], "ok": True})

    # (f): a single-process mesh of two replicas on the card
    f_launches = parallel_replicas(cfg, device)
    # (g): the CWT model over the 2 gloo ranks and a single-process mesh
    g_launches = cwt_mesh_check(ranks, cwt, device)
    rows = _parallel_rows(ranks, nccl, f_launches, g_launches)
    emit({"phase": "parallel_path", "part": "done",
          "wall_s": time.perf_counter() - t_phase, "launches_by_row": rows,
          "nvidia_smi": smi, "ok": True})
    return rows


def check_collectives(results, n, device):
    """collectives_check's results on the ``n`` ranks of a dp=1 x tp=n
    mesh, rank r holding arange(3) + r: over tp and the world, the sum,
    every rank's tensor in rank order and sum_over's gradient (the sum of
    every rank's rank + 1); over dp (size 1, no group) the rank's own."""
    import numpy as np

    x = [np.arange(3, dtype=np.float32) + r for r in range(n)]
    for rank, res in enumerate(results):
        c = res["collectives_check"]
        ok = (np.array_equal(c["all_reduce_dp"], x[rank])
              and np.array_equal(c["all_gather_dp"], x[rank][None]))
        for name in ("tp", "world"):
            ok = ok and (
                np.array_equal(c[f"all_reduce_{name}"], sum(x))
                and np.array_equal(c[f"all_gather_{name}"], np.stack(x))
                and np.array_equal(c[f"sum_over_{name}"][1], np.full(
                    3, n * (n + 1) / 2, np.float32)))
        if not ok:
            fail(f"parallel collectives on {device} ({c['backend']}, {n} "
                 f"ranks): {c}")


def vocoder_dp_check(ranks, voc_one, spec):
    """Part (d)'s train_vocoder on 2 ranks (``ranks``' vocoder_loop_run
    and its planted fault, vocoder_loop_run's ``spec``) against one process
    run twice (``voc_one``), all from one seed on the same data:
      * both ranks' nets (parameters and spectral-norm buffers) equal
        after each run;
      * after the first step, each net's (generator, MPD, MSD) distance
        to one process over the length of one process's step at most
        PAR_VOC_STEP_REL, and the planted fault's generator above it;
      * the first step's losses at rtol 1e-5 (the same data and start).
    The later steps are reported, not held: the adversarial steps carry
    the first step's flipped weights on (the curves part by 3.5e-3 at
    step 4 while one process's own two runs are bit for bit equal), so
    what holds them to one process is the first step and the ranks'
    equality after the last. Returns the readings; fails on any miss."""
    import numpy as np

    from tts_king_torch.train.vocoder import VocoderTrainer

    got = ranks[0]["vocoder_loop_run"]
    fault = ranks[0]["vocoder_loop_run:fault"]
    want, again = voc_one
    if not got["step"] == want["step"] == spec["steps"]:
        fail(f"parallel d train_vocoder: steps {got['step']}, {want['step']}")
    vc = spec["cfg"].vocoder
    init = VocoderTrainer(vc, steps_per_epoch=1, device=spec["device"],
                          **spec.get("disc", {})).init_state(vc.seed)
    init = {k: _host(dict(m.named_parameters())) for k, m in
            (("gen", init.gen), ("mpd", init.disc.mpd),
             ("msd", init.disc.msd))}

    def rel(a, b, net):   # |a - b| / |b - init| over one net
        d = sum(float(np.sum((a[k].astype(np.float64) - v) ** 2))
                for k, v in b.items())
        step = sum(float(np.sum((v.astype(np.float64) - init[net][k]) ** 2))
                   for k, v in b.items())
        return float(np.sqrt(d / step))

    first = {net: rel(got["first"][net], want["first"][net], net)
             for net in init}
    own = {net: rel(again["first"][net], want["first"][net], net)
           for net in init}
    fault_rel = rel(fault["first"]["gen"], want["first"]["gen"], "gen")
    digests = [r["vocoder_loop_run"]["digests"] for r in ranks]
    ranks_equal = all(d == digests[0] for d in digests)
    fault_ranks_equal = all(r["vocoder_loop_run:fault"]["digests"]
                            == ranks[0]["vocoder_loop_run:fault"]["digests"]
                            for r in ranks)
    curves = {k: [[r[k] for r in rec["records"] if r["phase"] == "vocoder"]
                  for rec in (got, want, again)]
              for k in ("disc", "gen", "mel_l1")}
    first_losses = [(c[0][0], c[1][0]) for c in curves.values()]

    def curve_rel(i, j):
        return max(abs(a - b) / abs(b) for c in curves.values()
                   for a, b in zip(c[i], c[j]))

    # the generator after the last step, over the length of its whole run
    last = {"gen": rel({k: got["gen"][k] for k in init["gen"]},
                       {k: want["gen"][k] for k in init["gen"]}, "gen")}
    out = {"step1_rel_to_step": first, "step1_rel_own_spread": own,
           "last_step_rel_to_run": last,
           "step1_rel_fault_gen": fault_rel, "step1_bound": PAR_VOC_STEP_REL,
           "ranks_equal": ranks_equal, "fault_ranks_equal": fault_ranks_equal,
           "losses": curves, "max_rel_loss_err": curve_rel(0, 1),
           "own_max_rel_loss_spread": curve_rel(2, 1)}
    ok = (ranks_equal and max(first.values()) <= PAR_VOC_STEP_REL
          and fault_rel > PAR_VOC_STEP_REL and not fault_ranks_equal
          and all(np.isclose(a, b, rtol=1e-5, atol=0)
                  for a, b in first_losses))
    if not ok:
        fail(f"parallel d train_vocoder: {out}")
    return out


def _compare_records(got, want, what, keys=("total", "mel", "pitch",
                                            "energy", "duration")):
    """Metrics records of two runs, phase by phase, each loss at rtol
    1e-4; returns the largest relative error."""
    if [r["phase"] for r in got] != [r["phase"] for r in want]:
        fail(f"{what}: records {[r['phase'] for r in got]} vs "
             f"{[r['phase'] for r in want]}")
    worst = 0.0
    for a, b in zip(got, want):
        for k in keys:
            if k not in b:
                continue
            err = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
            if err > 1e-4:
                fail(f"{what}: {b['phase']} {k} {a[k]} vs {b[k]}")
            worst = max(worst, err)
    return worst


def parallel_replicas(cfg, device):
    """Part (f) of phase_parallel_path: FastSpeech2 inference and a
    SynthesisServer over a single-process mesh of two replicas on
    ``device`` against one device, with main_path_variables' weights.
    Returns the launch counts of the mesh's runs, summed."""
    import numpy as np
    import torch

    from tts_king_torch.parallel.mesh import build_mesh
    from tts_king_torch.pipeline import TTSKing
    from tts_king_torch.serve import SynthesisServer

    fs2_vars, voc_vars = main_path_variables(cfg)
    mesh = build_mesh(dp=2, devices=[device] * 2)
    one, par = (TTSKing(cfg, device=device, acoustic_variables=fs2_vars,
                        vocoder_variables=voc_vars, n_speakers=66, mesh=m)
                for m in (None, mesh))
    rng = np.random.RandomState(13)
    phonemes = rng.randint(1, 206, (6, 48))
    src_lens = rng.randint(16, 49, 6)
    speakers = list(rng.randint(0, 66, 6))
    t0 = time.perf_counter()
    zero_launch_counts()
    got = par.tts.generate(phonemes, speaker_name=speakers, src_lens=src_lens)
    torch.cuda.synchronize()
    am_launches = launch_counts()
    am_s = time.perf_counter() - t0
    want = one.tts.generate(phonemes, speaker_name=speakers,
                            src_lens=src_lens)
    lens_equal = torch.equal(got["mel_lens"], want["mel_lens"])
    mel_err = float((got["postnet_mel"] - want["postnet_mel"]).abs().max())
    close = torch.allclose(got["postnet_mel"], want["postnet_mel"],
                           rtol=1e-4, atol=1e-5)
    emit({"phase": "parallel_path", "part": "f", "call": "generate",
          "replicas": 2, "batch": 6, "mel_bucket": got["mel_bucket"],
          "mel_lens_equal": lens_equal, "mel_max_abs_err": mel_err,
          "wall_s": am_s, "launches": am_launches,
          "ok": lens_equal and close and am_launches["attention"] > 0})
    if not (lens_equal and close and am_launches["attention"] > 0):
        fail(f"parallel f generate: lengths equal {lens_equal}, mel err "
             f"{mel_err}, launches {am_launches}")

    requests = [(rng.randint(1, 206, 32), i % 3) for i in range(8)]

    def serve(king, return_wav=True):
        # one window of 8: the same batch on both servers
        server = SynthesisServer(king, max_batch=8, max_wait_ms=2000,
                                 policy="window", return_wav=return_wav)
        try:
            futures = [server.submit(phonemes=p, speaker=s)
                       for p, s in requests]
            return [f.result(timeout=120) for f in futures], list(
                server._trace_batches)
        finally:
            server.close()

    t0 = time.perf_counter()
    zero_launch_counts()
    wavs, trace = serve(par)
    torch.cuda.synchronize()
    srv_launches = launch_counts()
    srv_s = time.perf_counter() - t0
    ref, ref_trace = serve(one)
    # the served mels: FastSpeech2's rows at half the batch can round
    # otherwise in cuBLAS's and cuDNN's algorithms for that shape
    mels, mel_ref = serve(par, False)[0], serve(one, False)[0]
    lens_equal = all(a[1] == b[1] for a, b in zip(mels, mel_ref))
    mel_bitwise = lens_equal and all(np.array_equal(a[0], b[0])
                                     for a, b in zip(mels, mel_ref))
    mel_close = lens_equal and all(np.allclose(a[0], b[0], rtol=1e-4,
                                               atol=1e-5)
                                   for a, b in zip(mels, mel_ref))
    # the witness: each replica's rows of the batch are one device's at
    # that replica's batch of 4, bit for bit, so a difference from the
    # single-device server is the batch shape's rounding, not the mesh's
    batch = np.stack([p for p, _ in requests])
    spk = [s for _, s in requests]
    whole = par.tts.generate(batch, speaker_name=spk)
    half = len(requests) // 2
    witness = all(torch.equal(
        whole["postnet_mel"][i:i + half], one.tts.generate(
            batch[i:i + half], speaker_name=spk[i:i + half],
            max_mel_len=whole["mel_bucket"])["postnet_mel"])
        for i in (0, half))
    equal = [bool(np.array_equal(a, b)) for a, b in zip(wavs, ref)]
    lsb = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
              if a.shape == b.shape else -1 for a, b in zip(wavs, ref))
    # bit for bit where the mels are; else within the streaming phase's
    # 1 LSB (the same vocoder call on mels a few ulps apart)
    ok = (mel_close and witness
          and (all(equal) if mel_bitwise else 0 <= lsb <= 1)
          and srv_launches["attention"] > 0
          and srv_launches["mrf_stage"] > 0)
    emit({"phase": "parallel_path", "part": "f", "call": "SynthesisServer",
          "replicas": 2, "requests": len(requests), "batches": trace,
          "single_batches": ref_trace, "mel_lens_equal": lens_equal,
          "mels_bitwise_equal": mel_bitwise,
          "replica_rows_bitwise_one_device_at_half_batch": witness,
          "mel_max_abs_err": max(float(np.abs(a[0] - b[0]).max())
                                 for a, b in zip(mels, mel_ref)),
          "wavs_bitwise_equal": sum(equal), "max_lsb": lsb,
          "samples": [len(w) for w in wavs], "wall_s": srv_s,
          "launches": srv_launches, "ok": ok})
    if not ok:
        fail(f"parallel f server: mels close {mel_close} (bitwise "
             f"{mel_bitwise}; half-batch witness {witness}), {sum(equal)} "
             f"of {len(equal)} wavs bitwise "
             f"equal (max {lsb} LSB), launches {srv_launches}")
    return {k: am_launches[k] + srv_launches[k] for k in am_launches}


def cwt_mesh_spec(cfg, device):
    """dp_generate's spec of part (g): a CWT FastSpeech2 at ``cfg``'s width
    with main_path_variables' seeding, its pitch std head fixed at 1
    (kernel 0, bias 1: a random ReLU head gives a std of 0, and the batch
    would not matter), and a batch of 5 over dp = 2 (one pad row)."""
    import dataclasses

    import numpy as np

    from tts_king_torch.models.fs2 import build_fastspeech2

    ccfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_cwt=True))
    variables = seeded_flax_variables(
        lambda: build_fastspeech2(ccfg.model, MAIN_STATS, 66), seed=0)
    va = variables["params"]["variance_adaptor"]
    va["duration_predictor"]["linear_layer"]["kernel"] *= 0.1
    va["duration_predictor"]["linear_layer"]["bias"][:] = math.log(6.0)
    va["pitch_std"]["linear"]["kernel"][:] = 0.0
    va["pitch_std"]["linear"]["bias"][:] = 1.0
    rng = np.random.RandomState(17)
    return {"cfg": ccfg, "variables": variables, "n_speakers": 66,
            "phonemes": rng.randint(1, 206, (5, 40)),
            "speakers": [int(x) for x in rng.randint(0, 66, 5)],
            "device": device}


def cwt_mesh_check(ranks, spec, device):
    """Part (g) of phase_parallel_path: the CWT model of ``spec`` over the
    2 gloo ranks (``ranks``' "dp_generate:cwt": each rank its 3 rows of the
    batch of 5 padded to 6, the pitch standardized over both ranks' rows)
    and over a single-process mesh of dp = 2 on the card, against one
    process on the padded batch (the JAX mesh program's function: the zero
    pad row joins the standardization): lengths equal, mels rtol 1e-4 /
    atol 1e-5. The gloo ranks are the cross-replica check. A CWT model on
    a single-process mesh runs the padded batch whole on the model's
    device, the reference's own call, so its bit-for-bit match checks the
    pad rows and the whole batch on one device, not two replicas' work.
    The control: the unpadded batch on one device gives other mels.
    Returns the single-process mesh's launch counts."""
    import numpy as np
    import torch

    from tts_king_torch.parallel.mesh import build_mesh
    from tts_king_torch.pipeline import AcousticModel

    def model(mesh=None):
        return AcousticModel(spec["cfg"], variables=spec["variables"],
                             n_speakers=spec["n_speakers"], device=device,
                             mesh=mesh)

    ph, spk = spec["phonemes"], spec["speakers"]
    B, L = ph.shape
    one = model()
    padded = one.generate(np.concatenate([ph, np.zeros((1, L), ph.dtype)]),
                          speaker_name=spk + [0],
                          src_lens=[L] * B + [1])
    want_lens = padded["mel_lens"][:B].cpu().numpy()
    want = padded["postnet_mel"][:B].float().cpu().numpy()
    alone = one.generate(ph, speaker_name=spk)["postnet_mel"].float()
    zero_launch_counts()
    t0 = time.perf_counter()
    rep = model(build_mesh(dp=2, devices=[device] * 2)).generate(
        ph, speaker_name=spk)
    torch.cuda.synchronize()
    rep_s = time.perf_counter() - t0
    launches = launch_counts()
    got = {"ranks": [(r["dp_generate:cwt"]["mel_lens"],
                      r["dp_generate:cwt"]["postnet_mel"]) for r in ranks],
           "single_process_mesh": [(rep["mel_lens"].cpu().numpy(),
                                    rep["postnet_mel"].float().cpu().numpy())]}
    errs = {}
    for where, outs in got.items():
        for lens, mel in outs:
            if not np.array_equal(lens, want_lens) or not np.allclose(
                    mel, want, rtol=1e-4, atol=1e-5):
                fail(f"parallel g {where}: lengths {lens} vs {want_lens}, "
                     f"mel err {float(np.abs(mel - want).max())}")
            errs[where] = float(np.abs(mel - want).max())
    if errs["single_process_mesh"] != 0.0:
        fail(f"parallel g: the single-process mesh differs from one device "
             f"on the padded batch by {errs['single_process_mesh']}")
    control = float((alone.cpu() - torch.from_numpy(want)).abs().max())
    if np.allclose(alone.cpu().numpy(), want, rtol=1e-4, atol=1e-5):
        fail("parallel g: the pad row does not change the CWT mels")
    emit({"phase": "parallel_path", "part": "g", "use_cwt": True,
          "batch": B, "dp": 2, "mel_lens": [int(n) for n in want_lens],
          "max_abs_err": errs, "control_unpadded_max_abs_err": control,
          "single_process_mesh_checks": "the pad rows and the padded "
          "batch whole on one device (not a comparison of replicas: the "
          "ranks are)",
          "wall_s": {"ranks": [r["dp_generate:cwt"]["wall_s"]
                               for r in ranks],
                     "single_process_mesh": rep_s},
          "launches": {"ranks": [r["dp_generate:cwt"]["launches"]
                                 for r in ranks],
                       "single_process_mesh": launches},
          "ok": True})
    return launches


def _parallel_rows(ranks, nccl, replicas, cwt):
    """The parallel path's launches by kernel row, summed over its parts
    and ranks (``cwt``: part (g)'s single-process mesh)."""
    def tot(name, key):
        return sum(r[name]["launches"][key] for r in ranks)

    train = [run["launches"] for r in ranks
             for run in r["train_loop_runs"]["runs"]] + [
        nccl["runs"][0]["launches"]]
    flash = {k: (tot("fs2_parallel_steps:a", k)
                 + tot("fs2_parallel_steps:b", k)
                 + sum(t[k] for t in train)) for k in ("flash_fwd",
                                                       "flash_bwd")}
    attention = (sum(t["attention"] for t in train) + replicas["attention"]
                 + tot("dp_generate:cwt", "attention") + cwt["attention"])
    attention_bf16 = (sum(t["attention_bf16"] for t in train)
                      + replicas["attention_bf16"])
    return {"1": attention_bf16, "1f": attention - attention_bf16,
            "1p": 0,
            "2": tot("time_sharded_vocode:bf16", "mrf_stage"),
            "2f": (tot("time_sharded_vocode:f32", "mrf_stage")
                   + replicas["mrf_stage"]),
            "2b": 0, "3": flash,
            "3p": {k: tot("fs2_parallel_steps:bp", k)
                   for k in ("flash_fwd_probs_bf16", "flash_bwd_probs_bf16")}}


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
    # wall seconds of each phase, for the time limit (the done line)
    phase_s, t_mark = {}, [t_start]

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now

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
    mark("build")

    errs = phase_kernels_vs_plain()
    errs["mrf_stage_int8"] = phase_int8_vs_plain()
    errs["flash_attention"] = phase_flash_vs_plain()
    mark("kernel_vs_plain")
    probs_errs = phase_probs_bf16_vs_plain()
    mark("kernel_vs_plain_probs_bf16")
    phase_goldens()
    phase_int8_golden()
    phase_vocoders()
    t0 = time.perf_counter()
    losses, golden_errs = replay_train_step_golden(device="cuda")
    emit({"phase": "golden", "fixture": "golden_train_step",
          "loss_total": losses["total"], "max_err": golden_errs,
          "tol": "tests/test_torch_train.py (compare_train_step)",
          "seconds": time.perf_counter() - t0, "ok": True})
    mark("goldens")
    launches, mel_lens, mrf_runs, kings = phase_main_path()
    mark("main_path")
    serving_launches = phase_serving(kings, smi)
    del kings
    torch.cuda.empty_cache()
    mark("serving")
    int8_launches = phase_int8_vocoder(main_config())
    mark("int8_vocoder")
    train_launches = phase_train_path()
    mark("train_path")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_probs_")
    try:
        probs = phase_probs_bf16_path(smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    mark("probs_bf16_path")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cwt_")
    try:
        cwt_launches, raw, features = phase_cwt_path(smi, tmp)
        torch.cuda.empty_cache()
        mark("cwt_path")
        ft_launches = phase_finetune_path(smi, raw, features, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    mark("finetune_path")
    gan_launches = phase_gan_path(smi)
    torch.cuda.empty_cache()
    mark("gan_path")
    phase_train_step_time(smi)
    mark("train_step")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        par_launches = phase_parallel_path(smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    mark("parallel_path")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_validation_")
    try:
        phase_validation_tools(smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    mark("validation_tools")
    rows = phase_timing(main_config(), launches, train_launches, errs,
                        mel_lens, mrf_runs)
    attn, mrf_row = rows[0], rows[1]  # rows 1 and 1f, rows 2 and 2f
    # serving: both servers' FastSpeech2 computes in f32 (row 1f); the f32
    # server's vocoder runs row 2f, the bf16 server's row 2
    attn["launches_serving"] = {
        f"{d}_server": serving_launches[d]["attention_bf16"]
        for d in ("f32", "bf16")}
    attn["f32"]["launches_serving"] = {
        f"{d}_server": serving_launches[d]["attention"]
        - serving_launches[d]["attention_bf16"] for d in ("f32", "bf16")}
    mrf_row["launches_serving"] = serving_launches["bf16"]["mrf_stage"]
    mrf_row["f32"]["launches_serving"] = serving_launches["f32"]["mrf_stage"]
    for row, name in ((attn["f32"], "attention"),
                      (mrf_row["f32"], "mrf_stage")):
        # the CWT model's 3 speak calls and its training run (validation's
        # attention); all f32
        row["launches_cwt"] = {p: cwt_launches[p][name]
                               for p in ("speak", "train")}
    rows[-1]["launches_cwt"] = {k: cwt_launches["train"][k]
                                for k in ("flash_fwd", "flash_bwd")}
    # the GAN path's export check: one fused Generator call per dtype
    mrf_row["launches_gan"] = gan_launches["bf16"]
    mrf_row["f32"]["launches_gan"] = gan_launches["f32"]
    # the fine-tuning path (f32 but its export's bf16 call): attention in
    # the training run's validation and previews, make_base_mels and the
    # CLIs; the MRF passes in the previews, the export and the CLIs; flash
    # in the training steps
    stages = ("train", "base_mels", "train_vocoder", "synthesize",
              "evaluate")
    attn["f32"]["launches_finetune"] = {
        k: ft_launches[k]["attention"] for k in stages}
    mrf_row["f32"]["launches_finetune"] = {
        **{k: ft_launches[k]["mrf_stage"] for k in stages},
        "export": ft_launches["export"]["f32"]}
    mrf_row["launches_finetune"] = {"export": ft_launches["export"]["bf16"]}
    rows[-1]["launches_finetune"] = {k: ft_launches["train"][k]
                                     for k in ("flash_fwd", "flash_bwd")}
    # the parallel path (gloo ranks on the card, NCCL at world size 1,
    # replicas): FastSpeech2 in f32 (rows 1f, 3), the long utterance in
    # both dtypes (rows 2, 2f)
    attn["launches_parallel"] = par_launches["1"]
    attn["f32"]["launches_parallel"] = par_launches["1f"]
    mrf_row["launches_parallel"] = par_launches["2"]
    mrf_row["f32"]["launches_parallel"] = par_launches["2f"]
    rows[-1]["launches_parallel"] = par_launches["3"]
    rows.insert(2, int8_timing_row(main_config(), int8_launches,
                                   errs["mrf_stage_int8"]["bf16"]))
    rows[2]["launches_parallel"] = par_launches["2b"]
    # rows 1p and 3p: the kernels' bf16-probability mode
    rows.insert(1, attention_probs_timing_row(
        main_config(), probs["1p"], probs_errs["attention"],
        probs["mel_lens"]))
    rows[1]["launches_parallel"] = par_launches["1p"]
    rows.append(flash_timing_row(main_config(), probs["3p"],
                                 probs_errs["flash_attention"][0],
                                 probs_bf16=True))
    rows[-1]["launches_parallel"] = par_launches["3p"]
    rows.append(amp_act_timing_row(smi))
    rows.append(amp_mean_timing_row(smi))
    phase_amp_conv(smi)
    mark("kernels")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "phase_seconds": phase_s})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
