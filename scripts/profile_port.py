#!/usr/bin/env python3
"""Where the time goes in the port's main paths, on one CUDA card.

Batched synthesis (the default): chip_smoke.py's batched bf16 call, the
form of the JAX bench: FastSpeech2 built and run in bf16
(``chip_smoke.bench_fs2``, shipped width, seeded weights, 66 speakers) at
the bench shape (B=32, L=128, T_mel=1000), then the bf16 Vocoder on its
mel.
Training (``--train``): one f32 optimizer step of TTSConfig()'s
FastSpeech2 at the superbatch of bench.py:286-301 (acc 4 x B 16, L = 96,
T = 640), after two warm-up steps, as chip_smoke.py times it. The int8
vocoder (``--int8``): TTSConfig()'s Generator(mrf_backend="fused_int8")
in bf16 on a mel of B = 8, T_mel = 1000 (config 2b of bench.py:218-240),
as chip_smoke.py times it. A sentence (``--speak``): the f32 TTSKing's
``speak`` on chip_smoke.py's 192-frame sentence (TF32 off), as chip_smoke.py
drives it. Serving (``--serve f32|bf16``): a SynthesisServer (max_batch 16,
prewarmed) on that TTSKing serves chip_smoke.py's serving burst (32
requests in f32, 48 in bf16) per run; the device's idle share over a burst
says how far the host and the pipeline's waits hold the card back. GAN
training (``--gan [f32|bf16]``): one HiFi-GAN step of VocoderTrainer at
TTSConfig()'s width on chip_smoke.py's GAN batch (B = 16 x 8192 samples,
bench.py:350-399), f32 with TF32 off or with compute_dtype bf16; beside the
profile, the peak memory of the profiled step.

After two warm-up runs, ``--reps`` runs are timed without the profiler
(host clock, synchronized), then one run is profiled under
``torch.profiler`` with CPU and CUDA activities. Prints one JSON line: the
timed runs' wall times and median, the profiled run's wall time, the
device's busy time (the sum of kernel times: one stream, so kernels do not
overlap), its idle share, and the device time by operator and by kernel,
largest first. The full tables and a Chrome trace go to ``--out``.

    python3 scripts/profile_port.py [--train | --int8 | --speak |
        --serve f32|bf16 | --gan [f32|bf16]] [--reps N] [--out DIR]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repo root in place of scripts/, whose profile.py would shadow the
# standard library's profile module that torch imports
sys.path[0] = REPO


def _device_us(evt, self_time):
    names = (("self_device_time_total", "self_cuda_time_total") if self_time
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "profile_port"))
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--reps", type=int, default=5)
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--train", action="store_true",
                      help="profile one optimizer step instead of synthesis")
    what.add_argument("--int8", action="store_true",
                      help="profile the int8 vocoder instead of synthesis")
    what.add_argument("--speak", action="store_true",
                      help="profile TTSKing.speak on one sentence (f32)")
    what.add_argument("--serve", choices=("f32", "bf16"),
                      help="profile a burst through SynthesisServer")
    what.add_argument("--gan", nargs="?", const="f32", choices=("f32", "bf16"),
                      help="profile one HiFi-GAN training step")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    if args.train:
        # the training step is f32, as chip_smoke.py times it
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        from tts_king_torch.train.loop import step_generator
        from tts_king_torch.train.step import make_train_step, to_device

        state, optimizer = chip_smoke.train_state_at_width()
        step = make_train_step(optimizer)
        sb = to_device(chip_smoke.bench_train_superbatch(), "cuda")
        shape = {"acc": chip_smoke.TRAIN_ACC, "B": chip_smoke.TRAIN_B,
                 "L": chip_smoke.TRAIN_L, "T": chip_smoke.TRAIN_T,
                 "dtype": "f32"}

        def run():
            return step(state, sb, step_generator(0, state.step, "cuda"))
    elif args.int8:
        cfg = chip_smoke.main_config()
        gen = chip_smoke.shipped_generator(cfg, "fused_int8", torch.bfloat16)
        B, T = chip_smoke.INT8_B, chip_smoke.INT8_T
        mel = torch.randn((B, T, cfg.vocoder.num_mels), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(2))
        shape = {"B": B, "T_mel": T, "dtype": "bf16"}

        @torch.inference_mode()
        def run():
            return gen(mel)
    elif args.speak:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = chip_smoke.main_config()
        cfg.preprocess.lexicon_path = os.path.join(chip_smoke.E2E_DIR,
                                                   "lexicon.dict")
        king = chip_smoke.main_path_kings(cfg)["f32"]
        text = chip_smoke.SENTENCES[1]
        shape = {"text": text, "dtype": "f32"}

        def run():
            return king.speak(text)
    elif args.serve:
        from tts_king_torch.serve import SynthesisServer

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = chip_smoke.main_config()
        cfg.preprocess.lexicon_path = os.path.join(chip_smoke.E2E_DIR,
                                                   "lexicon.dict")
        king = chip_smoke.main_path_kings(cfg)[args.serve]
        server = SynthesisServer(king, max_batch=16)
        server.prewarm(max_phonemes=chip_smoke.SERVE_MAX_PHONEMES,
                       duration_controls=chip_smoke.SERVE_CONTROLS)
        requests = chip_smoke.serve_requests(
            king, 32 if args.serve == "f32" else 48, seed=5)
        shape = {"requests": len(requests), "max_batch": 16,
                 "dtype": args.serve}

        def run():
            return chip_smoke.serve_burst(server, requests)
    elif args.gan:
        from tts_king_torch.train.vocoder import VocoderTrainer

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = chip_smoke.main_config()
        trainer = VocoderTrainer(
            cfg.vocoder, device="cuda",
            compute_dtype=torch.bfloat16 if args.gan == "bf16" else None)
        gan_state = trainer.init_state(cfg.vocoder.seed)
        gan_step = trainer.make_train_step()
        batch = chip_smoke.gan_bench_batch(cfg)
        shape = {"B": chip_smoke.GAN_B, "segment": cfg.vocoder.segment_size,
                 "dtype": args.gan}

        def run():
            return gan_step(gan_state, batch)
    else:
        from tts_king_torch.pipeline import Vocoder

        cfg = chip_smoke.main_config()
        fs2 = chip_smoke.bench_fs2(cfg)
        voc = Vocoder(cfg, variables=chip_smoke.main_path_variables(cfg)[1],
                      dtype=torch.bfloat16, device="cuda")
        phonemes, speakers = chip_smoke.bench_batch()
        B, L, T = chip_smoke.BENCH_B, chip_smoke.BENCH_L, chip_smoke.BENCH_T
        bench_in = (torch.tensor(speakers, device="cuda"),
                    torch.from_numpy(phonemes).cuda(),
                    torch.full((B,), L, dtype=torch.int32, device="cuda"))
        shape = {"B": B, "L": L, "T_mel": T, "fs2": "bench_fs2 (bf16)",
                 "vocoder": "bf16"}

        def run():
            with torch.inference_mode():
                return voc(fs2(*bench_in, max_mel_len=T)["postnet_mel"])

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    runs_ms = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        runs_ms.append((time.perf_counter() - t0) * 1e3)

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_kernel = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    ops = [(evt.key, _device_us(evt, True) / 1e3, evt.count)
           for evt in prof.key_averages()]
    ops = sorted((o for o in ops if o[1] > 0), key=lambda o: -o[1])

    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=60))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "path": ("train_step" if args.train else
                 "int8_vocoder" if args.int8 else
                 "speak" if args.speak else
                 "serve" if args.serve else
                 "gan_step" if args.gan else "synthesis"),
        "shape": shape,
        "wall_ms_runs": runs_ms,
        "wall_ms_median": sorted(runs_ms)[len(runs_ms) // 2] if runs_ms
        else None,
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "n_kernels": len(kernels),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "top_ops_self_device_ms": [[k, round(ms, 3), n]
                                   for k, ms, n in ops[:args.top]],
        "top_kernels_ms": sorted(([k[:90], round(ms, 3)] for k, ms in
                                  by_kernel.items()),
                                 key=lambda r: -r[1])[:args.top],
        **({"formed_batches": list(server._trace_batches)}
           if args.serve else {}),
    }), flush=True)
    if args.serve:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
