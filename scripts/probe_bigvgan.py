#!/usr/bin/env python3
"""Where BigVGAN-v2's generator spends its time on one CUDA card: each conv
kind of each stage (the AMP convs by kernel size and dilation, and the
transposed upsampler) in bf16 at the bulk cell's shape (B 32, T_mel 1000),
with the cuDNN kernels it launched, under cuDNN's default heuristics and
under ``torch.backends.cudnn.benchmark``; then one whole generator call
both ways. One JSON line each.

    python3 scripts/probe_bigvgan.py [--batch 32] [--frames 1000] \
        [--stages 1 2 3] [--no-generator]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = [(1536, 768, 8, 4), (768, 384, 8, 4), (384, 192, 4, 2),
          (192, 96, 4, 2), (96, 48, 4, 2), (48, 24, 4, 2)]


def cuda_ms(fn, reps=5):
    import torch

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


def kernels_of(fn):
    """The device kernels one call of ``fn`` launched, by name (cut)."""
    import torch

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:90] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 2, 3, 4, 5, 6])
    ap.add_argument("--no-generator", action="store_true")
    args = ap.parse_args()
    import torch
    from torch import nn

    from tts_king_torch.config import VocoderModelConfig
    from tts_king_torch.models.bigvgan import BigVGAN
    from tts_king_torch.weights import load_into, seeded_state_dict

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    B, up = args.batch, 1
    for i, (cin, c, k_up, u) in enumerate(STAGES):
        up *= u
        T = args.frames * up
        if i + 1 not in args.stages:
            continue
        x_in = torch.randn(B, cin, T // u, device=dev, dtype=bf16)
        x = torch.randn(B, c, T, device=dev, dtype=bf16)
        convs = {"ups": (nn.ConvTranspose1d(cin, c, k_up, stride=u,
                                            padding=(k_up - u) // 2), x_in)}
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                convs[f"k{k}d{d}"] = (nn.Conv1d(c, c, k, dilation=d,
                                                padding=(k * d - d) // 2), x)
        for name, (conv, inp) in convs.items():
            conv = conv.to(dev, bf16)
            out = {"stage": [B, c, T], "conv": name}
            with torch.no_grad():
                for bench in (False, True):
                    torch.backends.cudnn.benchmark = bench
                    key = "benchmark" if bench else "default"
                    out[f"{key}_ms"] = cuda_ms(lambda: conv(inp))
                    out[f"{key}_kernels"] = kernels_of(lambda: conv(inp))
            torch.backends.cudnn.benchmark = False
            print(json.dumps(out), flush=True)
        del x, x_in
        torch.cuda.empty_cache()
    if args.no_generator:
        return
    v = VocoderModelConfig(
        upsample_rates=[4, 4, 2, 2, 2, 2],
        upsample_kernel_sizes=[8, 8, 4, 4, 4, 4],
        upsample_initial_channel=1536)
    with torch.device("meta"):
        gen = BigVGAN(v)
    gen = load_into(gen.to_empty(device=dev),
                    seeded_state_dict(gen, 0)).eval().to(bf16)
    mel = torch.randn(B, args.frames, 80, device=dev)
    with torch.no_grad():
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            print(json.dumps({"generator": [B, args.frames],
                              "cudnn_benchmark": bench,
                              "ms": cuda_ms(lambda: gen(mel), reps=3)}),
                  flush=True)


if __name__ == "__main__":
    main()
