#!/usr/bin/env python3
"""Where BigVGAN-v2's generator spends its time on one CUDA card: each conv
kind of each stage (the AMP convs by kernel size and dilation, and the
transposed upsampler) at the bulk cell's shape (B 32, T_mel 1000), with the
cuDNN kernels it launched, under cuDNN's default heuristics and under
``torch.backends.cudnn.benchmark``; each dilated conv also folded by its
dilation (``ops/dilated_conv.py``, default heuristics, as the program
runs), with the fold's largest difference from the dilated conv and
whether ``dilated_conv.folds`` folds it. Then one whole generator call,
with the rule's folds and with none, and the AMP conv counters of a call
(``bigvgan.amp_conv_calls``, ``amp_conv_folded``). One JSON line each.
Other shapes by ``--batch`` and ``--frames``: a streaming window is B 1,
chunk + 2 halo frames (64 + 2 x 42).

    python3 scripts/probe_bigvgan.py [--batch 32] [--frames 1000] \
        [--stages 1 2 3] [--dtypes bf16 f32] [--no-generator]
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


def fold_record(conv, x):
    """The fold's ms, kernels and largest difference from the dilated conv
    (over the dilated conv's largest value)."""
    from tts_king_torch.ops import dilated_conv

    ref = conv(x).float()
    scale = float(ref.abs().max())
    fn = lambda: dilated_conv.dilated_conv1d(  # noqa: E731
        x, conv.weight, conv.bias, conv.dilation[0], conv.padding[0])
    return {"folded_ms": cuda_ms(fn), "folded_kernels": kernels_of(fn),
            "folded_rel_err": float((fn().float() - ref).abs().max())
            / scale}


def generator_calls(B, frames, dtype):
    """Generator ms with the rule's folds and with none; and the AMP conv
    counters of one call."""
    import torch

    from tts_king_torch.config import VocoderModelConfig
    from tts_king_torch.models import bigvgan
    from tts_king_torch.weights import load_into, seeded_state_dict

    v = VocoderModelConfig(
        upsample_rates=[4, 4, 2, 2, 2, 2],
        upsample_kernel_sizes=[8, 8, 4, 4, 4, 4],
        upsample_initial_channel=1536)
    with torch.device("meta"):
        gen = bigvgan.BigVGAN(v)
    gen = load_into(gen.to_empty(device="cuda"),
                    seeded_state_dict(gen, 0)).eval().to(dtype)
    mel = torch.randn(B, frames, 80, device="cuda")
    rule = bigvgan.folds
    with torch.no_grad():
        bigvgan.amp_conv_calls = bigvgan.amp_conv_folded = 0
        gen(mel)
        counts = {"calls": bigvgan.amp_conv_calls,
                  "folded": bigvgan.amp_conv_folded}
        for fold in ("rule", "none"):
            if fold == "none":
                bigvgan.folds = lambda *a: False
            try:
                print(json.dumps({"generator": [B, frames], "dtype": str(
                    dtype), "fold": fold, "amp_conv": counts,
                    "ms": cuda_ms(lambda: gen(mel), reps=5)}), flush=True)
            finally:
                bigvgan.folds = rule


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 2, 3, 4, 5, 6])
    ap.add_argument("--dtypes", nargs="+", default=["bf16"],
                    choices=["bf16", "f32"])
    ap.add_argument("--no-generator", action="store_true")
    args = ap.parse_args()
    import torch
    from torch import nn

    from tts_king_torch.ops import dilated_conv

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    B = args.batch
    for dname in args.dtypes:
        dtype = dtypes[dname]
        up = 1
        for i, (cin, c, k_up, u) in enumerate(STAGES):
            up *= u
            T = args.frames * up
            if i + 1 not in args.stages:
                continue
            x_in = torch.randn(B, cin, T // u, device=dev, dtype=dtype)
            x = torch.randn(B, c, T, device=dev, dtype=dtype)
            ups = nn.ConvTranspose1d(cin, c, k_up, stride=u,
                                     padding=(k_up - u) // 2)
            convs = {"ups": (ups, x_in)}
            for k in (3, 7, 11):
                for d in (1, 3, 5):
                    conv = nn.Conv1d(c, c, k, dilation=d,
                                     padding=(k * d - d) // 2)
                    convs[f"k{k}d{d}"] = (conv, x)
            for name, (conv, inp) in convs.items():
                conv = conv.to(dev, dtype)
                out = {"stage": [B, c, T], "conv": name, "dtype": dname}
                with torch.no_grad():
                    for bench in (False, True):
                        torch.backends.cudnn.benchmark = bench
                        key = "benchmark" if bench else "default"
                        out[f"{key}_ms"] = cuda_ms(lambda: conv(inp))
                        out[f"{key}_kernels"] = kernels_of(lambda: conv(inp))
                    torch.backends.cudnn.benchmark = False
                    if name != "ups" and conv.dilation[0] > 1:
                        out["rule_folds"] = dilated_conv.folds(
                            c, conv.kernel_size[0], conv.dilation[0], dtype)
                        out.update(fold_record(conv, inp))
                print(json.dumps(out), flush=True)
            del x, x_in
            torch.cuda.empty_cache()
        if not args.no_generator:
            generator_calls(B, args.frames, dtype)


if __name__ == "__main__":
    main()
