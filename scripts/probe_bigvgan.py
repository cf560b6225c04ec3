#!/usr/bin/env python3
"""Where BigVGAN-v2's generator spends its time on one CUDA card, with its
signals laid out as the generator holds them (``dilated_conv.laid_out``:
bf16 channels-last, f32 (B, C, T)): each conv kind of each stage (the AMP
convs by kernel size and dilation, and the transposed upsampler) at the
bulk cell's shape (B 32, T_mel 1000) as the generator runs it
(``ops/dilated_conv.py``: ms and the cuDNN kernels it launched, under
cuDNN's default heuristics, as the program runs), each dilated conv also
folded by its dilation, with the fold's largest difference from the
dilated conv and whether ``dilated_conv.folds`` folds it. Then one whole
generator call, with the rule's folds, with none and with the stage means
as PyTorch ops, and the counters of a call (``bigvgan.amp_conv_calls``,
``amp_conv_folded``; ``amp_act.launches``, ``bias_in``, ``residual_in``,
``mean_launches``). One JSON line each. ``--ops``: one generator
call under the profiler, its device time by the kernel and the chain of
operators and spans that launched it (innermost last), one line each.
Other shapes by ``--batch`` and ``--frames``: a streaming window is B 1,
chunk + 2 halo frames (64 + 2 x 42).

    python3 scripts/probe_bigvgan.py [--batch 32] [--frames 1000] \
        [--stages 1 2 3] [--dtypes bf16 f32] [--no-convs] [--no-generator] \
        [--ops]
"""

import argparse
import collections
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
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:90] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def conv_records(B, frames, stages, dtype, dname):
    """Each stage's convs on signals in their dtype's layout: ms and
    kernels, and for the dilated ones folded too."""
    import torch
    from torch import nn

    from tts_king_torch.ops import dilated_conv as dc

    dev = torch.device("cuda")
    up = 1
    for i, (cin, c, k_up, u) in enumerate(STAGES):
        up *= u
        T = frames * up
        if i + 1 not in stages:
            continue
        x_in = dc.laid_out(torch.randn(B, cin, T // u, device=dev,
                                       dtype=dtype))
        x = dc.laid_out(torch.randn(B, c, T, device=dev, dtype=dtype))
        ups = nn.ConvTranspose1d(cin, c, k_up, stride=u,
                                 padding=(k_up - u) // 2)
        convs = {"ups": (ups, x_in)}
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                convs[f"k{k}d{d}"] = (nn.Conv1d(c, c, k, dilation=d,
                                                padding=(k * d - d) // 2), x)
        for name, (conv, inp) in convs.items():
            conv = dc.lay_out_(conv.to(dev, dtype))
            w, b = conv.weight, conv.bias
            out = {"stage": [B, c, T], "conv": name, "dtype": dname}
            if name == "ups":
                fn = lambda: dc.conv_transpose1d(  # noqa: E731
                    inp, w, b, u, (k_up - u) // 2)
            else:
                d, p = conv.dilation[0], conv.padding[0]
                fn = lambda: dc.conv1d(inp, w, b, p, d)  # noqa: E731
            with torch.no_grad():
                out["ms"] = cuda_ms(fn)
                out["kernels"] = kernels_of(fn)
                if name != "ups" and d > 1:
                    ref = fn().float()
                    fold = lambda: dc.dilated_conv1d(  # noqa: E731
                        inp, w, b, d, p)
                    out["rule_folds"] = dc.folds(c, conv.kernel_size[0], d,
                                                 dtype)
                    out["folded_ms"] = cuda_ms(fold)
                    out["folded_kernels"] = kernels_of(fold)
                    out["folded_rel_err"] = float(
                        (fold().float() - ref).abs().max()) / float(
                        ref.abs().max())
            print(json.dumps(out), flush=True)
        del x, x_in
        torch.cuda.empty_cache()


def generator(dtype):
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
    return load_into(gen.to_empty(device="cuda"),
                     seeded_state_dict(gen, 0)).eval().to(dtype)


def generator_calls(B, frames, dtype):
    """Generator ms with the rule's folds, with none, and with the stage
    means as PyTorch ops (``chip_smoke.stage_mean_pytorch``) where the
    generator takes its blocks' parts (``bigvgan.amp_mean``); the AMP conv
    and activation counters of one call."""
    import torch

    from tts_king_torch.models import bigvgan
    from tts_king_torch.ops.kernels import amp_act

    gen = generator(dtype)
    mel = torch.randn(B, frames, 80, device="cuda")
    names = ("launches", "elements", "bias_in", "residual_in",
             "mean_launches")
    with torch.no_grad():
        gen(mel)
        before = (bigvgan.amp_conv_calls, bigvgan.amp_conv_folded,
                  *[getattr(amp_act, n, 0) for n in names])
        gen(mel)
        torch.cuda.synchronize()
        after = (bigvgan.amp_conv_calls, bigvgan.amp_conv_folded,
                 *[getattr(amp_act, n, 0) for n in names])
        counts = dict(zip(("calls", "folded", *names),
                          (a - b for a, b in zip(after, before))))
        variants = {"rule": {}, "none": {"folds": lambda *a: False}}
        if hasattr(bigvgan, "amp_mean"):
            from chip_smoke import stage_mean_pytorch
            variants["pytorch_mean"] = {"amp_mean": stage_mean_pytorch}
        for fold, patch in variants.items():
            saved = {k: getattr(bigvgan, k) for k in patch}
            for k, v in patch.items():
                setattr(bigvgan, k, v)
            try:
                gen(mel)
                print(json.dumps({"generator": [B, frames], "dtype": str(
                    dtype), "fold": fold, "counts": counts,
                    "ms": cuda_ms(lambda: gen(mel), reps=5)}), flush=True)
            finally:
                for k, v in saved.items():
                    setattr(bigvgan, k, v)


def op_split(B, frames, dtype, top=60):
    """One generator call under the profiler: device ms by (the chain of
    operators and spans above the launch, innermost last, the kernel)."""
    import torch

    gen = generator(dtype)
    mel = torch.randn(B, frames, 80, device="cuda")
    with torch.no_grad():
        gen(mel)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            gen(mel)
            torch.cuda.synchronize()
    split, device = collections.Counter(), collections.Counter()
    cpu_names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CPU}
    for e in prof.events():
        # the device side of a span (record_function) is no kernel
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.name not in cpu_names:
            device[e.name[:90]] += e.device_time_total
        for k in getattr(e, "kernels", []):
            chain, p = [], e
            while p is not None:
                if not p.name.startswith(("cuda", "cudnn")):
                    chain.append(p.name)
                p = p.cpu_parent
            split[(" > ".join(chain[::-1][-4:]), k.name[:90])] += k.duration
    # kernels that no operator launched (the port's, through ctypes)
    for name, us in device.items():
        left = us - sum(v for (_, k), v in split.items() if k == name)
        if left > 0.5:
            split[("(no operator)", name)] += left
    total = sum(split.values())
    print(json.dumps({"ops": [B, frames], "dtype": str(dtype),
                      "device_ms": total / 1e3}), flush=True)
    for (chain, kernel), us in split.most_common(top):
        print(json.dumps({"ms": round(us / 1e3, 3), "ops": chain,
                          "kernel": kernel}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 2, 3, 4, 5, 6])
    ap.add_argument("--dtypes", nargs="+", default=["bf16"],
                    choices=["bf16", "f32"])
    ap.add_argument("--no-convs", action="store_true")
    ap.add_argument("--no-generator", action="store_true")
    ap.add_argument("--ops", action="store_true")
    args = ap.parse_args()
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for dname in args.dtypes:
        dtype = dtypes[dname]
        if not args.no_convs:
            conv_records(args.batch, args.frames, args.stages, dtype, dname)
        if not args.no_generator:
            generator_calls(args.batch, args.frames, dtype)
        if args.ops:
            op_split(args.batch, args.frames, dtype)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
