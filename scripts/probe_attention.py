#!/usr/bin/env python3
"""The attention kernels (tts_king_torch/csrc/attention.cu, inference, and
flash_attention.cu, training) on one CUDA card: checked, then timed at the
main paths' shapes, optionally against other versions of the sources.

    python3 scripts/probe_attention.py [--attention OTHER.cu]
                                       [--flash OTHER.cu] [--checks-only]
                                       [--phases] [--mode-only]

Builds the repo's sources and prints nvcc's register and spill report for
each kernel, holds both kernels against their plain versions at
chip_smoke.py's ATTN_CHECKS and FLASH_CHECKS, then prints chip_smoke.py's
rows 1 and 3 (kernel, plain, SDPA and bound at the batched bf16 call, at
speak's f32 call and at the training decoder call). An OTHER.cu (from a
parent checkout, say) is built beside the repo's, held against the plain
versions at the same checks, and timed in turns with the repo's (repo,
other, other, repo) at those shapes, with each kernel's device time from
torch.profiler. ``--phases`` also builds the sources (and each OTHER.cu)
with ``-DTK_PROFILE_PHASES`` and prints each kernel's warp-cycles by phase,
each line naming its source (tile
wait, the products, the softmax or dS, the barrier; for the bf16-probability
mode's kernels, attention_round.cuh, ROUND_PHASES). The mode's cases (rows
1p and 3p: the f32 batched call, the training decoder call's forward and
backward) run with the rest; ``--mode-only`` runs only those, with the
mode's checks. OTHER.cu must have the repo's interface.
One JSON line per result.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = REPO


def build_all(jobs):
    """{key: (bind, name, src, out, extra nvcc flags)} compiled together,
    one nvcc a source; returns {key: bind(name, out)}."""
    from tts_king_torch.ops.kernels import _build

    procs = {key: (subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS,
                                     *extra, "-o", out, src],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True),
                   bind, name, src, out)
             for key, (bind, name, src, out, extra) in jobs.items()}
    libs = {}
    for key, (proc, bind, name, src, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        libs[key] = bind(name, out)
    return libs


def sdpa_f32_operator():
    """The f32 product of SDPA's memory-efficient kernels, from the installed
    PyTorch headers (mem_eff_attention/gemm_kernel_utils.h): the Operator
    line of DefaultGemmType's float specialization for sm80 and later."""
    import torch

    path = os.path.join(os.path.dirname(torch.__file__), "include", "ATen",
                        "native", "transformers", "cuda", "mem_eff_attention",
                        "gemm_kernel_utils.h")
    if not os.path.exists(path):
        return f"{path}: not installed"
    text = open(path).read()
    i = text.find("DefaultGemmType<\n    ArchTag,\n    float,")
    j = text.find("Operator", i)
    return text[j:text.find(";", j)] if i >= 0 and j >= 0 else "not found"


def ptxas(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln
            or "Performance" in ln or "warning" in ln]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--attention", help="another attention.cu")
    ap.add_argument("--flash", help="another flash_attention.cu")
    ap.add_argument("--checks-only", action="store_true")
    ap.add_argument("--phases", action="store_true",
                    help="also build with -DTK_PROFILE_PHASES and print "
                         "each kernel's cycles by phase")
    ap.add_argument("--mode-only", action="store_true",
                    help="only the bf16-probability mode: its checks, "
                         "rows 1p and 3p's cases and their phases")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("probe_attention: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from tts_king_torch.ops.kernels import _build
    from tts_king_torch.ops.kernels import attention as attn
    from tts_king_torch.ops.kernels import flash_attention as fa

    names = ("attention", "flash_attention")
    _build.build(names)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi_line(),
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "sdpa_f32_operator": sdpa_f32_operator(),
                      "ptxas": {n: ptxas(_build.build_log(n))
                                for n in names}}), flush=True)
    libs = {n: {"repo": _build.load(n)} for n in names}
    out_dir = os.path.join(REPO, "build", "probe_attention")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}   # every other build at once
    for name, other in zip(names, (args.attention, args.flash)):
        repo_src = os.path.join(_build.CSRC_DIR, _build.SOURCES[name])
        for which, src in (("other", other), ("repo", repo_src)):
            if other and which == "other":
                jobs[name, "other"] = (_build.bind, name, other, os.path.join(
                    out_dir, f"other_{name}.so"), ())
            if args.phases and src:
                jobs[name, "phases", which] = (
                    _build.bind, name, src, os.path.join(
                        out_dir, f"phases_{which}_{name}.so"),
                    ("-DTK_PROFILE_PHASES",))
    built = build_all(jobs)
    for name in names:
        if (name, "other") in built:
            libs[name]["other"] = built[name, "other"]

    def use(name, which):
        _build._libs[name] = libs[name][which]

    errs = {"probs_bf16": cs.phase_probs_bf16_vs_plain()}
    if not args.mode_only:
        errs.update(attention=cs.phase_attention_vs_plain(),
                    flash_attention=cs.phase_flash_vs_plain())
    print(json.dumps({"source": "repo", "max_abs_err": errs}), flush=True)
    if args.checks_only:
        return 0
    for name, fn in zip(names, (cs.phase_attention_vs_plain,
                                cs.phase_flash_vs_plain)):
        for which in libs[name]:
            if which != "repo":
                use(name, which)
                print(json.dumps({"source": which, "kernel": name,
                                  "max_abs_err": fn()}), flush=True)
        use(name, "repo")

    cfg = cs.main_config()
    tc = cfg.model.transformer
    H, D = tc.decoder_head, tc.decoder_hidden // tc.decoder_head
    # the batched decoder call's mel lengths: 516-540 frames (PERF.md)
    mel_lens = np.random.RandomState(0).randint(516, 541, size=cs.BENCH_B)
    none = dict.fromkeys(cs.launch_counts(), 0)
    if not args.mode_only:
        print(json.dumps({"row": cs.attention_timing_row(
            cfg, none, errs["attention"], mel_lens)}), flush=True)
        print(json.dumps({"row": cs.flash_timing_row(
            cfg, none, errs["flash_attention"])}), flush=True)

    cases = {}
    for dname, dtype, B, T, lens in (
            ("bf16", torch.bfloat16, cs.BENCH_B, cs.BENCH_T, mel_lens),
            ("f32", torch.float32, 1, cs.SPEAK_T, [cs.SPEAK_LEN]),
    )[:0 if args.mode_only else 2]:
        (q, k, v), _ = cs.attention_inputs(B, H, T, D, dtype, seed=7)
        mask = torch.from_numpy(np.arange(T)[None] >=
                                np.asarray(lens)[:, None]).cuda()
        additive = torch.zeros((B, 1, 1, T), dtype=dtype, device="cuda")
        additive.masked_fill_(mask[:, None, None, :], -1e9)
        cases[f"attention {dname} {[B, H, T, D]}"] = (
            "attention", lambda q=q, k=k, v=v, m=mask: attn.attention(
                q, k, v, m))
        cases[f"sdpa {dname} {[B, H, T, D]}"] = (
            None, lambda q=q, k=k, v=v, m=additive:
            F.scaled_dot_product_attention(q, k, v, attn_mask=m))
    # row 1p: the bf16-probability mode at the batched call's shape, f32
    (q1, k1, v1), _ = cs.attention_inputs(cs.BENCH_B, H, cs.BENCH_T, D,
                                          torch.float32, seed=7)
    mask1 = torch.from_numpy(np.arange(cs.BENCH_T)[None] >=
                             np.asarray(mel_lens)[:, None]).cuda()
    case = f"attention probs_bf16 f32 {[cs.BENCH_B, H, cs.BENCH_T, D]}"
    cases[case] = ("attention", lambda: attn.attention(q1, k1, v1, mask1,
                                                       probs_bf16=True))
    B, T = cs.TRAIN_B, cs.TRAIN_T
    lens = cs.bench_train_superbatch()["mel_lens"][0]
    (q, k, v), mask, g = cs.flash_inputs(B, H, T, D, seed=11, lens=lens)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    saved = fa._forward_cuda(qd, kd, vd, mask)
    g = fa._out_like(qd).copy_(g)
    if not args.mode_only:
        cases[f"flash fwd {[B, H, T, D]}"] = (
            "flash_attention", lambda: fa._forward_cuda(qd, kd, vd, mask))
        cases[f"flash bwd {[B, H, T, D]}"] = (
            "flash_attention",
            lambda: fa._backward_cuda(qd, kd, vd, mask, *saved, g))
    # row 3p: the mode's forward and backward at the same call
    saved_p = fa._forward_cuda(qd, kd, vd, mask, True)
    cases[f"flash fwd probs_bf16 {[B, H, T, D]}"] = (
        "flash_attention",
        lambda: fa._forward_cuda(qd, kd, vd, mask, True))
    cases[f"flash bwd probs_bf16 {[B, H, T, D]}"] = (
        "flash_attention",
        lambda: fa._backward_cuda(qd, kd, vd, mask, *saved_p, g))
    for case, (name, fn) in cases.items():
        alts = [w for w in libs[name] if w != "repo"] if name else []
        order = ["repo", *alts, *alts[::-1], "repo"] if alts else ["repo"]
        ms, device = {}, {}
        for which in order:
            if name:
                use(name, which)
            ms.setdefault(which, []).append(
                cs.cuda_ms(fn, warmup=3, reps=args.reps))
            device.setdefault(which, device_ms(fn, args.reps))
        if name:
            use(name, "repo")
        print(json.dumps({"case": case, "ms": ms, "device_ms": device}),
              flush=True)

    if args.phases:
        counts = (ctypes.c_ulonglong * 32)()
        for key, lib in built.items():
            if key[1] == "phases":
                lib.tk_attn_phase_cycles.argtypes = [ctypes.c_void_p]
                libs[key[0]]["phases " + key[2]] = lib
        for case, (name, fn) in cases.items():
            for which in ("repo", "other"):
                if not name or "phases " + which not in libs[name]:
                    continue
                lib = libs[name]["phases " + which]
                use(name, "phases " + which)
                fn()
                torch.cuda.synchronize()
                _build.check(lib, lib.tk_attn_phase_cycles(counts), "phases")
                fn()
                torch.cuda.synchronize()
                _build.check(lib, lib.tk_attn_phase_cycles(counts), "phases")
                use(name, "repo")
                names_ = ROUND_PHASES if "probs_bf16" in case else PHASES
                for part, lo in (("", 0), (" dK/dV", 8), (" producer", 16),
                                 (" dK/dV producer", 24)):
                    c = list(counts)[lo:lo + 8]
                    if sum(c):
                        print(json.dumps({
                            "case": case + part, "source": which,
                            "warp_gcycles": sum(c) / 1e9,
                            "share": {p: x / sum(c) for p, x in zip(
                                names_[lo:lo + 8], c) if x}}), flush=True)
    return 0


# The phase marks of TK_PROFILE_PHASES (csrc/attention_mma.cuh); the dK/dV
# kernel's take slots 8-15.
PHASES = ["prologue", "wait_tile", "products_1", "softmax_or_ds",
          "products_2", "sync", "epilogue", "all_padded_exit"] * 2
# attention_round.cuh's marks: the consumers of the forward and dQ (slots
# 0-7) and of dK/dV (8-15), the producer warpgroups of the forward and dQ
# (16-23) and of dK/dV (24-31). "issue" is the wgmma issue, "products" the
# wait for them to finish, "under_products" the scratch reads and writes
# between the two.
ROUND_PHASES = ["prologue", "wait_planes", "issue", "products",
                "pass1_softmax_or_delta", "pass2_probs_or_ds", "epilogue",
                "under_products",
                "prologue", "wait_planes", "fragments", "issue", "products",
                "epilogue", "wait_stage", "all_padded_exit",
                "prologue", "wait_raw", "wait_plane_empty", "split",
                "sync_issue", "fence", "-", "-",
                "prologue", "wait_raw", "wait_plane_empty", "split",
                "sync_issue", "fence", "-", "-"]


def device_ms(fn, reps):
    """Device ms per call of each kernel ``fn`` launches, from
    torch.profiler (CUDA events time the host's enqueue too when it is the
    slower side)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if t > 0:
            out[ev.key[:60]] = t / 1e3 / reps
    return out


if __name__ == "__main__":
    sys.exit(main())
