#!/usr/bin/env python3
"""The int8 MRF kernel (tts_king_torch/csrc/mrf_stage_int8.cu) on one CUDA
card, at config 2b's fused stages (B = 8, T_mel = 1000, bf16, the seeded
stage weights of chip_smoke.int8_stage_inputs).

    python3 scripts/probe_mrf_int8.py [--phases] [OTHER.cu ...]

Times the kernel per stage. ``--phases`` also builds the source with
``-DTK_PROFILE_PHASES``, whose marks add each block's cycles per phase
(x load and max, taps and scales staged, quantization, warp 0's products,
warp 0's epilogue, the block max, the branch mean), and prints each phase's
share of the block-cycles. Each OTHER.cu, another version of the source
(from a parent checkout, say), is built beside the repo's, held against the
plain version at chip_smoke.py's int8 checks, and timed per stage in turns
with the repo's: repo, others, others, repo. One JSON line per result.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = REPO

PHASES = ["x_load", "taps", "quantize", "products_w0", "epilogue_w0",
          "block_max", "branch_mean"]


def build(src, out, extra=()):
    from tts_king_torch.ops.kernels import _build

    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *extra,
                           "-o", out, src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", help="other versions of the source")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_mrf_int8: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tts_king_torch.ops.kernels import _build, mrf_int8

    out_dir = os.path.join(REPO, "build", "probe_mrf_int8")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build.CSRC_DIR, _build.SOURCES["mrf_stage_int8"])
    libs = {"repo": _build.load("mrf_stage_int8")}
    for i, other in enumerate(args.others):
        libs[other] = build(other, os.path.join(out_dir, f"other{i}.so"))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi_line()}), flush=True)

    def use(lib):
        _build._libs["mrf_stage_int8"] = lib

    for name in args.others:
        use(libs[name])
        err = cs.phase_int8_vs_plain()
        print(json.dumps({"source": name, "max_abs_err_vs_plain": err}),
              flush=True)
    use(libs["repo"])

    cfg = cs.main_config()
    order = ["repo", *args.others, *args.others, "repo"]
    for C, T in cs.fused_stages(cfg, cs.INT8_T):
        x, q = cs.int8_stage_inputs(cs.INT8_B, C, T, torch.bfloat16, seed=C)
        r = mrf_int8.pack_factor(C, T)
        ms = {}
        for name in order:
            use(libs[name])
            ms.setdefault(name, []).append(cs.cuda_ms(
                lambda: mrf_int8.mrf_stage_int8(x, q, r), warmup=1,
                reps=args.reps))
        print(json.dumps({"stage": {"C": C, "T": T, "r": r}, "ms": ms}),
              flush=True)
        del x, q
        torch.cuda.empty_cache()
    use(libs["repo"])

    if args.phases:
        lib = build(src, os.path.join(out_dir, "phases.so"),
                    ["-DTK_PROFILE_PHASES"])
        read = lib.tk_mrf_int8_phase_cycles
        read.argtypes = [ctypes.c_void_p]
        counts = (ctypes.c_ulonglong * len(PHASES))()
        use(lib)
        for C, T in cs.fused_stages(cfg, cs.INT8_T):
            x, q = cs.int8_stage_inputs(cs.INT8_B, C, T, torch.bfloat16,
                                        seed=C)
            r = mrf_int8.pack_factor(C, T)
            mrf_int8.mrf_stage_int8(x, q, r)   # warm-up
            torch.cuda.synchronize()
            _build.check(lib, read(counts), "phase counters")
            ms = cs.cuda_ms(lambda: mrf_int8.mrf_stage_int8(x, q, r),
                            warmup=0, reps=1)
            _build.check(lib, read(counts), "phase counters")
            total = sum(counts)
            print(json.dumps({
                "stage": {"C": C, "T": T, "r": r}, "profiled_ms": ms,
                "block_gcycles": total / 1e9,
                "share": {p: c / total for p, c in zip(PHASES, counts)}}),
                flush=True)
            del x, q
            torch.cuda.empty_cache()
        use(libs["repo"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
