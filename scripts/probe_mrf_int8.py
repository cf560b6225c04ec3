#!/usr/bin/env python3
"""The MRF kernels on one CUDA card, stage by stage: the int8 kernel
(tts_king_torch/csrc/mrf_stage_int8.cu) at config 2b's fused stages (B = 8,
T_mel = 1000, bf16, the seeded stage weights of chip_smoke.int8_stage_inputs),
with ``--kernel bf16`` the bf16 kernel (tts_king_torch/csrc/mrf_stage.cu)
at the bench shape's stages (B = 32, T_mel = 1000, chip_smoke.mrf_inputs),
or with ``--kernel f32`` its f32 route at speak's 192-frame sentence (B = 1,
T_mel = 192).

    python3 scripts/probe_mrf_int8.py [--kernel int8|bf16|f32] [--phases]
        [--checks-only] [OTHER.cu ...]

Times the kernel per stage; the bf16 mode also prints a lower bound on the
card's L2 read rate and, per stage, the tap bytes the blocks stream from L2
and the rate the repo's kernel reads them at. Each OTHER.cu, another
version of the source
(from a parent checkout, say: git show REV:tts_king_torch/csrc/... >
build/parent/...), is built beside the repo's, held against the plain
version at chip_smoke.py's checks, and timed per stage in turns with the
repo's: repo, others, others, repo. A bf16 source whose library still
exports tk_mrf_smem_bytes has the interface from before the packed-tap
layout (taps [tap][c_out][c_in], its own tile rule) and is called so; in
f32, a source without tk_mrf_stage_f32 has the CUDA-core route from before
3xTF32 (taps [tap][c_in][c_out], Cp a multiple of 8, the largest tile whose
two buffers fit) and is called so; an int8 source without
tk_mrf_int8_cluster_stage has the interface from before the cluster design
(one block a window, a device-memory scratch, taps in the plain layout) and
is called so; a bf16 source without tk_mrf_stage_bf16 has the entry point
from before per-item rows (tk_mrf_stage, every tile run) and is called
so. The f32 checks are chip_smoke.py's MRF_CHECKS and speak's three
stages; the int8 checks chip_smoke.py's INT8_CHECKS and
INT8_EDGE_CHECKS; the int8 mode prints each stage's cluster plan.
``--phases`` also builds the repo's source with ``-DTK_PROFILE_PHASES``,
whose marks add cycles per phase (int8: thread 0's x load and max,
quantization of the next conv's input (its CTA's rows), the reach
exchanged with the neighbours (with the wait for the CTA's slowest warp),
tap wait, products, epilogue, the cluster max and its round, the branch
mean, summed over CTAs; bf16: thread 0's x load, tap wait,
products, epilogue and branch mean, summed over blocks; f32: thread 0's
h load, tap wait, products, conv1's epilogue, conv2's epilogue and store,
over the passes' blocks), and prints each
phase's share. ``--checks-only`` stops after the checks. One JSON line per
result.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = REPO

PHASES = {"mrf_stage_int8": ["x_load", "quantize", "reach", "tap_wait",
                             "products", "epilogue", "cluster_max",
                             "branch_mean"],
          "mrf_stage": ["x_load", "tap_wait", "products", "epilogue",
                        "branch_mean"],
          "mrf_stage_f32": ["h_load", "tap_wait", "products",
                            "epilogue_conv1", "epilogue_conv2_store"]}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the int8 kernel's interface before the cluster design (a device-memory
# scratch buffer, taps [tap][c_out][c_in])
_OLD_INT8 = {"tk_mrf_int8_smem_bytes": (_LL, [_I] * 3),
             "tk_mrf_stage_int8": (_I, [_P] * 6 + [_I] * 8 + [_P, _I, _P, _P]
                                   + [_LL] * 6 + [_P])}
# the bf16 kernel's interface before the packed-tap layout
_OLD_MRF = {"tk_mrf_smem_bytes": (_LL, [_I] * 4),
            "tk_mrf_stage": (_I, [_P] * 4 + [_I] * 7 + [_P, _I, _P]
                             + [_LL] * 6 + [_P])}
# the packed-tap entry point from before per-item rows (is_bf16 in place of
# rows; is_bf16 = 0 was the f32 CUDA-core route before tk_mrf_stage_f32)
_OLD_TC = (_I, [_P] * 4 + [_I] * 8 + [_P, _I, _P] + [_LL] * 6 + [_P])


def ptxas_summary(log):
    """nvcc's resource lines: the kernel each block of lines is about
    (mrf_*<Cp>; the bf16 kernel's instance for launches with rows is
    mrf_stage_tc<Cp, rows>), registers, spills, and the wgmma notes that
    say the compiler serialized the products."""
    out = []
    for ln in log.splitlines():
        if "Function properties for" in ln:
            m = re.search(r"\d(mrf_\w*?)(?:ILi(\d+)E(?:Lb([01])E)?|E)", ln)
            if m:
                rows = ", rows" if m.group(3) == "1" else ""
                out.append(m.group(1) + (f"<{m.group(2)}{rows}>"
                                         if m.group(2) else ""))
        elif "Used" in ln or "spill" in ln:
            out.append(ln.strip())
        elif "serialized" in ln:
            out.append("C7513-like: wgmma serialized")
    return out


def build(name, src, out, extra=()):
    from tts_king_torch.ops.kernels import _build

    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *extra,
                           "-o", out, src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    print(json.dumps({"built": src, "ptxas": ptxas_summary(
        proc.stdout + proc.stderr)}), flush=True)
    lib = ctypes.CDLL(out)
    if name == "mrf_stage_int8":
        if hasattr(lib, "tk_mrf_int8_cluster_stage"):
            return _build.bind(name, out), False
        old, sigs = "int8", _OLD_INT8
    elif hasattr(lib, "tk_mrf_smem_bytes"):
        old, sigs = "bf16", _OLD_MRF
    elif not hasattr(lib, "tk_mrf_stage_f32"):
        # the packed bf16 taps without rows, the f32 route on the CUDA cores
        old, sigs = "f32", {"tk_mrf_stage": _OLD_TC}
    elif not hasattr(lib, "tk_mrf_stage_bf16"):
        # the bf16 entry point without rows, the f32 route as today
        old = "rows"
        sigs = {"tk_mrf_stage": _OLD_TC, "tk_mrf_stage_f32":
                _build.SIGNATURES[name]["tk_mrf_stage_f32"]}
    else:
        return _build.bind(name, out), False
    for fn_name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, fn_name)
        fn.restype, fn.argtypes = restype, argtypes
    lib.tk_error_string.restype = ctypes.c_char_p
    lib.tk_error_string.argtypes = [ctypes.c_int]
    return lib, old


def old_int8_call(lib, x, q, r, tile=None):
    """One launch through the int8 kernel's interface from before the
    cluster design, as its wrapper called it: one block per TPU window, a
    device-memory scratch of two stage-dtype windows a block, taps in the
    plain layout."""
    import torch

    from tts_king_torch.ops.kernels import _build, mrf_int8

    tile = mrf_int8.TILE if tile is None else tile
    B, T, C = x.shape
    Cp = mrf_int8.padded_channels(C)
    ts = r * mrf_int8.tile_rows(T, r, tile)
    n_tiles = -(-T // ts)
    ks = [int(k) for k in q.kernel_sizes]
    dil = [int(d) for d in q.dilations]
    hal = [h for k in ks for h in mrf_int8.conv_halos(k, dil, r)]
    lmax = max(sum(mrf_int8.conv_halos(k, dil, r)) for k in ks)
    rows = ts + 2 * lmax
    scratch = torch.empty((B * n_tiles * 2 * rows * Cp,), dtype=x.dtype,
                          device=x.device)
    y = torch.empty_like(x)
    err = lib.tk_mrf_stage_int8(
        x.data_ptr(), y.data_ptr(), scratch.data_ptr(), q.taps.data_ptr(),
        q.scales.data_ptr(), q.biases.data_ptr(),
        int(x.dtype == torch.bfloat16), B, T, C, Cp, ts, n_tiles, len(ks),
        (ctypes.c_int * len(ks))(*ks), len(dil),
        (ctypes.c_int * len(dil))(*dil), (ctypes.c_int * len(hal))(*hal),
        *x.stride(), *y.stride(), _build.current_stream(x.device))
    _build.check(lib, err, "mrf_stage_int8 (earlier interface)")
    return y


_OLD_F32_PACKED = {}   # id(stage) -> (stage, taps, biases)


def old_f32_call(lib, x, stage):
    """One launch of the f32 CUDA-core route from before 3xTF32: taps
    packed [tap][c_in][c_out] (Cp = C rounded up to 8) once per stage, as
    its Generator did, and its tile: the largest multiple of 8 (at most
    512) whose two activation buffers of Cp + 1 floats a row and a
    32-channel tap chunk fit."""
    import torch

    from tts_king_torch.ops.kernels import _build, mrf

    B, T, C = x.shape
    ks, dil = list(stage.kernel_sizes), list(stage.dilations)
    Cp = (C + 7) // 8 * 8
    if id(stage) not in _OLD_F32_PACKED:
        taps, biases = [], []
        for ws, bs in zip(stage.weights, stage.biases):
            for w, b in zip(ws, bs):
                t = torch.zeros((w.shape[-1], Cp, Cp), dtype=x.dtype,
                                device=x.device)
                t[:, :C, :C] = w.permute(2, 1, 0)
                taps.append(t.reshape(-1))
                bp = torch.zeros((Cp,), dtype=x.dtype, device=x.device)
                bp[:C] = b
                biases.append(bp)
        _OLD_F32_PACKED[id(stage)] = (stage, torch.cat(taps),
                                      torch.stack(biases))
    _, taps, biases = _OLD_F32_PACKED[id(stage)]
    hmax = mrf._halo(ks, dil)

    def smem(tt):
        return 4 * (32 * Cp + 2 * (tt + 2 * hmax) * (Cp + 1))
    tt = min(512, (T + 7) // 8 * 8)
    while tt > 8 and smem(tt) > mrf.SMEM_LIMIT:
        tt -= 8
    y = torch.empty_like(x)
    err = lib.tk_mrf_stage(
        x.data_ptr(), y.data_ptr(), taps.data_ptr(), biases.data_ptr(), 0, B,
        T, C, Cp, tt, 0, len(ks), (ctypes.c_int * len(ks))(*ks), len(dil),
        (ctypes.c_int * len(dil))(*dil), *x.stride(), *y.stride(),
        _build.current_stream(x.device))
    _build.check(lib, err, "mrf_stage f32 (earlier interface)")
    return y


def old_mrf_call(lib, x, stage):
    """One launch through the bf16 kernel's earlier interface: taps packed
    [tap][c_out][c_in] (Cp = 16..128) on every call, as its wrapper did,
    and its largest tile (a multiple of 8, at most 512) that fits."""
    import torch

    from tts_king_torch.ops.kernels import _build, mrf

    B, T, C = x.shape
    ks, dil = list(stage.kernel_sizes), list(stage.dilations)
    Cp = mrf._padded_channels(C)
    taps, biases = [], []
    for ws, bs in zip(stage.weights, stage.biases):
        for w, b in zip(ws, bs):
            t = torch.zeros((w.shape[-1], Cp, Cp), dtype=x.dtype,
                            device=x.device)
            t[:, :C, :C] = w.permute(2, 0, 1)
            taps.append(t.reshape(-1))
            bp = torch.zeros((Cp,), dtype=x.dtype, device=x.device)
            bp[:C] = b
            biases.append(bp)
    taps, biases = torch.cat(taps), torch.stack(biases)
    hmax = mrf._halo(ks, dil)
    tt = min(512, (T + 7) // 8 * 8)
    while tt > 8 and lib.tk_mrf_smem_bytes(1, tt, hmax, Cp) > mrf.SMEM_LIMIT:
        tt -= 8
    y = torch.empty_like(x)
    err = lib.tk_mrf_stage(
        x.data_ptr(), y.data_ptr(), taps.data_ptr(), biases.data_ptr(), 1, B,
        T, C, Cp, tt, len(ks), (ctypes.c_int * len(ks))(*ks), len(dil),
        (ctypes.c_int * len(dil))(*dil), *x.stride(), *y.stride(),
        _build.current_stream(x.device))
    _build.check(lib, err, "mrf_stage (earlier interface)")
    return y


def old_tc_call(lib, x, stage):
    """One launch through the bf16 entry point from before per-item rows
    (tk_mrf_stage, is_bf16 = 1): the same packed taps and tile plan as the
    repo's wrapper, every tile run."""
    import torch

    from tts_king_torch.ops.kernels import _build, mrf

    if isinstance(stage, mrf.MrfStageWeights):
        stage = mrf.pack_stage(stage)
    B, T, C = x.shape
    ks, dil = list(stage.kernel_sizes), list(stage.dilations)
    plan = mrf.tile_plan(T, C, x.dtype, ks, dil)
    y = torch.empty_like(x)
    err = lib.tk_mrf_stage(
        x.data_ptr(), y.data_ptr(), stage.taps.data_ptr(),
        stage.biases.data_ptr(), 1, B, T, C, plan.Cp, plan.tt, plan.slots,
        len(ks), (ctypes.c_int * len(ks))(*ks), len(dil),
        (ctypes.c_int * len(dil))(*dil), *x.stride(), *y.stride(),
        _build.current_stream(x.device))
    _build.check(lib, err, "mrf_stage (interface before rows)")
    return y


def l2_read_gbps(cuda_ms):
    """A lower bound on the card's L2 read rate: torch.sum over a 32 MB
    buffer that stays resident in the 50 MB L2, launches back to back."""
    import torch

    buf = torch.ones(16 * 2 ** 20, dtype=torch.bfloat16, device="cuda")
    ms = cuda_ms(lambda: buf.sum(), warmup=5, reps=200)
    return buf.numel() * buf.element_size() / (ms * 1e-3) / 1e9


def tap_bytes(B, T, packed):
    """Bytes of taps the bf16 kernel's blocks read from L2 in one call: each
    block streams every chunk of the stage once."""
    from tts_king_torch.ops.kernels import mrf

    plan = mrf.tile_plan(T, packed.channels, packed.taps.dtype,
                         packed.kernel_sizes, packed.dilations)
    return plan.blocks(B, T) * packed.taps.numel() * packed.taps.element_size()


def mrf_checks(call, dname):
    """A call against mrf_stage_plain at chip_smoke's MRF checks (and, in
    f32, at speak's three stages of the 192-frame sentence)."""
    import torch

    import chip_smoke as cs
    from tts_king_torch.ops.kernels import mrf

    dtype = torch.bfloat16 if dname == "bf16" else torch.float32
    shapes = list(cs.MRF_CHECKS)
    if dname == "f32":
        shapes += [(1, C, T) for C, T in cs.fused_stages(cs.main_config(),
                                                         cs.SPEAK_LEN)]
    worst = 0.0
    for B, C, T in shapes:
        x, stage = cs.mrf_inputs(B, C, T, dtype, seed=C)
        ref = mrf.mrf_stage_plain(x, stage).float()
        got = call(x, stage).float()
        err = float((got - ref).abs().max())
        tol = cs.TOL[("mrf_stage", dname)] * max(1.0, float(ref.abs().max()))
        print(json.dumps({"check": [B, T, C], "dtype": dname,
                          "max_abs_err": err, "tol": tol}), flush=True)
        if not (bool(torch.isfinite(got).all()) and err <= tol):
            raise RuntimeError(f"mrf_stage {dname} C={C} T={T}: max err "
                               f"{err} > {tol}")
        worst = max(worst, err)
        del x, stage, ref, got
        torch.cuda.empty_cache()
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", help="other versions of the source")
    ap.add_argument("--kernel", choices=("int8", "bf16", "f32"),
                    default="int8")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--checks-only", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_mrf_int8: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tts_king_torch.ops.kernels import _build, mrf, mrf_int8

    torch.backends.cudnn.allow_tf32 = False
    name = "mrf_stage_int8" if args.kernel == "int8" else "mrf_stage"
    out_dir = os.path.join(REPO, "build", "probe_mrf")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build.CSRC_DIR, _build.SOURCES[name])
    libs = {"repo": (_build.load(name), False)}
    for i, other in enumerate(args.others):
        libs[other] = build(name, other, os.path.join(out_dir,
                                                      f"other{i}.so"))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi_line(),
                      "ptxas": ptxas_summary(_build.build_log(name))}),
          flush=True)

    def use(lib):
        _build._libs[name] = lib

    def old_call(key):
        """The adapter for an earlier interface of the kernel that
        ``args.kernel`` runs in library ``key``, or None."""
        lib, old = libs[key]
        if old == "int8":
            return lambda x, stage: old_int8_call(lib, x, *stage)
        if old == "bf16" and args.kernel == "bf16":
            return lambda x, stage: old_mrf_call(lib, x, stage)
        if old == "f32" and args.kernel == "f32":
            return lambda x, stage: old_f32_call(lib, x, stage)
        if old in ("f32", "rows") and args.kernel == "bf16":
            return lambda x, stage: old_tc_call(lib, x, stage)
        return None

    def takes_weights(key):
        """Whether key's caller packs the stage itself, in an earlier
        layout (else it takes the stage packed once)."""
        old = libs[key][1]
        return old == "bf16" or (old == "f32" and args.kernel == "f32")

    def caller(key):
        """(x, stage) -> y through the library ``key``."""
        lib, _ = libs[key]
        if old_call(key) is not None:
            return old_call(key)

        def call(x, stage):
            use(lib)
            if args.kernel == "int8":
                return mrf_int8.mrf_stage_int8(x, *stage)
            return mrf.mrf_stage(x, stage)
        return call

    for key in libs:
        if args.kernel == "int8":
            use(libs[key][0])
            kernel = mrf_int8.mrf_stage_int8
            if libs[key][1] == "int8":   # checks through the old interface
                lib = libs[key][0]
                mrf_int8.mrf_stage_int8 = (
                    lambda x, q, r, tile=mrf_int8.TILE, lib=lib:
                    old_int8_call(lib, x, q, r, tile))
            err = cs.phase_int8_vs_plain()
            mrf_int8.mrf_stage_int8 = kernel
        else:
            err = mrf_checks(caller(key), args.kernel)
        print(json.dumps({"source": key, "max_abs_err_vs_plain": err}),
              flush=True)
    use(libs["repo"][0])
    if args.checks_only:
        return 0

    cfg = cs.main_config()
    order = ["repo", *args.others, *args.others, "repo"]

    def stage_inputs(C, T):
        """(x, the stage as each library's caller takes it, the repo's)."""
        if args.kernel == "int8":
            x, q = cs.int8_stage_inputs(cs.INT8_B, C, T, torch.bfloat16,
                                        seed=C)
            st = (q, mrf_int8.pack_factor(C, T))
            return x, {key: st for key in libs}, st
        if args.kernel == "f32":
            x, stage = cs.mrf_inputs(1, C, T, torch.float32, seed=C)
        else:
            x, stage = cs.mrf_inputs(cs.BENCH_B, C, T, torch.bfloat16,
                                     seed=C)
        packed = mrf.pack_stage(stage)
        return x, {key: stage if takes_weights(key) else packed
                   for key in libs}, packed

    t_mel = {"int8": cs.INT8_T, "bf16": cs.BENCH_T,
             "f32": cs.SPEAK_LEN}[args.kernel]
    if args.kernel == "bf16":
        print(json.dumps({"l2_read_gbps_lower_bound": l2_read_gbps(
            cs.cuda_ms)}), flush=True)
    for C, T in cs.fused_stages(cfg, t_mel):
        x, stages, repo_stage = stage_inputs(C, T)
        ms = {}
        for key in order:
            call = caller(key)
            ms.setdefault(key, []).append(cs.cuda_ms(
                lambda: call(x, stages[key]), warmup=1, reps=args.reps))
        line = {"stage": {"C": C, "T": T}, "ms": ms}
        if args.kernel == "int8":
            q, r = repo_stage
            line["plan"] = cs.int8_plan_fields(mrf_int8.int8_plan(
                T, C, r, q.kernel_sizes, q.dilations, cs.INT8_B,
                torch.bfloat16))
        if args.kernel == "f32":
            plan = mrf.tile_plan(T, C, torch.float32, repo_stage.kernel_sizes,
                                 repo_stage.dilations)
            line["grid"] = {"tt": plan.tt, "blocks_per_pass": plan.blocks(1, T),
                            "launches": plan.n_launches,
                            "slots": plan.slots,
                            "work_factor": plan.work_factor}
        if args.kernel == "bf16":
            nbytes = tap_bytes(cs.BENCH_B, T, repo_stage)
            line["tap_bytes"] = nbytes
            line["repo_tap_gbps"] = nbytes / (min(ms["repo"]) * 1e-3) / 1e9
        print(json.dumps(line), flush=True)
        del x, stages
        torch.cuda.empty_cache()

    if args.phases:
        lib, _ = build(name, src, os.path.join(out_dir, "phases.so"),
                       ["-DTK_PROFILE_PHASES"])
        read = getattr(lib, "tk_mrf_int8_phase_cycles" if args.kernel ==
                       "int8" else "tk_mrf_phase_cycles")
        read.argtypes = [ctypes.c_void_p]
        phases = PHASES["mrf_stage_f32" if args.kernel == "f32" else name]
        counts = (ctypes.c_ulonglong * len(phases))()
        libs["phases"] = (lib, False)
        call = caller("phases")
        for C, T in cs.fused_stages(cfg, t_mel):
            x, _, st = stage_inputs(C, T)
            call(x, st)   # warm-up
            torch.cuda.synchronize()
            _build.check(lib, read(counts), "phase counters")
            ms = cs.cuda_ms(lambda: call(x, st), warmup=0, reps=1)
            _build.check(lib, read(counts), "phase counters")
            total = sum(counts)
            print(json.dumps({
                "stage": {"C": C, "T": T}, "profiled_ms": ms,
                "gcycles": total / 1e9,
                "share": {p: c / total for p, c in zip(phases, counts)}}),
                flush=True)
            del x, st
            torch.cuda.empty_cache()
        use(libs["repo"][0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
