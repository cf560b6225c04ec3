"""The lower-precision controls of the cells, on the card at the cells' own
sizes: each control, put in the program's place, must come out not
correct, and the program itself correct.

Controls (one precision step below what the configuration states); a
cell's are listed under "controls" in its limits file
(benchmark/limits/<cell>.json):
  tf32        the program with TF32 on (its float32 convs and products;
              the configurations state float32 with TF32 off);
  fp8_vocoder the reference vocoder with its convs in float8 in place of
              the program's bf16 vocoder;
  int8_mrf    HiFi-GAN: the program's own int8 MRF path
              (Generator(mrf_backend="fused_int8")) in place of the bf16
              vocoder. It lowers only MRF stages 1-3: it passes wav_err
              (about 2.2 times the bf16 program's) and fails
              wav_noise_ratio.

Run as a script it prints each run's numbers, one JSON line a run, for
setting the limits:

    python benchmark/tests/test_bench_control.py --workload <cell> \\
        --seeds 11 12 13 --seconds 3 --controls sound tf32 int8_mrf
"""

import argparse
import contextlib
import json
import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.tests import micro  # noqa: E402


@contextlib.contextmanager
def tf32():
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@contextlib.contextmanager
def patched_build(replace_vocoder):
    """program.build with the vocoder's generator replaced."""
    from benchmark.core import program

    build = program.build

    def patched(cfg, precision, weights, device):
        acoustic, vocoder = build(cfg, precision, weights, device)
        replace_vocoder(cfg, weights, vocoder)
        return acoustic, vocoder

    program.build = patched
    try:
        yield
    finally:
        program.build = build


def _int8(cfg, weights, vocoder):
    import torch

    from tts_king_torch.models.hifigan import Generator

    g = Generator(vocoder.config.vocoder, mrf_backend="fused_int8")
    g.load_state_dict({k: t.float().cpu() for k, t in weights[1].items()})
    vocoder.model = g.to(vocoder.device).to(torch.bfloat16).eval()


def _fp8(cfg, weights, vocoder):
    import torch

    from benchmark.reference import vocoders

    fn = vocoders.find(cfg["model"]["vocoder_model"]).generate
    v = cfg["vocoder"]

    def vocode_int16(mel, frames=None):
        with torch.no_grad():
            wav = torch.stack([fn(weights[1], v, m.float(), "float8")
                               for m in mel])
        return vocoders.to_int16(wav, v["max_wav_value"])

    vocoder.vocode_int16 = vocode_int16


CONTROLS = {"sound": contextlib.nullcontext,
            "tf32": tf32,
            "int8_mrf": lambda: patched_build(_int8),
            "fp8_vocoder": lambda: patched_build(_fp8)}


def readings(workload, seeds, seconds, controls, device):
    """(seed, control, result line) of one run of each, in one process."""
    from benchmark.core import harness

    for seed in seeds:
        for c in controls:
            with CONTROLS[c]():
                yield seed, c, harness.run_cell(
                    workload, seed, seconds, False, device, time.time())


def cell_controls(workload):
    """The controls the cell's limits file lists."""
    from benchmark.core import harness

    return tuple(harness.load_json("limits", f"{workload}.json")["controls"])


@pytest.mark.chip
@pytest.mark.parametrize("workload", sorted(micro.cells()))
def test_controls_fail_and_program_passes(cuda_device, workload):
    for seed, c, res in readings(workload, [101, 102, 103], 3.0,
                                 ("sound",) + cell_controls(workload),
                                 cuda_device):
        assert res["correct"] == (c == "sound"), (seed, c, res["checks"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", nargs="+", default=["sound"])
    args = ap.parse_args()
    import torch

    from benchmark.core import env

    env.fix_cache_dirs()
    env.float32_exact()
    for seed, c, res in readings(args.workload, args.seeds, args.seconds,
                                 args.controls, torch.device("cuda", 0)):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": c, "correct": res["correct"],
                          "metrics": res["metrics"],
                          "checks": {k: v["value"] for k, v in
                                     res["checks"].items()}}), flush=True)


if __name__ == "__main__":
    main()
