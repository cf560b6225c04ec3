"""BigVGAN's mechanism control, on the card at the cell's own sizes: the
program with every anti-aliased activation computed without its
anti-aliasing (SnakeBeta at the base rate: no 2x up-sampling and no
low-pass down-sampling) must come out not correct, and the program itself
correct. And the seeded model leaves the waveform unclamped: a sample at
+-1 reads the same in the program and the reference whatever either
computed, so under 1% of the drawn sentences' samples may sit there.

Run as a script it prints each run's numbers, one JSON line a run, for
setting the limits (controls: sound, no_anti_alias and those of
test_bench_control.py):

    python benchmark/tests/test_bench_control_bigvgan.py --seeds 11 12 13 \\
        --seconds 3 --controls sound tf32 fp8_vocoder no_anti_alias
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

from benchmark.tests import test_bench_control  # noqa: E402

WORKLOAD = "bigvgan_bulk_bf16"


def snake_at_base_rate(x, alpha, beta):
    """SnakeBeta on x as it is, in f32: x + sin^2(x e^alpha) / (e^beta +
    1e-9), with no up- or down-sampling."""
    import torch

    h = x.float()
    a = torch.exp(alpha.float())[:, None]
    ib = 1.0 / (torch.exp(beta.float())[:, None] + 1e-9)
    return (h + ib * torch.sin(h * a) ** 2).to(x.dtype)


@contextlib.contextmanager
def no_anti_alias():
    from tts_king_torch.models import bigvgan

    act = bigvgan.amp_act
    bigvgan.amp_act = snake_at_base_rate
    try:
        yield
    finally:
        bigvgan.amp_act = act


CONTROLS = dict(test_bench_control.CONTROLS, no_anti_alias=no_anti_alias)


@contextlib.contextmanager
def clip_share(out):
    """Records, in ``out``, the share of the drawn sentences' int16 samples
    at full scale (|sample| >= max_wav_value, truncated)."""
    from benchmark.reference import compare

    sentences = compare.sentences

    def counted(cfg, precision, weights, records, device):
        import numpy as np

        full = int(cfg["vocoder"]["max_wav_value"])
        n = clipped = 0
        for rec in records:
            w = np.abs(np.asarray(rec["wav"], np.int64))
            n += w.size
            clipped += int((w >= full).sum())
        out.append(clipped / max(n, 1))
        return sentences(cfg, precision, weights, records, device)

    compare.sentences = counted
    try:
        yield
    finally:
        compare.sentences = sentences


def readings(seeds, seconds, controls, device):
    """(seed, control, clipped share, result line) of one run of each."""
    from benchmark.core import harness

    for seed in seeds:
        for c in controls:
            clipped = []
            with CONTROLS[c](), clip_share(clipped):
                res = harness.run_cell(WORKLOAD, seed, seconds, False,
                                       device, time.time())
            yield seed, c, clipped[0], res


@pytest.mark.chip
def test_without_anti_aliasing_is_not_correct(cuda_device):
    for seed, c, clipped, res in readings(
            [2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303], 3.0,
            ("sound", "no_anti_alias"), cuda_device):
        assert res["correct"] == (c == "sound"), (seed, c, res["checks"])
        if c == "sound":
            assert clipped < 0.01, (seed, clipped)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", nargs="+", default=["sound"])
    args = ap.parse_args()
    import torch

    from benchmark.core import env

    env.fix_cache_dirs()
    env.float32_exact()
    for seed, c, clipped, res in readings(args.seeds, args.seconds,
                                          args.controls,
                                          torch.device("cuda", 0)):
        print(json.dumps({"workload": WORKLOAD, "seed": seed, "control": c,
                          "correct": res["correct"], "clipped": clipped,
                          "metrics": res["metrics"],
                          "checks": {k: v["value"] for k, v in
                                     res["checks"].items()}}), flush=True)


if __name__ == "__main__":
    main()
