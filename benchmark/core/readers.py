"""What the per-layer metric readers (benchmark/metrics/<name>.py) share.

A reader takes the finished traced ``Run`` and returns its metric's value,
or None where the run holds nothing for it to read (the harness then leaves
the metric out of the result line). A share of a roofline or of a peak is
never given as 0 for want of a reading.
"""

import json
import os

from benchmark.core import counts
from benchmark.core.env import BENCH_DIR
from benchmark.reference import vocoders


def patterns(metric):
    """The kernel-name patterns of ``metric``: benchmark/kernels/<metric>.json."""
    with open(os.path.join(BENCH_DIR, "kernels", f"{metric}.json")) as f:
        return json.load(f)["patterns"]


def range_ms(run, name):
    """Milliseconds of device work a host range launched, per instance of
    the range in the window."""
    seconds, n = run.records["trace"].range_device_s(name)
    return None if not n or not seconds else seconds / n * 1e3


def roofline_pct(run, metric, bound_s):
    """100 x the summed bounds of a kernel's launches in the window over
    the summed device time of the launches matching the metric's patterns;
    None where no launch matched or nothing bounds them."""
    ops = run.records["trace"].ops_matching(patterns(metric))
    busy = sum(e - s for s, e, _ in ops) * 1e-6
    if not ops or busy <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / busy


def idle_pct(run):
    tr = run.records["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def precision_of(run, part):
    """"bf16" or "f32": the dtype a part computes in ("acoustic_compute",
    "vocoder") for the run's precision."""
    p = run.config["precisions"][run.traffic["precision"]][part]
    return {"bfloat16": "bf16", "float32": "f32"}[p]


def attention_bound_s(run):
    """Row 1's bound summed over the window's batches: each encoder layer's
    call over the sentences' phonemes, each decoder layer's over their
    frames, at the program's padded shapes."""
    t = run.config["model"]["transformer"]
    dtype = precision_of(run, "acoustic_compute")
    total = 0.0
    for b in run.records["batches"]:
        for layers, heads, d, T, lens in (
                (t["encoder_layer"], t["encoder_head"], t["encoder_hidden"],
                 b["phone_pad"], b["src_lens"]),
                (t["decoder_layer"], t["decoder_head"], t["decoder_hidden"],
                 b["mel_bucket"], b["mel_lens"])):
            ops, nbytes = counts.attention_work(b["B"], heads, T, d // heads,
                                                lens, dtype)
            total += layers * counts.bound_s(ops, nbytes, dtype)
    return total


def mrf_bound_s(run, dtype):
    """Row 2's (bf16) or 2f's (f32) bound summed over the window's batches:
    each MRF stage at the batch's size and mel bucket."""
    v = run.config["vocoder"]
    total = 0.0
    for B, frames in ((b["B"], b["mel_bucket"])
                      for b in run.records["batches"]):
        for C, T in counts.fused_stages(v, frames):
            ops, nbytes = counts.mrf_work(
                B, C, T, v["resblock_kernel_sizes"],
                len(v["resblock_dilation_sizes"][0]), dtype)
            total += counts.bound_s(ops, nbytes, dtype)
    return total


def model_peak_seconds(run):
    """The seconds the window's real (unpadded) work would take at the
    peaks: FastSpeech2's FLOPs of each sentence at its own lengths over
    the peak of its dtype, plus the vocoder's per real frame (its family's
    flops_per_frame) over its."""
    cfg = run.config
    model = cfg["model"]
    per_frame = vocoders.find(model["vocoder_model"]).flops_per_frame(
        cfg["vocoder"])
    fs2_peak = counts.op_peak(precision_of(run, "acoustic_compute"))
    voc_peak = counts.op_peak(precision_of(run, "vocoder"))
    sentences = [s for b in run.records["batches"]
                 for s in zip(b["src_lens"], b["mel_lens"])]
    return sum(counts.fs2_flops(model, n_ph, n_fr) / fs2_peak
               + per_frame * n_fr / voc_peak for n_ph, n_fr in sentences)
