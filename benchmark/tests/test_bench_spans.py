"""The readers of the program's own spans (benchmark/core/spans.py and the
metrics that use it).

  * a hand-made trace with known spans, launches, kernels, a copy and gaps:
    each reader's arithmetic exactly (per-batch division, a stage run twice
    in one batch counted in that batch, idle clipped to a span and to the
    window), and the idle reader against the sum over every busy interval;
  * a trace without the program's spans (a program that records none):
    every reader returns None;
  * a CPU micro traced run (BENCHMARK.json's first cell) holds every span
    of the bulk path;
  * on the card (``chip``), at the cells' sizes: the FastSpeech2 stages sum
    to 97-100.5% of ``fs2_ms.bulk``, the vocoder's parts to 97-100.5% of
    ``vocoder_ms.bulk``, and the idle inside the two calls is at most the
    window's idle.
"""

import json
import time
import types

import pytest
import torch

from benchmark.core import harness
from benchmark.core.trace import Trace
from benchmark.tests import micro

FS2_STAGES = ("fs2_encoder_ms.bulk", "fs2_variance_ms.bulk",
              "fs2_decoder_ms.bulk", "fs2_postnet_ms.bulk")
VOCODER_PARTS = ("vocoder_net_ms.bulk", "wav_out_ms.bulk")
IDLE = ("fs2_idle_ms.bulk", "vocoder_idle_ms.bulk")
READERS = FS2_STAGES + VOCODER_PARTS + IDLE
# the spans of the bulk path (text.g2p is not on it: bulk sends phonemes)
BULK_SPANS = ("fs2.generate", "fs2.inputs", "fs2.encoder", "fs2.variance",
              "fs2.decoder", "fs2.postnet", "fs2.bucket_check",
              "vocoder.generate", "vocoder.net", "vocoder.int16",
              "vocoder.fetch")


def _events(spans, launches):
    """Chrome-trace events: host ranges [(name, start, end)], and launches
    [(launch ts, correlation, device start, device end, category)]."""
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s,
               "dur": e - s, "tid": 1} for n, s, e in spans]
    for ts, corr, s, e, cat in launches:
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                       "tid": 1, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": cat, "name": f"k{corr}", "ts": s,
                       "dur": e - s, "args": {"correlation": corr}})
    return {"traceEvents": events}


# Batch 1: fs2.generate [100, 300]; the encoder launches two kernels whose
# union is [130, 200] (70 us), the decoder one of 60 us; busy [130, 260],
# idle 200 - 130 = 70. Batch 2 escalates its mel bucket: the encoder runs
# twice (30 + 40 us), the decoder once (50); busy 30 + 90, idle 180. The
# vocoder (one batch): net 80 us, the int16 cast 10 and the copy 20; busy
# [770, 880] of [750, 900]: idle 40. A kernel at [950, 960] lies under no
# span.
SPANS = [("bench.window", 0, 1000),
         ("fs2.generate", 100, 300), ("fs2.encoder", 110, 150),
         ("fs2.decoder", 150, 190),
         ("fs2.generate", 400, 700), ("fs2.encoder", 410, 420),
         ("fs2.encoder", 500, 510), ("fs2.decoder", 520, 530),
         ("vocoder.generate", 750, 900), ("vocoder.net", 755, 800),
         ("vocoder.int16", 800, 810), ("vocoder.fetch", 810, 890)]
LAUNCHES = [(120, 1, 130, 170, "kernel"), (140, 2, 170, 200, "kernel"),
            (160, 3, 200, 260, "kernel"),
            (415, 4, 420, 450, "kernel"), (505, 5, 510, 550, "kernel"),
            (525, 6, 550, 600, "kernel"),
            (760, 7, 770, 850, "kernel"), (805, 8, 850, 860, "kernel"),
            (815, 9, 860, 880, "gpu_memcpy"),
            (940, 10, 950, 960, "kernel")]


def _read(tmp_path, trace):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    run = types.SimpleNamespace(records={"trace": Trace(str(path))})
    return {name: harness.load_module("metrics", name).read(run)
            for name in READERS}


def test_readers_on_a_known_trace(tmp_path):
    got = _read(tmp_path, _events(SPANS, LAUNCHES))
    want = {"fs2_encoder_ms.bulk": (70 + 30 + 40) / 2 * 1e-3,
            "fs2_decoder_ms.bulk": (60 + 50) / 2 * 1e-3,
            "fs2_idle_ms.bulk": (70 + 180) / 2 * 1e-3,
            "vocoder_net_ms.bulk": 80e-3,
            "wav_out_ms.bulk": 30e-3,
            "vocoder_idle_ms.bulk": 40e-3,
            # no fs2.variance or fs2.postnet span in this trace
            "fs2_variance_ms.bulk": None,
            "fs2_postnet_ms.bulk": None}
    assert got.keys() == want.keys()
    for name, value in want.items():
        assert got[name] == (None if value is None
                             else pytest.approx(value, abs=1e-12)), name


def test_idle_is_clipped_to_the_window(tmp_path):
    """A batch's span that outlasts the window counts its idle inside the
    window only: [900, 1100] against a window ending at 1000."""
    spans = [("bench.window", 0, 1000), ("fs2.generate", 900, 1100)]
    launches = [(905, 1, 920, 940, "kernel")]
    got = _read(tmp_path, _events(spans, launches))
    assert got["fs2_idle_ms.bulk"] == pytest.approx((100 - 20) * 1e-3)


def test_idle_matches_the_sum_over_every_busy_interval():
    """The idle reader sums only the busy intervals that reach into each
    span; on a random trace it equals the sum over all of them."""
    import random

    from benchmark.core.spans import idle_ms_per_batch
    from benchmark.core.trace import clipped_length, merge

    rng = random.Random(7)
    ops, t = [], 0.0
    for _ in range(5000):
        t += rng.expovariate(1 / 3)
        ops.append((t, t + rng.expovariate(1 / 5)))
    spans, t = [], 0.0
    for _ in range(200):
        t += rng.uniform(0, 300)
        spans.append((t, t + rng.uniform(0, 400)))
    tr = types.SimpleNamespace(busy=merge(ops), window=(50.0, t),
                               ranges={"fs2.generate": spans})
    got = idle_ms_per_batch(types.SimpleNamespace(records={"trace": tr}),
                            "fs2.generate")
    want = 0.0
    for s, e in spans:
        s, e = max(s, 50.0), min(e, t)
        if e > s:
            want += (e - s) - clipped_length(tr.busy, s, e)
    assert got == pytest.approx(want / len(spans) * 1e-3, rel=1e-12)


def test_readers_return_none_without_the_programs_spans(tmp_path):
    spans = [("bench.window", 0, 1000), ("bench.fs2", 100, 300),
             ("bench.vocoder", 400, 600)]
    launches = [(120, 1, 130, 170, "kernel"), (420, 2, 430, 500, "kernel")]
    assert set(_read(tmp_path, _events(spans, launches)).values()) == {None}


def test_cpu_traced_run_holds_the_bulk_spans(tmp_path, monkeypatch):
    from benchmark.core import trace as trace_module

    seen = []

    class Kept(Trace):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)

    monkeypatch.setattr(trace_module, "Trace", Kept)
    workload, config = next(iter(micro.cells().items()))
    res = harness.run_cell(workload, 2 ** 31 + 91, 0.5, True,
                           torch.device("cpu"), time.time(),
                           config_file=micro.config_file(tmp_path, config),
                           traffic_overrides=micro.TRAFFIC)
    assert res["correct"], res["checks"]
    (tr,) = seen
    batches = len(tr.ranges["fs2.generate"])
    assert batches >= 1 and len(tr.ranges["vocoder.generate"]) == batches
    for name in BULK_SPANS:
        assert len(tr.ranges.get(name, [])) >= batches, name
    for name in READERS:
        assert res["metrics"][name]["value"] is not None, name


@pytest.mark.chip
@pytest.mark.parametrize("workload", list(micro.cells()))
def test_spans_reconcile_on_the_card(cuda_device, workload):
    res = harness.run_cell(workload, 2 ** 31 + 5, 5.0, True, cuda_device,
                           time.time())
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert all(m.get(name) is not None for name in READERS), m
    fs2 = sum(m[name] for name in FS2_STAGES) / m["fs2_ms.bulk"]
    vocoder = sum(m[name] for name in VOCODER_PARTS) / m["vocoder_ms.bulk"]
    assert 0.97 <= fs2 <= 1.005, (fs2, m)
    assert 0.97 <= vocoder <= 1.005, (vocoder, m)
    dev = res["device"]
    cell = harness.find(harness.manifest()["workloads"], workload,
                        "workload")
    batches = res["attempted"] / harness.load_json(
        "traffic", f"{cell['traffic']}.json")["batch"]
    idle_ms = (m["fs2_idle_ms.bulk"] + m["vocoder_idle_ms.bulk"]) * batches
    assert idle_ms <= m["idle_share.bulk"] / 100 * dev["window_s"] * 1e3, (
        m, dev)
