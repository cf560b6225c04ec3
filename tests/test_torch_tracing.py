"""The port's spans and serving counters (utils/profiling.span, the spans of
pipeline.py, models/fs2.py and serve.py, SynthesisServer.stats()) on the
CPU, at micro_config() widths.

  * with no profiler running, no span enters the profiler's range API, and
    the process-wide flag that gates them reads True on every thread while
    ``trace()`` runs;
  * under ``trace()``, one AcousticModel.generate and one Vocoder.generate
    leave each bulk-path span once (a stage twice where the mel bucket
    escalates), each inside its parent;
  * under ``trace()``, the server's spans land on the threads that make
    them, and a batch's spans share its id;
  * stats()'s load counters.

The duration head's weight is zeroed and its bias set, so every phoneme
lasts round(exp(bias) - 1) frames whatever the input. Every wait has a
timeout and every server is closed in ``finally``.
"""

import json
import threading

import numpy as np
import pytest
import torch

BULK_SPANS = ("fs2.generate", "fs2.inputs", "fs2.encoder", "fs2.variance",
              "fs2.decoder", "fs2.postnet", "fs2.bucket_check",
              "vocoder.generate", "vocoder.net", "vocoder.int16",
              "vocoder.fetch", "text.g2p")
PARENT = {"fs2.inputs": "fs2.generate", "fs2.encoder": "fs2.generate",
          "fs2.variance": "fs2.generate", "fs2.decoder": "fs2.generate",
          "fs2.postnet": "fs2.generate", "fs2.bucket_check": "fs2.generate",
          "vocoder.net": "vocoder.generate",
          "vocoder.int16": "vocoder.generate",
          "vocoder.fetch": "vocoder.generate"}
STAGES = ("fs2.encoder", "fs2.variance", "fs2.decoder", "fs2.postnet",
          "fs2.bucket_check")
BATCH_SPANS = ("serve.gather", "serve.fs2", "serve.lengths_wait",
               "serve.vocoder", "serve.fetch_wait")


def _king(tmp_path, frames_log):
    """A micro TTSKing on the CPU whose phonemes each last
    round(exp(frames_log) - 1) frames, with a one-word lexicon."""
    from tts_king_torch.config import micro_config
    from tts_king_torch.pipeline import TTSKing

    cfg = micro_config()
    lex = tmp_path / "mini.dict"
    lex.write_text("привет P R I0 V E0 T\n", encoding="utf-8")
    cfg.preprocess.lexicon_path = str(lex)
    king = TTSKing(cfg, device="cpu", n_speakers=2)
    head = king.tts.model.variance_adaptor.duration_predictor.linear_layer
    with torch.no_grad():
        head.weight.zero_()
        head.bias.fill_(frames_log)
    return king


def _spans(path):
    """{name: [(start, end, tid, id or None)]} of the trace's ranges."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            inputs = e.get("args", {}).get("Concrete Inputs") or [None]
            ident = int(inputs[0]) if inputs[0] not in (None, "") else None
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 e.get("tid"), ident))
    return out


def _forbid_ranges(monkeypatch):
    def entered(*a, **k):
        raise AssertionError("a span entered the profiler's range API "
                             "while no profiler runs")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", entered)
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        entered)


def test_spans_cost_no_range_without_a_profiler(tmp_path, monkeypatch):
    from tts_king_torch.serve import SynthesisServer
    from tts_king_torch.utils import profiling

    king = _king(tmp_path, 1.5)
    _forbid_ranges(monkeypatch)
    assert profiling.span("fs2.generate") is profiling.span("x", 3)
    hop = king.cfg.preprocess.stft.hop_length
    out = king.tts.generate(np.arange(10, 30)[None], speaker_name=1)
    wavs = king.vocoder.generate(out["postnet_mel"],
                                 out["mel_lens"].numpy() * hop)
    assert wavs[0].dtype == np.int16
    server = SynthesisServer(king, max_batch=2)
    try:
        futures = [server.submit(phonemes=np.arange(10, 10 + n))
                   for n in (8, 12, 16)]
        futures.append(server.submit(text="привет"))
        assert all(f.result(timeout=300).size for f in futures)
        assert sum(c.size for c in server.stream(phonemes=np.arange(10, 30),
                                                 chunk_frames=16))
    finally:
        server.close()
    monkeypatch.undo()

    # the flag span() reads is process-wide: True on a thread that did not
    # start the profiler (torch.autograd._profiler_enabled() is not)
    seen = []
    with profiling.trace(str(tmp_path / "prof")):
        reader = threading.Thread(target=lambda: seen.append(
            torch.autograd.profiler._is_profiler_enabled))
        reader.start()
        reader.join(timeout=60)
    assert not reader.is_alive() and seen == [True]
    assert torch.autograd.profiler._is_profiler_enabled is False


@pytest.mark.parametrize("frames_log, n_stage", [(1.5, 1), (3.0, 2)])
def test_bulk_spans_nest_once_per_call(tmp_path, frames_log, n_stage):
    """frames_log 1.5: 3 frames a phoneme, the first mel bucket (128 for
    10 phonemes) fits; 3.0: 19 frames a phoneme, 190 > 128, so the stages
    and the bucket check run again at 256 inside the one generate."""
    from tts_king_torch.utils.profiling import trace

    king = _king(tmp_path, frames_log)
    hop = king.cfg.preprocess.stft.hop_length
    with trace(str(tmp_path / "prof")):
        king.text_preprocess("привет")
        out = king.tts.generate(np.arange(10, 20)[None], speaker_name=1)
        king.vocoder.generate(out["postnet_mel"],
                              out["mel_lens"].numpy() * hop)
    assert out["mel_bucket"] == (128 if n_stage == 1 else 256)
    spans = _spans(tmp_path / "prof" / "trace.json")
    for name in BULK_SPANS:
        want = n_stage if name in STAGES else 1
        assert len(spans.get(name, [])) == want, (name, spans.get(name))
    for name, parent in PARENT.items():
        (lo, hi, *_), = spans[parent]
        for s, e, *_ in spans[name]:
            assert lo <= s <= e <= hi, (name, parent)
    # the stages run in order within each pass
    starts = [[s for s, *_ in spans[n]] for n in STAGES]
    for i in range(n_stage):
        assert [st[i] for st in starts] == sorted(st[i] for st in starts)


def test_server_spans_land_on_their_threads(tmp_path):
    from tts_king_torch.serve import SynthesisServer
    from tts_king_torch.utils.profiling import trace

    king = _king(tmp_path, 1.5)
    server = SynthesisServer(king, max_batch=4)
    try:
        rng = np.random.RandomState(5)
        with trace(str(tmp_path / "prof")):
            futures = [server.submit(phonemes=rng.randint(10, 100, size=n))
                       for n in (6, 9, 12, 15, 18, 21)]
            assert all(f.result(timeout=300).size for f in futures)
            assert sum(c.size for c in server.stream(
                phonemes=rng.randint(10, 100, size=20), chunk_frames=16))
        device_tid = server._device_thread.native_id
        dispatcher_tid = server._threads[0].native_id
    finally:
        server.close()
    spans = _spans(tmp_path / "prof" / "trace.json")
    for name in ("serve.fs2", "serve.vocoder", "fs2.generate",
                 "vocoder.net"):
        assert spans[name] and {t for _, _, t, _ in spans[name]} == {
            device_tid}, name
    assert {t for _, _, t, _ in spans["serve.gather"]} == {dispatcher_tid}
    batches = {i for *_, i in spans["serve.gather"]}
    assert None not in batches
    for name in BATCH_SPANS:
        ids = {i for *_, i in spans[name]}
        assert ids == batches, (name, ids, batches)
    (*_, stream_id), = spans["serve.stream"]
    assert stream_id is not None and stream_id not in batches


def test_stats_counts_the_load(tmp_path, monkeypatch):
    import tts_king_torch.pipeline as pipeline
    from tts_king_torch.serve import SynthesisServer

    # 6 frames a phoneme: 40 phonemes are 240 frames, and with a guess of
    # one frame a phoneme the first mel bucket (128) overflows once
    king = _king(tmp_path, 1.95)
    server = SynthesisServer(king, max_batch=4)
    try:
        rng = np.random.RandomState(2)
        futures = [server.submit(phonemes=rng.randint(10, 100, size=n))
                   for n in (5, 8, 11)]
        futures.append(server.submit(text="привет"))
        assert all(f.result(timeout=300).size for f in futures)
        st = server.stats()
        assert st["batched_requests"] == st["completed"] == 4
        assert 1 <= st["batches"] <= 4
        assert 0.0 <= st["device_busy_s"] <= st["uptime_s"]
        assert st["queue_wait_s"] >= 0.0 and st["g2p_s"] > 0.0
        assert st["overflow_redos"] == 0

        monkeypatch.setattr(pipeline, "_FRAMES_PER_PHONE_GUESS", 1.0)
        wav = server.submit(phonemes=rng.randint(10, 100, size=40)).result(
            timeout=300)
        assert wav.shape == (240 * king.cfg.preprocess.stft.hop_length,)
        st = server.stats()
        assert st["overflow_redos"] == 1
        assert st["batched_requests"] == 5
    finally:
        server.close()
