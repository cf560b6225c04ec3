"""The port's serving layer (tts_king_torch/serve.py) on the CPU.

Three groups:
  * the behaviours tests/test_serve.py pins, each mirrored on the port's
    server (the dp-mesh test is in test_torch_parallel_inference.py);
  * the port against the JAX package on the same seeded inputs and the same
    weights: optimal_buckets and _phone_pad exactly, generate(
    defer_overflow=True) (same mel bucket, mel MAE < 1e-3),
    stream_vocoder(start_frame=k) chunk for chunk, mels served by both
    servers (equal lengths, MAE < 1e-3) and both streams (equal lengths,
    > 2 LSB off at under 1% of the interior samples);
  * the kernel build and the launch counters under threads.

Widths: micro_config() (tests/test_pipeline.py's small_cfg), 3 speakers, the
duration head biased to 1.5 as tests/test_serve.py biases it. Every wait has
a timeout and every server is closed in ``finally``.
"""

import dataclasses
import io
import json
import sys
import threading
import time
import types
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

N_SPEAKERS = 3


def _port_config(jax_cfg):
    from tts_king_torch import config as port_config

    return port_config._build(port_config.TTSConfig,
                              dataclasses.asdict(jax_cfg)).validate()


@pytest.fixture(scope="module")
def kings():
    """(JAX TTSKing, port TTSKing) with the same weights: the JAX models'
    initial weights, the duration head's bias at 1.5, 3 speakers."""
    import jax
    import jax.numpy as jnp

    from tts_king_tpu.config import micro_config
    from tts_king_tpu.pipeline import AcousticModel as JaxAcoustic
    from tts_king_tpu.pipeline import TTSKing as JaxKing
    from tts_king_torch.pipeline import TTSKing

    cfg = micro_config()
    jk = JaxKing(cfg)
    jk.tts = JaxAcoustic(cfg, n_speakers=N_SPEAKERS)
    jk.speakers = jk.tts.speaker_names
    head = jk.tts.variables["params"]["variance_adaptor"][
        "duration_predictor"]["linear_layer"]
    head["bias"] = jnp.full_like(head["bias"], 1.5)
    pk = TTSKing(_port_config(cfg), device="cpu", n_speakers=N_SPEAKERS,
                 acoustic_variables=jax.tree.map(np.asarray,
                                                 jk.tts.variables),
                 vocoder_variables=jax.tree.map(np.asarray,
                                                jk.vocoder.variables))
    return jk, pk


@pytest.fixture(scope="module")
def king(kings):
    return kings[1]


def _post(url, body, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


class _Shapes:
    """Records the shapes the FS2 model and the vocoder are called at:
    (B, Lb, T) and (B, T). The port's analogue of a jit cache's size: a
    shape first touched by live traffic is one prewarm missed."""

    def __init__(self, king, monkeypatch):
        self.fs2, self.voc = set(), set()
        model, vocode = king.tts.model, king.vocoder.vocode_int16
        fs2_forward = model.forward

        def forward(speakers, texts, src_lens, max_mel_len=None, **kw):
            self.fs2.add((texts.shape[0], texts.shape[1], max_mel_len))
            return fs2_forward(speakers, texts, src_lens,
                               max_mel_len=max_mel_len, **kw)

        def vocode_int16(mel):
            self.voc.add((mel.shape[0], mel.shape[1]))
            return vocode(mel)

        monkeypatch.setattr(model, "forward", forward)
        monkeypatch.setattr(king.vocoder, "vocode_int16", vocode_int16)

    def snapshot(self):
        return set(self.fs2), set(self.voc)


# ------------------------------------------- tests/test_serve.py, mirrored


def test_server_batches_requests(king):
    from tts_king_torch.serve import SynthesisServer

    server = SynthesisServer(king, max_batch=4, max_wait_ms=50)
    try:
        rng = np.random.RandomState(0)
        futures = []
        for i in range(6):
            phonemes = rng.randint(64, 200, size=(5 + i,))
            futures.append(server.submit(phonemes=phonemes, speaker=i % 3))
        wavs = [f.result(timeout=120) for f in futures]
        for wav in wavs:
            assert wav.dtype == np.int16
            assert wav.ndim == 1
        assert len(wavs[-1]) > 0
    finally:
        server.close()


def test_server_mel_mode_and_errors(king):
    from tts_king_torch.serve import SynthesisServer

    server = SynthesisServer(king, max_batch=2, max_wait_ms=5,
                             return_wav=False)
    try:
        f = server.submit(phonemes=np.array([70, 80, 90]))
        mel, n = f.result(timeout=120)
        assert mel.shape[1] == 80 and mel.shape[0] == n
        assert mel.dtype == np.float32

        bad = server.submit(phonemes=np.array([1.5, 2.5]))  # float ids: cast ok
        mel2, n2 = bad.result(timeout=120)
        assert mel2.shape[1] == 80
    finally:
        server.close()


def test_server_window_policy_still_works(king):
    from tts_king_torch.serve import SynthesisServer

    server = SynthesisServer(king, max_batch=4, max_wait_ms=20,
                             policy="window")
    try:
        fs = [server.submit(phonemes=np.array([70, 80, 90, 100]))
              for _ in range(3)]
        for f in fs:
            wav = f.result(timeout=120)
            assert wav.dtype == np.int16 and wav.ndim == 1
    finally:
        server.close()

    with pytest.raises(ValueError, match="policy"):
        SynthesisServer(king, policy="nonsense")


def test_per_item_speakers(king):
    out = king.tts.generate(
        np.array([[70, 80, 90, 0], [70, 80, 0, 0]]),
        speaker_name=[0, 2], src_lens=[3, 2])
    assert out["postnet_mel"].shape[0] == 2


def test_length_groups_split():
    """Mixed-length batches split at phoneme-bucket boundaries only when
    that lowers total padded (batch-bucket x length-bucket) compute."""
    from tts_king_torch.serve import SynthesisServer, _Request

    server = object.__new__(SynthesisServer)
    server.batch_buckets = [1, 4, 16]
    server.king = types.SimpleNamespace(tts=types.SimpleNamespace(
        phone_buckets=None))

    def reqs(lengths):
        return [_Request(np.zeros((n,), np.int32), 0, (1.0, 1.0, 1.0))
                for n in lengths]

    small = reqs([10, 60])
    assert server._length_groups(small) == [small]

    mixed = reqs([10, 12, 14, 15, 50, 55, 60, 62])
    groups = server._length_groups(mixed)
    assert [sorted(len(r.phonemes) for r in g) for g in groups] == [
        [10, 12, 14, 15], [50, 55, 60, 62]]

    tail = reqs([10, 11, 12, 13, 100])
    groups = server._length_groups(tail)
    assert [len(g) for g in groups] == [4, 1]

    overload = reqs([12, 14, 12, 15, 13, 25, 28, 30, 27, 26, 29,
                     50, 55, 60, 62, 58])
    assert server._length_groups(overload) == [overload]


def test_deferred_overflow_retry(king, monkeypatch):
    """When the duration predictor overflows the guessed mel bucket, the
    vocoder stage retries with escalation and still resolves every future
    with the audio length the synchronous path produces."""
    import tts_king_torch.pipeline as pipeline
    from tts_king_torch.serve import SynthesisServer

    rng = np.random.RandomState(3)
    phonemes = rng.randint(10, 100, size=(40,))

    ref = king.tts.generate(phonemes[None], speaker_name=0)
    ref_len = int(ref["mel_lens"][0])

    monkeypatch.setattr(pipeline, "_FRAMES_PER_PHONE_GUESS", 1.0)
    assert ref_len > 128, "test premise: prediction must overflow bucket 128"

    server = SynthesisServer(king, max_batch=4)
    try:
        wav = server.submit(phonemes=phonemes).result(timeout=300)
    finally:
        server.close()
    hop = king.cfg.preprocess.stft.hop_length
    assert wav.shape == (ref_len * hop,)


def test_stream_endpoint(king):
    """Streaming endpoint: chunks arrive incrementally, concatenate to the
    full utterance length, and match the batched path away from the halo'd
    window edges, while batched traffic flows on the same server."""
    from tts_king_torch.serve import SynthesisServer

    rng = np.random.RandomState(7)
    phonemes = rng.randint(10, 100, size=(24,))

    server = SynthesisServer(king, max_batch=4)
    try:
        batched_future = server.submit(phonemes=phonemes)
        chunks = list(server.stream(phonemes=phonemes, chunk_frames=16))
        batched = batched_future.result(timeout=300)
    finally:
        server.close()

    assert len(chunks) > 1, "expected incremental chunks"
    streamed = np.concatenate(chunks)
    assert streamed.dtype == np.int16
    assert streamed.shape == batched.shape
    lo, hi = len(streamed) // 4, 3 * len(streamed) // 4
    frac_off = float(np.mean(
        np.abs(streamed[lo:hi].astype(np.int32)
               - batched[lo:hi].astype(np.int32)) > 2))
    assert frac_off < 0.01, f"{frac_off:.2%} of interior samples differ"


def test_http_front_end(king):
    """HTTP surface: /health, /tts (WAV container), /stream (chunked PCM)
    against a live server on an ephemeral port."""
    from tts_king_torch.serve import serve_http

    httpd, server = serve_http(king, port=0, max_batch=4)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{base}/health", timeout=60) as r:
            health = json.loads(r.read())
        assert health["ok"] is True

        body = {"phonemes": [70, 80, 90, 100], "speaker": 1}
        with _post(f"{base}/tts", body) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            data = r.read()
        with wave.open(io.BytesIO(data)) as w:
            assert w.getframerate() == king.cfg.preprocess.audio.sampling_rate
            assert w.getnframes() > 0
            wav_http = np.frombuffer(w.readframes(w.getnframes()), np.int16)

        with _post(f"{base}/stream", body) as r:
            assert r.headers["Content-Type"].startswith("audio/L16")
            pcm = np.frombuffer(r.read(), np.int16)
        assert pcm.shape == wav_http.shape

        # errors raised before the first audio chunk come back as a clean
        # JSON 500, not a connection reset after the chunked headers
        bad = {"phonemes": [70, 80, 90, 100], "speaker": "no-such-speaker"}
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/stream", bad, timeout=60)
        assert e.value.code == 500
        assert "error" in json.loads(e.value.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


def test_overload_admission_control(king):
    """Past admission_depth waiting requests, submit() rejects immediately
    and the queue never grows beyond the bound.

    The server's device thread is held at an event the test owns (a job put
    on its queue ahead of every request), so the dispatcher blocks on its
    first batch and the queue fills to the bound however fast the CPU
    drains it; every later submit is rejected. Released, the admitted
    requests complete."""
    from concurrent.futures import Future

    from tts_king_torch.serve import ServerOverloaded, SynthesisServer

    server = SynthesisServer(king, max_batch=2, admission_depth=4)
    gate = threading.Event()
    server._device_jobs.put((lambda: gate.wait(timeout=300), Future()))
    try:
        rng = np.random.RandomState(0)
        rejected = 0
        futures = []
        for _ in range(400):
            try:
                futures.append(
                    server.submit(phonemes=rng.randint(64, 200, size=(40,))))
            except ServerOverloaded:
                rejected += 1
            assert server._queue.qsize() <= 4  # bound holds at all times
        assert rejected > 0, "overload never rejected anything"
        # the queue's 4, and at most one batch the dispatcher holds
        assert len(futures) <= 4 + 2
        st = server.stats()
        assert st["rejected"] == rejected
        assert st["admitted"] == len(futures)
        gate.set()
        for f in futures:
            wav = f.result(timeout=300)
            assert wav.dtype == np.int16
        assert server.stats()["completed"] == len(futures)
    finally:
        gate.set()
        server.close()


def test_deadline_shedding(king):
    """A request whose deadline passes while queued fails with
    DeadlineExceeded and never reaches the device."""
    from tts_king_torch.serve import DeadlineExceeded, SynthesisServer

    server = SynthesisServer(king, max_batch=2, admission_depth=64)
    try:
        rng = np.random.RandomState(1)
        warm = [server.submit(phonemes=rng.randint(64, 200, size=(24,)))
                for _ in range(6)]
        doomed = server.submit(phonemes=rng.randint(64, 200, size=(24,)),
                               deadline_ms=0.0)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=120)
        for f in warm:
            f.result(timeout=300)
        assert server.stats()["shed"] >= 1
        ok = server.submit(phonemes=rng.randint(64, 200, size=(24,)),
                           deadline_ms=60000.0)
        assert ok.result(timeout=300).dtype == np.int16
    finally:
        server.close()


def test_vocoder_stage_sheds_fully_expired_batch(king):
    """A batch whose every member expired after FS2 dispatch is dropped at
    the vocoder stage without vocoder compute: the handles are a sentinel
    that would crash _vocode_batch (TypeError, not DeadlineExceeded)."""
    from tts_king_torch.serve import (DeadlineExceeded, SynthesisServer,
                                      _Request, _now)

    server = SynthesisServer(king, max_batch=2)
    try:
        reqs = [_Request(np.arange(5, dtype=np.int32), 0, (1.0, 1.0, 1.0))
                for _ in range(2)]
        for r in reqs:
            r.deadline = _now() - 1.0
        server._mid.put((reqs, object()))
        for r in reqs:
            with pytest.raises(DeadlineExceeded):
                r.future.result(timeout=60)
        assert server.stats()["shed"] == 2
    finally:
        server.close()


def test_prewarm_compiles_serving_grid(king, monkeypatch):
    """prewarm() walks the full (batch-bucket x phoneme-bucket x
    mel-bucket) grid through the calls the serving threads make, and the
    server serves normally afterwards without touching a new shape."""
    from tts_king_torch.pipeline import MEL_BUCKETS
    from tts_king_torch.serve import SynthesisServer

    shapes = _Shapes(king, monkeypatch)
    server = SynthesisServer(king, max_batch=4)
    try:
        out = server.prewarm(max_phonemes=20)
        assert out["batch_buckets"] == [1, 4]
        assert out["phone_buckets"] == [16, 32]
        assert out["mel_buckets"], "no vocoder shapes warmed"
        assert set(out["mel_buckets"]) <= set(MEL_BUCKETS)
        warmed_fs2, warmed_voc = shapes.snapshot()
        wav = server.submit(
            phonemes=np.arange(64, 76, dtype=np.int32)).result(timeout=300)
        assert wav.dtype == np.int16
        # prewarm must warm the vocoder shape production dispatches
        assert shapes.voc == warmed_voc, \
            "live request touched a vocoder shape prewarm missed"
        assert shapes.fs2 == warmed_fs2
    finally:
        server.close()


def test_http_429_and_stats(king):
    """HTTP front maps ServerOverloaded to 429 (+Retry-After) and exposes
    /stats."""
    from tts_king_torch.serve import serve_http

    httpd, server = serve_http(king, port=0, max_batch=2, admission_depth=1)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    try:
        body = {"phonemes": [70, 80, 90, 100]}
        results = []

        def post_one():
            try:
                with _post(f"{base}/tts", body) as r:
                    results.append(r.status)
            except urllib.error.HTTPError as e:
                results.append(e.code)
                if e.code == 429:
                    assert e.headers.get("Retry-After") is not None

        threads = [threading.Thread(target=post_one) for _ in range(24)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
        assert 200 in results
        assert 429 in results, f"no rejections among {results}"

        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            st = json.loads(r.read())
        assert st["rejected"] >= 1 and st["admitted"] >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


def _with_vocoder(king, family):
    """``king`` with a seeded ``family`` Vocoder at the same widths.
    BigVGAN-v2 scales by its own max_wav_value, 32767 (NVIDIA/BigVGAN
    meldataset.py): its clamped +1.0 stays +32767 where 32768 would wrap."""
    import copy

    from tts_king_torch.pipeline import Vocoder

    other = copy.copy(king)
    other.cfg = copy.deepcopy(king.cfg)
    other.cfg.model.vocoder_model = family
    if family == "BigVGAN":
        other.cfg.vocoder.max_wav_value = 32767.0
    other.vocoder = Vocoder(other.cfg, device="cpu")
    return other


@pytest.mark.parametrize("family", ["HiFi-GAN", "MelGAN", "BigVGAN"])
def test_stream_speculative_first_window(king, monkeypatch, family):
    """Time to first audio: with a long utterance (mel covers chunk+halo
    frames) the speculative first window fires for every vocoder family
    (MelGAN's log10 prep is the Vocoder's own), and the streamed audio
    still matches the plain stream at every sample."""
    from tts_king_torch.ops.streaming import stream_vocoder
    from tts_king_torch.serve import SynthesisServer

    if family != king.cfg.model.vocoder_model:
        king = _with_vocoder(king, family)
    rng = np.random.RandomState(11)
    phonemes = rng.randint(10, 100, size=(48,))
    halo = king.vocoder.halo_frames
    chunk = 16

    server = SynthesisServer(king, max_batch=4)
    windows = []
    first_window = server._first_window
    monkeypatch.setattr(server, "_first_window",
                        lambda *a: windows.append(a) or first_window(*a))
    try:
        spec_chunks = list(server.stream(phonemes=phonemes,
                                         chunk_frames=chunk))
        out = king.tts.generate(np.asarray(phonemes, np.int32)[None],
                                speaker_name=0)
        n = int(out["mel_lens"][0])
        assert n >= chunk + halo, "fixture too short to exercise the path"
        assert windows, "the speculative window was not dispatched"
        mel = out["postnet_mel"].float().numpy()[:1, :n]
        hop = king.cfg.preprocess.stft.hop_length
        scale = king.cfg.vocoder.max_wav_value
        ref_chunks = [
            (np.asarray(c, np.float32) * scale).astype(np.int16)
            for c in stream_vocoder(lambda p: king.vocoder(p).numpy(), mel,
                                    chunk_frames=chunk, halo_frames=halo,
                                    hop=hop)]
    finally:
        server.close()

    got = np.concatenate(spec_chunks)
    want = np.concatenate(ref_chunks)
    assert got.shape == want.shape
    assert np.mean(np.abs(got.astype(np.int32)
                          - want.astype(np.int32)) > 1) < 0.001


def test_optimal_buckets_dp():
    """Exact DP beats the power-of-2 grid on a skewed distribution and
    reproduces trivial cases."""
    from tts_king_torch.pipeline import _phone_pad
    from tts_king_torch.serve import optimal_buckets

    assert optimal_buckets([5, 5, 9], 4) == [5, 9]
    tops = optimal_buckets([3, 3, 3, 3, 100], 2)
    assert tops[-1] == 100 and 3 in tops
    rng = np.random.RandomState(0)
    lens = np.concatenate([np.full(90, 17), rng.randint(40, 48, 10)])
    tops = optimal_buckets(lens, 3)
    dp_cost = sum(min(t for t in tops if t >= n) for n in lens)
    pow2_cost = sum(_phone_pad(n) for n in lens)
    assert dp_cost < 0.75 * pow2_cost
    assert max(lens) <= tops[-1]


def test_suggest_buckets_from_load(king):
    """The server derives better padding grids from its recorded load and
    tuned grids actually drive the pipeline."""
    from tts_king_torch.serve import SynthesisServer

    server = SynthesisServer(king, max_batch=4)
    try:
        rng = np.random.RandomState(2)
        futures = [server.submit(phonemes=rng.randint(64, 200, size=(18,)))
                   for _ in range(12)]
        for f in futures:
            f.result(timeout=300)
        sug = server.suggest_buckets(k_batch=2, k_len=2)
    finally:
        server.close()
    assert sug["n_requests"] == 12 and sug["n_dispatches"] >= 1
    assert sug["phone_buckets"][-1] == 18
    assert sug["phone_padded_ratio_vs_current"] < 1.0  # beats pow2 (32)
    assert 1 in sug["batch_buckets"]

    king.tts.phone_buckets = sug["phone_buckets"]
    try:
        out = king.tts.generate(np.asarray([[70] * 18], np.int32),
                                speaker_name=0, defer_overflow=True)
        # L padded to exactly 18 (the tuned top), not 32
        assert out["duration_rounded"].shape[1] == 18
    finally:
        king.tts.phone_buckets = None


def test_drain_and_serving_state_roundtrip(king, tmp_path):
    """drain() completes admitted work while rejecting new submissions,
    save_serving_state() persists the tuned grids, and
    from_serving_state() builds a replacement server that adopts them and
    answers identically."""
    from tts_king_torch.serve import ServerDraining, SynthesisServer

    phon = np.array([70, 80, 90, 100, 80, 70])
    server = SynthesisServer(king, max_batch=4)
    try:
        rng = np.random.RandomState(3)
        futures = [server.submit(phonemes=rng.randint(64, 200, size=(14,)))
                   for _ in range(8)]
        ref_wav = server.submit(phonemes=phon).result(timeout=300)
        king.tts.phone_buckets = [14, 48]   # pretend autotune was applied
        stats = {}
        t = threading.Thread(
            target=lambda: stats.update(server.drain(timeout=120)))
        t.start()
        for f in futures:
            assert f.result(timeout=300).dtype == np.int16
        t.join(timeout=120)
        assert not t.is_alive()
        assert stats["completed"] >= 9 and stats["queued"] == 0
        with pytest.raises(ServerDraining):
            server.submit(phonemes=phon)
        path = str(tmp_path / "serving_state.json")
        saved = server.save_serving_state(path)
        assert saved["phone_buckets"] == [14, 48]
        assert saved["suggested"]["n_requests"] >= 9
    finally:
        server.close()
        king.tts.phone_buckets = None

    state = SynthesisServer.load_serving_state(path)
    server2 = SynthesisServer.from_serving_state(king, state, prewarm=False,
                                                 max_batch=4)
    try:
        assert king.tts.phone_buckets == [14, 48]
        wav2 = server2.submit(phonemes=phon).result(timeout=300)
    finally:
        server2.close()
        king.tts.phone_buckets = None
    # Identical model -> identical audio for the same request, even though
    # the adopted grid pads the phonemes differently (masking exactness).
    assert np.array_equal(wav2, ref_wav)


def test_tuned_grid_pads_up_beyond_top(king):
    """A request longer than the tuned grid's top pads up via the pow2
    fallback instead of clamping to the grid top."""
    from tts_king_torch.serve import SynthesisServer

    king.tts.phone_buckets = [8, 12]
    try:
        out = king.tts.generate(np.full((1, 20), 70, np.int32),
                                speaker_name=0, defer_overflow=True)
        assert out["duration_rounded"].shape[1] == 32
        server = SynthesisServer(king, max_batch=2)
        try:
            phon = np.arange(64, 84, dtype=np.int32)
            wav = server.submit(phonemes=phon).result(timeout=300)
            assert wav.dtype == np.int16 and wav.size
            chunks = list(server.stream(phonemes=phon))
            assert sum(c.size for c in chunks) > 0
        finally:
            server.close()
    finally:
        king.tts.phone_buckets = None


def test_failed_batches_settle_stats_and_drain(king, monkeypatch):
    """Batches that fail in the dispatcher or the vocoder stage count as
    'failed', so drain()'s settled>=admitted wait ends instead of burning
    its whole timeout."""
    from tts_king_torch.serve import SynthesisServer

    def boom(*a, **k):
        raise RuntimeError("boom")

    for stage in ("_fs2_batch", "_vocode_batch"):
        server = SynthesisServer(king, max_batch=2, max_wait_ms=5)
        try:
            monkeypatch.setattr(server, stage, boom)
            f = server.submit(phonemes=np.array([70, 80, 90]))
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=60)
            t0 = time.monotonic()
            stats = server.drain(timeout=30)
            assert time.monotonic() - t0 < 15, "drain burned its timeout"
            assert stats["failed"] == 1
        finally:
            server.close()


def test_prewarm_covers_raw_length_mel_buckets(king, monkeypatch):
    """The mel bucket comes from the raw request length, so with a tuned
    phone grid a short-but-padded-up request dispatches a lower mel bucket
    than the grid top implies; prewarm must have touched it."""
    from tts_king_torch.serve import SynthesisServer

    shapes = _Shapes(king, monkeypatch)
    king.tts.phone_buckets = [17, 46]
    server = SynthesisServer(king, max_batch=1)
    try:
        server.prewarm(max_phonemes=46)
        warmed_fs2, _ = shapes.snapshot()
        # 20 phonemes -> Lb=46 but T=bucket(20*8)=256, not bucket(46*8)
        out = king.tts.generate(np.full((1, 20), 70, np.int32),
                                speaker_name=0, defer_overflow=True)
        assert out["mel_bucket"] == 256
        assert shapes.fs2 == warmed_fs2, \
            "live request touched a shape prewarm missed"
    finally:
        server.close()
        king.tts.phone_buckets = None


def test_suggest_buckets_ratio_vs_active_grid(king):
    """phone_padded_ratio_vs_current compares against the grid that is
    active on the pipeline (the tuned one after a restart)."""
    from tts_king_torch.serve import SynthesisServer

    king.tts.phone_buckets = [18, 64]
    server = SynthesisServer(king, max_batch=2)
    try:
        futures = [server.submit(phonemes=np.full((18,), 70, np.int32))
                   for _ in range(4)]
        for f in futures:
            f.result(timeout=300)
        sug = server.suggest_buckets(k_len=2)
    finally:
        server.close()
        king.tts.phone_buckets = None
    assert sug["phone_buckets"][-1] == 18
    assert sug["phone_padded_ratio_vs_current"] == 1.0


# ------------------------------------------------ the port against the JAX


@pytest.mark.parametrize("seed,k", [(0, 2), (1, 3), (2, 5), (3, 8)])
def test_optimal_buckets_matches_jax(seed, k):
    from tts_king_torch.serve import optimal_buckets
    from tts_king_tpu.serve import optimal_buckets as jax_optimal_buckets

    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 200, size=rng.randint(1, 300))
    assert optimal_buckets(lens, k) == jax_optimal_buckets(lens, k)


@pytest.mark.parametrize("grid", [None, [], [14, 48], [17, 46, 100],
                                  [8, 12]])
def test_phone_pad_matches_jax(grid):
    from tts_king_torch.pipeline import _phone_pad
    from tts_king_tpu.pipeline import _phone_pad as jax_phone_pad

    rng = np.random.RandomState(5)
    for n in list(rng.randint(1, 1100, size=200)) + [1, 16, 17, 1024]:
        assert _phone_pad(int(n), grid) == jax_phone_pad(int(n), grid)


@pytest.mark.parametrize("guess", [8.0, 1.0])
def test_generate_defer_overflow_matches_jax(kings, monkeypatch, guess):
    """defer_overflow=True runs the first bucket only: the same mel_bucket
    as JAX (an overflowing one when the guess is 1 frame a phoneme) and the
    same mel; without it, both escalate alike."""
    import tts_king_torch.pipeline as pipeline
    import tts_king_tpu.pipeline as jax_pipeline

    jk, pk = kings
    monkeypatch.setattr(pipeline, "_FRAMES_PER_PHONE_GUESS", guess)
    monkeypatch.setattr(jax_pipeline, "_FRAMES_PER_PHONE_GUESS", guess)
    rng = np.random.RandomState(13)
    phonemes = rng.randint(10, 100, size=(2, 40))
    kw = dict(speaker_name=[1, 2], src_lens=[40, 33])
    for defer in (True, False):
        got = pk.tts.generate(phonemes, defer_overflow=defer, **kw)
        want = jk.tts.generate(phonemes, defer_overflow=defer, **kw)
        want_mel = np.asarray(want["postnet_mel"])
        assert got["mel_bucket"] == want_mel.shape[1]
        if defer:
            assert got["mel_bucket"] == want["mel_bucket"]
        raw = np.asarray(want["mel_lens_raw"])
        np.testing.assert_array_equal(got["mel_lens_raw"].numpy(), raw)
        if defer and guess == 1.0:
            assert raw.max() > got["mel_bucket"], "no overflow to defer"
        lens = np.asarray(want["mel_lens"])
        np.testing.assert_array_equal(got["mel_lens"].numpy(), lens)
        for i, n in enumerate(lens):
            mae = np.mean(np.abs(got["postnet_mel"][i, :n].numpy()
                                 - want_mel[i, :n]))
            assert mae < 1e-3, (defer, i, mae)


@pytest.mark.parametrize("k", [0, 1, 2, 5])
def test_stream_vocoder_start_frame(k):
    """start_frame=k*chunk yields exactly the chunks from index k of a run
    from 0, as the JAX stream_vocoder does."""
    from tts_king_torch.ops.streaming import stream_vocoder
    from tts_king_tpu.ops.streaming import stream_vocoder as jax_stream

    rng = np.random.RandomState(k)
    mel = rng.randn(1, 77, 80).astype(np.float32)
    hop, chunk, halo = 4, 16, 5
    w = rng.randn(80, hop).astype(np.float32)

    def vocode(piece):
        return (piece @ w).reshape(1, -1)

    full = list(stream_vocoder(vocode, mel, chunk, halo, hop))
    got = list(stream_vocoder(vocode, mel, chunk, halo, hop,
                              start_frame=k * chunk))
    want = list(jax_stream(lambda _, p: vocode(p), None, mel, chunk, halo,
                           hop, start_frame=k * chunk))
    assert len(got) == len(full[k:]) == len(want)
    for a, b, c in zip(got, full[k:], want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def _serve_all(server, requests):
    futures = [server.submit(phonemes=p, speaker=s, duration_control=d)
               for p, s, d in requests]
    return [f.result(timeout=300) for f in futures]


def test_served_mels_match_jax(kings):
    """Both servers (mel mode) serve 8 requests over 3 speakers and 2
    duration controls: equal mel lengths, mel MAE < 1e-3 per request."""
    from tts_king_torch.serve import SynthesisServer
    from tts_king_tpu.serve import SynthesisServer as JaxServer

    jk, pk = kings
    rng = np.random.RandomState(21)
    requests = [(rng.randint(10, 100, size=(rng.randint(10, 17),)), i % 3,
                 (1.0, 1.2)[i % 2]) for i in range(8)]
    out = {}
    for name, cls, king in (("port", SynthesisServer, pk),
                            ("jax", JaxServer, jk)):
        # one window gathers all 8: two control groups of 4
        server = cls(king, max_batch=8, max_wait_ms=500, policy="window",
                     return_wav=False)
        try:
            out[name] = _serve_all(server, requests)
        finally:
            server.close()
    for (mel, n), (jmel, jn) in zip(out["port"], out["jax"]):
        assert n == jn and mel.shape == (n, 80)
        mae = float(np.mean(np.abs(mel - np.asarray(jmel, np.float32))))
        assert mae < 1e-3, mae


def test_stream_matches_jax(kings):
    """stream() on both servers, speculative first window included: equal
    lengths, > 2 LSB apart at under 1% of the interior samples."""
    from tts_king_torch.serve import SynthesisServer
    from tts_king_tpu.serve import SynthesisServer as JaxServer

    jk, pk = kings
    phonemes = np.random.RandomState(11).randint(10, 100, size=(48,))
    out = {}
    for name, cls, king in (("port", SynthesisServer, pk),
                            ("jax", JaxServer, jk)):
        server = cls(king, max_batch=2)
        try:
            out[name] = np.concatenate(list(server.stream(
                phonemes=phonemes, speaker=2, chunk_frames=16)))
        finally:
            server.close()
    got, want = out["port"], out["jax"]
    assert got.dtype == np.int16 and got.shape == want.shape
    lo, hi = len(got) // 4, 3 * len(got) // 4
    off = float(np.mean(np.abs(got[lo:hi].astype(np.int32)
                               - want[lo:hi].astype(np.int32)) > 2))
    assert off < 0.01, off


def test_bad_ids_are_refused_on_the_host(king):
    """An out-of-range speaker or phoneme id is a ValueError on the host:
    submit() refuses it before it joins a batch, generate() before any
    device work (on the card it would be a device-side assert)."""
    from tts_king_torch.serve import SynthesisServer

    with pytest.raises(ValueError, match="speaker"):
        king.tts.generate(np.array([[70, 80]]), speaker_name=N_SPEAKERS)
    with pytest.raises(ValueError, match="phoneme"):
        king.tts.generate(np.array([[70, 100000]]), speaker_name=0)
    server = SynthesisServer(king, max_batch=2)
    try:
        for kw in ({"speaker": N_SPEAKERS}, {"speaker": -1},
                   {"phonemes": np.array([70, -3])}):
            kw.setdefault("phonemes", np.array([70, 80, 90]))
            with pytest.raises(ValueError):
                server.submit(**kw)
            with pytest.raises(ValueError):
                next(server.stream(**kw))
        assert server.stats()["admitted"] == 0
        wav = server.submit(phonemes=np.array([70, 80, 90]),
                            speaker=N_SPEAKERS - 1).result(timeout=120)
        assert wav.dtype == np.int16 and wav.size
    finally:
        server.close()


# ------------------------------------------------------- threads, entries


def test_build_load_builds_once_across_threads(monkeypatch):
    """Two threads reaching a kernel's first launch together: one builds
    and binds it, the other gets the same library."""
    from tts_king_torch.ops.kernels import _build

    builds, barrier = [], threading.Barrier(2)

    def build(names):
        builds.append(list(names))
        time.sleep(0.2)      # the other thread arrives meanwhile
        return {}

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build, "bind", lambda name, path: object())
    monkeypatch.setattr(_build, "_libs", {})
    got = []

    def first_launch():
        barrier.wait(timeout=30)
        got.append(_build.load("attention"))

    threads = [threading.Thread(target=first_launch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert builds == [["attention"]]
    assert len(got) == 2 and got[0] is got[1]


def test_count_launch_exact_under_threads():
    """count_launch loses no count with more threads than cores and a
    short switch interval."""
    from tts_king_torch.ops.kernels import _build

    counts = {"launches": 0}
    n_threads, n_each = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(counts) for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counts["launches"] == n_threads * n_each


def test_server_defaults_to_cuda_and_cli_help(capsys):
    """SynthesisServer(TTSKing(cfg)) with no device asks for CUDA, which
    raises without it; the CLI parses the JAX server's flags and --device."""
    from tts_king_torch.config import micro_config
    from tts_king_torch.pipeline import TTSKing
    from tts_king_torch.serve import SynthesisServer, main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SynthesisServer(TTSKing(micro_config()))
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    for flag in ("--bf16", "--prewarm", "--state-file", "--max-batch",
                 "--admission-depth", "--default-deadline-ms",
                 "--drain-timeout", "--device"):
        assert flag in text
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--port", "0"])
