"""Dynamic-batching synthesis server on one CUDA card.

Port of tts_king_tpu/serve.py. Requests (text or phoneme IDs, per-request
speaker and prosody controls) are queued, grouped into padded batches (a
few shapes per bucket grid) and pipelined through the card.

Scheduling (policy="continuous", the default):
  * a batch forms from whatever is queued right now (no fixed wait): under
    load the card's own compute time accumulates the next batch, so batches
    grow to max_batch by themselves without adding latency;
  * while the in-flight pipeline is full, arrivals keep being admitted into
    the forming batch (that waiting is free: dispatch would block anyway);
  * large mixed-length batches split at phoneme-bucket boundaries when that
    lowers the padded compute (B x bucket(max L));
  * a three-stage thread pipeline with bounded queues: FS2 dispatch (no
    host round trip: the overflow check is deferred), a vocoder stage that
    waits for FS2(i)'s lengths while FS2(i+1) is dispatched, slices the mel
    to the tightest bucket the realized lengths allow (the FS2 bucket is a
    conservative 8 frames a phoneme) and dispatches the vocoder, and a
    completer that fetches wav(i-1): dispatch, FS2, vocoder and fetch all
    overlap.

A king built over a dp mesh (``TTSKing(mesh=...)``, parallel/mesh.py)
serves each batch's rows across the mesh's replicas; its results are the
single-device server's, and ``stream()`` then runs FastSpeech2 and the first
window as two dispatches (the fused head is off, as in the JAX server).

policy="window" is the older scheduler (wait out max_wait_ms per batch) for
A/B runs. Requests with identical control knobs are batched together:
mixing controls within a batch would change per-item outputs.

The card: one thread of the server issues all its device work (``_device``:
the stages' FS2 and vocoder dispatches, ``stream()``'s, ``prewarm``'s), in
inference mode, to one CUDA stream the server owns. PyTorch keeps cuDNN's
and cuBLAS's handles and cuDNN's execution plans per thread, so work issued
from many threads (the stages, a fresh HTTP handler thread per ``/stream``)
would build them again in each, and ``prewarm`` would warm a thread that
serves nothing. A host copy of a CUDA tensor (``.cpu()``, ``int(t)``) waits
for everything queued on the stream, FS2(i+1) and vocoder(i+1) included, so
no stage makes one: right after a dispatch the device thread starts the
copy of what the next stage needs into pinned host memory and records an
event (``_Fetch``), and the next stage waits for that event on its own
thread. Inputs go up through pinned memory too (``pipeline.to_device``). On
the CPU (tests) there is no stream and nothing to wait for. A failure in
any stage fails the futures of its batch with that exception; nothing
falls back to the CPU or to a kernel's plain version.
"""

import itertools
import json
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from tts_king_torch import pipeline
from tts_king_torch.ops.kernels import _build
from tts_king_torch.ops.streaming import stream_vocoder
from tts_king_torch.utils.profiling import span

_now = time.monotonic
# The CUDA kernels of the serving path (FS2 attention, the HiFi-GAN MRF
# stage), built by prewarm before traffic.
_KERNELS = ("attention", "mrf_stage")


def optimal_buckets(values, k: int):
    """Choose <=k bucket tops from observed integer sizes minimizing the
    total padded sum (every value pads up to the smallest chosen top >= it;
    the max must be a top). Exact O(U^2 k) DP over the U unique values:
    the basis of load-derived padding grids (suggest_buckets)."""
    vals = np.asarray(sorted(values), dtype=np.int64)
    if len(vals) == 0:
        return []
    uniq, counts = np.unique(vals, return_counts=True)
    U = len(uniq)
    if U <= k:
        return [int(u) for u in uniq]
    csum = np.concatenate([[0], np.cumsum(counts)])

    def cost(i, j):     # values in uniq[i..j] all pad to uniq[j]
        return int(uniq[j]) * int(csum[j + 1] - csum[i])

    INF = float("inf")
    # dp[j][m]: min cost covering uniq[0..j] with m tops, top at j
    dp = [[INF] * (k + 1) for _ in range(U)]
    arg = [[None] * (k + 1) for _ in range(U)]
    for j in range(U):
        dp[j][1] = cost(0, j)
    for m in range(2, k + 1):
        for j in range(m - 1, U):
            best, bi = INF, None
            for i in range(m - 2, j):
                c = dp[i][m - 1] + cost(i + 1, j)
                if c < best:
                    best, bi = c, i
            dp[j][m] = best
            arg[j][m] = bi
    m = min(k, U)
    tops = [int(uniq[U - 1])]
    j = U - 1
    while m > 1:
        i = arg[j][m]
        tops.append(int(uniq[i]))
        j, m = i, m - 1
    return sorted(tops)


class ServerOverloaded(RuntimeError):
    """Admission queue is full: the request was rejected, not enqueued.

    Clients should back off and retry (the HTTP front maps this to 429)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it was dispatched; no device
    compute was spent on it (HTTP front: 504)."""


class ServerDraining(RuntimeError):
    """The server is draining for shutdown/restart: no new admissions,
    queued work still completes (HTTP front: 503, no Retry-After)."""


@dataclass
class _Request:
    phonemes: np.ndarray        # (L,) int
    speaker: int
    controls: tuple             # (duration, pitch, energy)
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=_now)
    deadline: Optional[float] = None    # absolute monotonic time, or None


class _Fetch:
    """Host copies of device tensors, started without waiting for the card:
    on CUDA each goes into a new pinned buffer (``non_blocking``) on the
    current stream, and an event is recorded after them. ``wait()`` waits
    for that event only and returns the numpy arrays."""

    def __init__(self, *tensors):
        if all(t.device.type == "cpu" for t in tensors):
            self._host, self._event = list(tensors), None
            return
        self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                      for t in tensors]
        for h, t in zip(self._host, tensors):
            h.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class SynthesisServer:
    """Batched text->wav serving on top of pipeline.TTSKing, on the king's
    device.

    Overload safety: admission is bounded (`admission_depth` waiting
    requests; beyond that submit() raises ServerOverloaded immediately
    instead of growing the queue and every latency with it), and requests
    may carry deadlines: a request whose deadline passes while queued is
    shed at dispatch time with DeadlineExceeded, spending no device compute.
    Counters for admitted/rejected/shed/completed/failed are in stats(),
    with the load's: batches and the requests in them, overflow redos, the
    requests' queue wait, the device thread's busy time and G2P time.

    Under a profiler (``utils.profiling.trace``) the stages leave spans,
    each with its batch's id (one per batch ``_gather_batch`` forms; the
    length groups it splits into share it): ``serve.gather`` (dispatcher),
    ``serve.fs2`` and ``serve.vocoder`` (device thread),
    ``serve.lengths_wait`` and ``serve.redo`` (vocoder stage),
    ``serve.fetch_wait`` (completer), and ``serve.stream`` per stream() call.
    """

    def __init__(self, king, max_batch: int = 16, max_wait_ms: float = 10.0,
                 return_wav: bool = True, policy: str = "continuous",
                 pipeline_depth: int = 2, batch_buckets=None,
                 admission_depth: int = 128,
                 default_deadline_ms: Optional[float] = None):
        if policy not in ("continuous", "window"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        self.king = king
        # the one stream all device work goes to (CUDA only)
        device = king.tts.device
        self._stream = (torch.cuda.Stream(device)
                        if device.type == "cuda" else None)
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.return_wav = return_wav
        self.policy = policy
        self.admission_depth = admission_depth
        self.default_deadline = (default_deadline_ms / 1000.0
                                 if default_deadline_ms else None)
        self._stats_lock = threading.Lock()
        self._counters = {"admitted": 0, "rejected": 0, "shed": 0,
                          "completed": 0, "failed": 0, "batches": 0,
                          "batched_requests": 0, "overflow_redos": 0,
                          "queue_wait_s": 0.0, "device_busy_s": 0.0,
                          "g2p_s": 0.0}
        self._t_start = _now()
        # one id per formed batch and per stream() call, for their spans
        self._ids = itertools.count(1)
        # Batches pad up to one of these sizes: few shapes to warm (kernel
        # plans, cuDNN's algorithm choice, the allocator's pools), and
        # padded rows cost little (device compute is sublinear in B).
        self.batch_buckets = sorted(batch_buckets or
                                    {1, 4, max_batch} | {max_batch})
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=admission_depth)
        # Load traces for bucket autotuning (suggest_buckets): per-request
        # phoneme lengths and per-dispatch formed batch sizes.
        self._trace_lens: deque = deque(maxlen=8192)
        self._trace_batches: deque = deque(maxlen=2048)
        # 3-stage pipeline: dispatcher -> _mid (FS2 in flight) -> vocoder
        # thread -> _inflight (vocoder in flight) -> completer.
        self._mid: "queue.Queue" = queue.Queue(maxsize=pipeline_depth)
        self._inflight: "queue.Queue" = queue.Queue(maxsize=pipeline_depth)
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._prewarmed: Optional[dict] = None
        # the device thread's jobs: (fn, future), then None at close()
        self._device_jobs: "queue.Queue" = queue.Queue()
        self._device_lock = threading.Lock()
        self._device_closed = False
        self._device_thread = threading.Thread(target=self._device_loop,
                                               daemon=True)
        self._device_thread.start()
        self._threads = [threading.Thread(target=stage, daemon=True)
                         for stage in (self._dispatcher, self._vocoder_stage,
                                       self._completer)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- public

    def submit(self, text: Optional[str] = None, phonemes=None, speaker=0,
               duration_control=1.0, pitch_control=1.0,
               energy_control=1.0, deadline_ms: Optional[float] = None
               ) -> Future:
        """Enqueue one utterance; resolves to an int16 wav (or (mel,
        mel_len), the mel float32 whatever the server's dtype).

        Raises ServerOverloaded when `admission_depth` requests are already
        waiting. deadline_ms (relative to now) bounds queueing: a request
        still undispatched past its deadline fails with DeadlineExceeded.
        """
        if self._draining.is_set():
            raise ServerDraining(
                "server is draining; resubmit to its replacement")
        if self._stop.is_set():
            raise RuntimeError("server is closed")
        if phonemes is None:
            if text is None:
                raise ValueError("need text or phonemes")
            phonemes = self._g2p(text)
        if isinstance(speaker, str):
            speaker = self.king.tts.speakers_dict[speaker]
        # a bad id would fail the whole batch it joins: refuse it here
        self.king.tts.check_ids(np.asarray(phonemes, np.int32), int(speaker))
        req = _Request(np.asarray(phonemes, np.int32), int(speaker),
                       (float(duration_control), float(pitch_control),
                        float(energy_control)))
        if deadline_ms is not None:
            req.deadline = req.t_submit + deadline_ms / 1000.0
        elif self.default_deadline is not None:
            req.deadline = req.t_submit + self.default_deadline
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            with self._stats_lock:
                self._counters["rejected"] += 1
            raise ServerOverloaded(
                f"admission queue full ({self.admission_depth} requests "
                f"waiting); retry with backoff") from None
        with self._stats_lock:
            self._counters["admitted"] += 1
        self._trace_lens.append(len(req.phonemes))
        return req.future

    def suggest_buckets(self, k_batch: int = 3, k_len: int = 5) -> dict:
        """Derive padding grids from the measured load instead of the
        static {1,4,max} x pow2 defaults: exact-DP bucket tops minimizing
        total padded work over the recorded traces (per-request phoneme
        lengths, per-dispatch formed batch sizes). Returns the suggestion
        plus the padded-work ratio vs the current grids; apply by
        constructing the next server with batch_buckets=... and setting
        king.tts.phone_buckets (each new bucket is a shape to warm, so this
        is an explicit operation, not continuous adaptation)."""
        lens = list(self._trace_lens)
        batches = list(self._trace_batches)
        out = {"n_requests": len(lens), "n_dispatches": len(batches)}
        if lens:
            tops = optimal_buckets(lens, k_len)
            # "current" = what this server actually pads to (the tuned
            # grid when one is active, pow2 default else): _pbucket
            cur = sum(self._pbucket(n) for n in lens)
            new = sum(pipeline._bucket(n, tops) for n in lens)
            out["phone_buckets"] = tops
            out["phone_padded_ratio_vs_current"] = round(new / max(cur, 1), 4)
        if batches:
            tops = optimal_buckets(batches, k_batch)
            if 1 not in tops:            # keep a singles lane
                tops = [1] + tops
            cur = sum(next((x for x in self.batch_buckets if x >= b), b)
                      for b in batches)
            new = sum(pipeline._bucket(b, tops) for b in batches)
            out["batch_buckets"] = tops
            out["batch_padded_ratio_vs_current"] = round(new / max(cur, 1), 4)
        return out

    def prewarm(self, max_phonemes: int = 64, batch_sizes=None,
                mel_buckets=None, duration_controls=(1.0,)) -> dict:
        """Touch every (batch-bucket, phoneme-bucket, mel-bucket) FS2 shape
        and (batch-bucket, mel-bucket) vocoder shape this server can
        dispatch, before taking traffic.

        Nothing is compiled per shape here, but a shape's first touch still
        costs: the kernels' build (nvcc, seconds; done first, all sources
        together), cuDNN's algorithm choice and the caching allocator's
        growth. Every request queued behind a first touch waits for it. The
        runs go through the calls the serving threads make
        (AcousticModel.generate, Vocoder.vocode_int16) on the server's
        device thread and stream, then the stream is synchronized.

        The vocoder is warmed on the real FS2 output sliced to each mel
        bucket (the dtype and layout the vocoder stage dispatches), not on
        synthetic zeros.

        duration_controls: the d-control values to cover. generate()
        derives the mel bucket from the raw (pre-padding) request length
        times d_control, not from the padded length, so for each phone
        bucket the whole span T(shortest raw length mapping to it) ..
        T(bucket top) is warmed, plus one bucket above it (an overflow
        redo), so neither a short-but-padded-up request nor a rare
        deferred-overflow redo touches a new shape mid-traffic. Returns the
        warmed shape grids."""
        if self._stream is not None:
            _build.build(_KERNELS)
        bsizes = sorted(set(batch_sizes or self.batch_buckets))
        pbs = sorted({self._pbucket(n) for n in range(1, max_phonemes + 1)})
        warmed_mels = set()

        def warm():
            for B in bsizes:
                mel = None
                prev_pb = 0
                for Lb in pbs:
                    # Shortest raw length padded to Lb is prev_pb+1; its mel
                    # bucket is the lowest this (B, Lb) pair can dispatch.
                    lens = [prev_pb + 1, Lb]
                    ts = [pipeline._bucket(
                              int(n * pipeline._FRAMES_PER_PHONE_GUESS * d),
                              pipeline.MEL_BUCKETS)
                          for d in duration_controls for n in lens]
                    t_lo, t_hi = min(ts), max(ts)
                    span = [b for b in pipeline.MEL_BUCKETS if t_lo <= b]
                    span = span[: len([b for b in span if b <= t_hi]) + 1]
                    prev_pb = Lb
                    for T in span:
                        out = self.king.tts.generate(
                            np.ones((B, Lb), np.int32),
                            src_lens=np.full((B,), Lb, np.int32),
                            speaker_name=[0] * B, defer_overflow=True,
                            max_mel_len=T)
                        if (mel is None or
                                out["postnet_mel"].shape[1] > mel.shape[1]):
                            mel = out["postnet_mel"]
                mbs = [b for b in (mel_buckets or pipeline.MEL_BUCKETS)
                       if b <= mel.shape[1]] or [mel.shape[1]]
                for T in mbs:
                    # the int16 call _vocode_batch dispatches
                    self.king.vocoder.vocode_int16(mel[:, :T])
                    warmed_mels.add(T)
            if self._stream is not None:
                self._stream.synchronize()

        self._device(warm)
        self._prewarmed = {"batch_buckets": bsizes, "phone_buckets": pbs,
                           "mel_buckets": sorted(warmed_mels),
                           "max_phonemes": max_phonemes}
        return dict(self._prewarmed)

    def stats(self) -> dict:
        """Counters, the current queue depth and the seconds since the
        server started. Besides admission and shedding: ``batches`` and
        ``batched_requests`` (FS2 batches dispatched and the requests in
        them: their ratio is the formed batch size), ``overflow_redos``
        (batches whose mel bucket overflowed, dispatched again),
        ``queue_wait_s`` (submit to FS2 dispatch, summed over the
        dispatched requests), ``device_busy_s`` (the device thread's time
        inside jobs: over ``uptime_s``, its busy share) and ``g2p_s`` (G2P
        of the requests submitted as text)."""
        with self._stats_lock:
            out = dict(self._counters)
        out["queued"] = self._queue.qsize()
        out["admission_depth"] = self.admission_depth
        out["uptime_s"] = _now() - self._t_start
        return out

    def _g2p(self, text):
        """The phonemes of ``text``, its G2P time counted."""
        t0 = _now()
        phonemes = self.king.text_preprocess(text)[0]
        with self._stats_lock:
            self._counters["g2p_s"] += _now() - t0
        return phonemes

    def synthesize_many(self, texts: Sequence[str], speakers=None,
                        **controls):
        """Blocking convenience API: submit all, wait for all."""
        speakers = speakers if speakers is not None else [0] * len(texts)
        futures = [self.submit(t, speaker=s, **controls)
                   for t, s in zip(texts, speakers)]
        return [f.result() for f in futures]

    def stream(self, text: Optional[str] = None, phonemes=None, speaker=0,
               duration_control=1.0, pitch_control=1.0,
               energy_control=1.0, chunk_frames: int = 64):
        """Low-latency streaming endpoint: bypasses the batching pipeline
        and yields int16 waveform chunks as they are vocoded
        (ops/streaming.py). Safe to call while batched traffic flows, from
        any thread: its device work goes through the server's device thread
        and stream, between the batches'.

        Time to first audio: the first vocoder window is dispatched
        speculatively on the FS2 mel still on the card, queued right behind
        FS2 with no host round trip, and one pinned fetch brings back the
        realized lengths and that window together: dispatch -> dispatch ->
        wait instead of dispatch -> wait -> dispatch -> wait. The window is
        used only when it is provably exact (the utterance covers chunk +
        halo frames, no mel-bucket overflow); otherwise the plain path runs,
        with the same output either way."""
        with span("serve.stream", next(self._ids)):
            if self._draining.is_set():
                raise ServerDraining(
                    "server is draining; resubmit to its replacement")
            if self._stop.is_set():
                raise RuntimeError("server is closed")
            if phonemes is None:
                if text is None:
                    raise ValueError("need text or phonemes")
                phonemes = self._g2p(text)
            if isinstance(speaker, str):
                speaker = self.king.tts.speakers_dict[speaker]
            phonemes = np.asarray(phonemes, np.int32)
            controls = (float(duration_control), float(pitch_control),
                        float(energy_control))
            generate_kw = dict(duration_control=controls[0],
                               pitch_control=controls[1],
                               energy_control=controls[2],
                               speaker_name=int(speaker))
            halo = self.king.vocoder.halo_frames
            hop = self.king.cfg.preprocess.stft.hop_length

            def head():
                fused = self._fused_stream_head(phonemes, speaker, controls,
                                                chunk_frames, halo)
                if fused is not None:
                    out, win0, bucket = fused
                else:
                    out = self.king.tts.generate(phonemes[None],
                                                 defer_overflow=True,
                                                 **generate_kw)
                    bucket = out["mel_bucket"]
                    win0 = None
                    if bucket >= chunk_frames + halo:
                        win0 = self._first_window(out["postnet_mel"],
                                                  chunk_frames, halo)
                # one fetch for everything the first yield needs
                fetch = [out["mel_lens_raw"], out["mel_lens"]]
                if win0 is not None:
                    fetch.append(win0)
                return out, bucket, win0 is not None, _Fetch(*fetch)

            def redo():
                out = self.king.tts.generate(phonemes[None], **generate_kw)
                return out, _Fetch(out["mel_lens"])

            def mel_to_host(out, n):
                return _Fetch(out["postnet_mel"][:1, :max(n, 1)].float())

            out, bucket, has_win0, fetch = self._device(head)
            fetched = fetch.wait()
            win0_host = fetched[2] if has_win0 else None
            if int(fetched[0][0]) > bucket:
                # Rare mel-bucket overflow: redo with escalated buckets,
                # discard the speculative window.
                out, lens_fetch = self._device(redo)
                win0_host = None
                n = int(lens_fetch.wait()[0][0])
            else:
                n = int(fetched[1][0])
            # the mel's copy to the host overlaps the first chunk's handling
            mel_fetch = self._device(lambda: mel_to_host(out, n))

            start_frame = 0
            if win0_host is not None and n >= chunk_frames + halo:
                # exact: all chunk + halo window frames are real mel content
                yield win0_host[0, halo * hop:
                                (halo + chunk_frames) * hop].copy()
                start_frame = chunk_frames
            # Vocoder.vocode_int16 divides a MelGAN mel by ln 10 itself
            yield from stream_vocoder(self._vocode_window,
                                      mel_fetch.wait()[0],
                                      chunk_frames=chunk_frames,
                                      halo_frames=halo, hop=hop,
                                      start_frame=start_frame)

    def _vocode_window(self, piece):
        """(1, frames, n_mels) numpy mel window -> (1, frames * hop) int16
        numpy waveform, through the server's device thread."""
        return self._device(
            lambda: _Fetch(self.king.vocoder.vocode_int16(piece))).wait()[0]

    def _fused_stream_head(self, phonemes, speaker, controls,
                           chunk_frames: int, halo: int):
        """FS2 forward and the first vocoder window, queued back to back
        with no host sync between them: one dispatch sequence produces
        (mel, lens, first audio window). Returns (out_dict, window_wav,
        mel_bucket), or None where it does not apply (a mesh, whose
        inference splits the batch's rows, or a first bucket shorter than
        chunk + halo frames). Whether the window is exact is
        decided in stream()."""
        if getattr(self.king.tts, "mesh", None) is not None:
            return None
        L = len(phonemes)
        guess = int(L * pipeline._FRAMES_PER_PHONE_GUESS * controls[0])
        T = min(pipeline._bucket(guess, pipeline.MEL_BUCKETS),
                self.king.cfg.model.max_seq_len)
        if T < chunk_frames + halo:
            return None
        out = self.king.tts.generate(
            phonemes[None], duration_control=controls[0],
            pitch_control=controls[1], energy_control=controls[2],
            speaker_name=int(speaker), max_mel_len=T, defer_overflow=True)
        return out, self._first_window(out["postnet_mel"], chunk_frames,
                                       halo), T

    def _first_window(self, mel_dev, chunk_frames: int, halo: int):
        """Dispatch the vocoder on mel frames [0, chunk + halo) with the left
        halo made on the device by repeating frame 0, reading the FS2 output
        still on the card: no host transfer in between."""
        mel = mel_dev[:1]
        left = mel[:, :1].expand(-1, halo, -1)
        window = torch.cat([left, mel[:, :chunk_frames + halo]], dim=1)
        return self.king.vocoder.vocode_int16(window)

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        with self._device_lock:
            self._device_closed = True
            self._device_jobs.put(None)
        self._device_thread.join(timeout=10)

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Graceful shutdown, phase 1: stop admitting (submit raises
        ServerDraining -> HTTP 503), let everything already admitted run
        to completion, then stop the pipeline threads. Returns final
        stats. With `timeout`, returns once the clock runs out even if
        work remains queued (callers can check stats()["queued"]).

        The restart half: pair with save_serving_state() /
        load_serving_state() so the next process starts with this one's
        tuned padding grids and prewarms exactly the shapes that carried
        real traffic (main()'s --state-file does both ends)."""
        self._draining.set()
        deadline = None if timeout is None else _now() + timeout
        while deadline is None or _now() < deadline:
            with self._stats_lock:
                c = dict(self._counters)
            settled = c["completed"] + c["failed"] + c["shed"]
            if (settled >= c["admitted"] and self._queue.empty()
                    and self._mid.empty() and self._inflight.empty()):
                break
            time.sleep(0.02)
        self.close()
        return self.stats()

    def save_serving_state(self, path: str) -> dict:
        """Persist what this process learned about its load so a restart
        skips the warmup cliff: tuned padding grids (the active ones, plus
        fresh suggest_buckets() output from the recorded traces) and the
        prewarm grid. JSON, human-editable."""
        state = {
            "batch_buckets": self.batch_buckets,
            "phone_buckets": getattr(self.king.tts, "phone_buckets", None),
            "prewarm": self._prewarmed,
            "suggested": self.suggest_buckets(),
            "stats": self.stats(),
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, path)
        return state

    @staticmethod
    def load_serving_state(path: str) -> dict:
        with open(path) as f:
            return json.load(f)

    @classmethod
    def from_serving_state(cls, king, state: dict, prewarm: bool = True,
                           **kw):
        """Construct a server adopting a previous process's tuned grids
        (preferring its live grids, falling back to its recorded
        suggestions), then prewarm the same shape grid that carried the
        previous process's traffic."""
        suggested = state.get("suggested") or {}
        batch_buckets = (state.get("batch_buckets")
                         or suggested.get("batch_buckets"))
        phone_buckets = (state.get("phone_buckets")
                         or suggested.get("phone_buckets"))
        if phone_buckets:
            king.tts.phone_buckets = sorted(phone_buckets)
        if batch_buckets:
            kw.setdefault("batch_buckets", sorted(batch_buckets))
        server = cls(king, **kw)
        pw = state.get("prewarm")
        if prewarm and pw:
            server.prewarm(max_phonemes=pw.get("max_phonemes", 64),
                           batch_sizes=pw.get("batch_buckets"),
                           mel_buckets=pw.get("mel_buckets"))
        return server

    # --------------------------------------------------------- scheduling

    def _gather_batch(self):
        """Collect the next batch according to the scheduling policy.
        Returns (the batch's id, its list of requests), or None when no
        request came."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return None
        ident = next(self._ids)
        batch = [first]
        with span("serve.gather", ident):
            if self.policy == "window":
                # wait out max_wait_ms hoping for company
                deadline = _now() + self.max_wait
                while len(batch) < self.max_batch:
                    timeout = deadline - _now()
                    if timeout <= 0:
                        break
                    try:
                        batch.append(self._queue.get(timeout=timeout))
                    except queue.Empty:
                        break
                return ident, batch

            # Continuous: drain what's already here without waiting...
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            # ...and while the pipeline is full (dispatch would block
            # anyway), keep admitting arrivals into this batch for free, in
            # coarse 50 ms waits (a fine-grained poll burns the host CPU the
            # other stages need).
            while (len(batch) < self.max_batch and self._mid.full()
                   and not self._stop.is_set()):
                try:
                    batch.append(self._queue.get(timeout=0.05))
                except queue.Empty:
                    pass
            return ident, batch

    # ------------------------------------------------------------ threads

    def _device(self, fn):
        """fn() run on the server's device thread; its result, or its
        exception raised here."""
        future = Future()
        with self._device_lock:
            if self._device_closed:
                raise RuntimeError("server is closed")
            self._device_jobs.put((fn, future))
        return future.result()

    def _device_loop(self):
        """The device thread: inference mode and the server's stream (both
        thread-local) for every job, in order, until close()."""
        with torch.inference_mode():
            if self._stream is not None:
                torch.cuda.set_stream(self._stream)
            while True:
                job = self._device_jobs.get()
                if job is None:
                    return
                fn, future = job
                t0 = _now()
                try:
                    future.set_result(fn())
                except Exception as e:   # raised again in the caller
                    future.set_exception(e)
                with self._stats_lock:
                    self._counters["device_busy_s"] += _now() - t0

    def _length_groups(self, reqs):
        """Split one formed batch at phoneme-bucket boundaries only when
        that lowers total padded compute. Padded compute is bucket(B) x
        bucket(max L): a 12-phoneme item batched with a 48-phoneme one
        costs 4x its own compute, but a split whose sub-groups still pad up
        to the same batch bucket (e.g. 16 mixed requests -> three groups of
        ~5, each padded to B=16) triples the cost instead. The explicit
        cost test handles both regimes."""
        if len(reqs) <= 4:
            return [reqs]
        groups = {}
        for r in reqs:
            groups.setdefault(self._pbucket(len(r.phonemes)), []).append(r)
        if len(groups) == 1:
            return [reqs]
        # merge tiny groups upward so no dispatch runs near-empty
        split = []
        pending = []
        for bucket in sorted(groups):
            pending.extend(groups[bucket])
            if len(pending) >= 4:
                split.append(pending)
                pending = []
        if pending:
            # tail group dispatches on its own: merging it into an earlier
            # (smaller-bucket) group would pad that whole group up to the
            # tail's bucket, undoing the split's savings
            split.append(pending)

        def cost(rs):
            b = next((x for x in self.batch_buckets if x >= len(rs)),
                     len(rs))
            return b * self._pbucket(max(len(r.phonemes) for r in rs))

        if sum(cost(g) for g in split) < cost(reqs):
            return split
        return [reqs]

    def _pbucket(self, n: int) -> int:
        """Phoneme-length padding bucket: the tuned grid when one is set
        on the pipeline (suggest_buckets), the power-of-2 default else."""
        return pipeline._phone_pad(
            n, getattr(self.king.tts, "phone_buckets", None))

    def _shed_expired(self, batch):
        """Drop requests whose deadline passed while queued, before any
        device compute is spent on them."""
        now = _now()
        alive = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                req.future.set_exception(DeadlineExceeded(
                    f"deadline passed after {now - req.t_submit:.3f}s "
                    f"in queue"))
                with self._stats_lock:
                    self._counters["shed"] += 1
            else:
                alive.append(req)
        return alive

    def _fail(self, reqs, exc):
        """Resolve the batch's pending futures with ``exc``; count them."""
        n_failed = 0
        for req in reqs:
            if not req.future.done():
                req.future.set_exception(exc)
                n_failed += 1
        with self._stats_lock:
            self._counters["failed"] += n_failed

    def _dispatcher(self):
        while not self._stop.is_set():
            gathered = self._gather_batch()
            if gathered is None:
                continue
            ident, batch = gathered
            batch = self._shed_expired(batch)
            groups = {}
            for req in batch:
                groups.setdefault(req.controls, []).append(req)
            groups = [(controls, sub)
                      for controls, reqs in groups.items()
                      for sub in self._length_groups(reqs)]
            for controls, reqs in groups:
                try:
                    handles = self._device(
                        lambda: self._fs2_batch(reqs, controls, ident))
                except Exception as e:
                    # counted here too (not just _completer) so stats are
                    # accurate and drain()'s settled>=admitted wait ends
                    self._fail(reqs, e)
                    continue
                # Bounded: blocks when `pipeline_depth` FS2 batches are in
                # flight, providing backpressure to _gather_batch.
                self._mid.put((reqs, handles))

    def _vocoder_stage(self):
        """Middle pipeline stage: waits for FS2(i)'s lengths (overlapped with
        FS2(i+1) dispatch and wav(i-1) fetch on the other threads), handles
        the rare mel-bucket overflow, slices the mel to the tightest length
        bucket the realized lengths allow and dispatches the vocoder."""
        while not (self._stop.is_set() and self._mid.empty()):
            try:
                reqs, handles = self._mid.get(timeout=0.05)
            except queue.Empty:
                continue
            now = _now()
            if reqs and all(r.deadline is not None and now > r.deadline
                            for r in reqs):
                # Every request in the batch expired while FS2 was in
                # flight: skip the vocoder dispatch, the dominant remaining
                # compute, for answers nobody is waiting for. Mixed batches
                # proceed: the live items need the batch anyway.
                for req in reqs:
                    req.future.set_exception(DeadlineExceeded(
                        f"deadline passed after {now - req.t_submit:.3f}s "
                        f"(post-dispatch, pre-vocoder)"))
                with self._stats_lock:
                    self._counters["shed"] += len(reqs)
                continue
            try:
                self._inflight.put((reqs, self._vocode_batch(reqs, handles)))
            except Exception as e:
                self._fail(reqs, e)

    def _completer(self):
        while not (self._stop.is_set() and self._mid.empty()
                   and self._inflight.empty()):
            try:
                reqs, handles = self._inflight.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                results = self._complete_batch(reqs, handles)
            except Exception as e:
                with self._stats_lock:
                    self._counters["failed"] += len(reqs)
                for req in reqs:
                    if not req.future.done():
                        req.future.set_exception(e)
                continue
            # counted before the futures resolve: a caller that has every
            # result reads them all in stats()
            with self._stats_lock:
                self._counters["completed"] += len(reqs)
            for req, result in zip(reqs, results):
                if not req.future.done():   # a caller may have cancelled it
                    req.future.set_result(result)

    # ------------------------------------------------------------- device

    def _fs2_batch(self, reqs, controls, ident, defer=True):
        """Pack and dispatch FS2 without waiting for the card: the overflow
        check generate() would wait for is left to the vocoder stage
        (defer_overflow), which gets the raw lengths from the fetch started
        here. Returns (out, mel bucket, controls, fetch of mel_lens_raw,
        the batch's id). The first dispatch (``defer``) is counted in
        stats(); a redo is counted as one."""
        t_dispatch = _now()
        with span("serve.fs2", ident):
            d_ctl, p_ctl, e_ctl = controls
            self._trace_batches.append(len(reqs))
            L = max(len(r.phonemes) for r in reqs)
            B = next((b for b in self.batch_buckets if b >= len(reqs)),
                     len(reqs))
            phonemes = np.zeros((B, L), np.int32)
            src_lens = np.ones((B,), np.int32)   # padded rows: 1 pad phoneme
            for i, r in enumerate(reqs):
                phonemes[i, : len(r.phonemes)] = r.phonemes
                src_lens[i] = len(r.phonemes)
            speakers = [r.speaker for r in reqs] + [0] * (B - len(reqs))

            out = self.king.tts.generate(
                phonemes, duration_control=d_ctl, pitch_control=p_ctl,
                energy_control=e_ctl, speaker_name=speakers,
                src_lens=src_lens, defer_overflow=defer)
            # without defer the buckets escalated already, and mel_bucket is
            # the one that fits; overflow is judged on the RAW lengths
            # (mel_lens is clamped to the bucket)
            fetch = _Fetch(out["mel_lens_raw"])
        with self._stats_lock:
            c = self._counters
            if defer:
                c["batches"] += 1
                c["batched_requests"] += len(reqs)
                c["queue_wait_s"] += sum(t_dispatch - r.t_submit
                                         for r in reqs)
            else:
                c["overflow_redos"] += 1
        return out, out["mel_bucket"], controls, fetch, ident

    def _vocode_batch(self, reqs, handles):
        """Wait (on this thread) for FS2's raw lengths, then dispatch the
        vocoder on the device thread. Returns (fetch, mel_lens, the batch's
        id)."""
        out, bucket, controls, raw_fetch, ident = handles
        with span("serve.lengths_wait", ident):
            raw = raw_fetch.wait()[0][: len(reqs)]
        if raw.max(initial=0) > bucket:
            # Rare: the duration predictor overflowed the guessed mel
            # bucket. Retry with the synchronous bucket escalation (the
            # same path direct generate() calls take).
            with span("serve.redo", ident):
                out, bucket, controls, raw_fetch, _ = self._device(
                    lambda: self._fs2_batch(reqs, controls, ident,
                                            defer=False))
                raw = raw_fetch.wait()[0][: len(reqs)]
        mel_lens = np.minimum(raw, bucket)
        tight = min(pipeline._bucket(int(mel_lens.max(initial=1)),
                                     pipeline.MEL_BUCKETS),
                    out["postnet_mel"].shape[1])
        n = len(reqs)

        def dispatch():
            with span("serve.vocoder", ident):
                mel = out["postnet_mel"][:, :tight]    # a view on the card
                if not self.return_wav:
                    # numpy has no bf16: mels come back as float32
                    return _Fetch(mel[:n].float())
                # int16 on the card: half the fetch bytes of float32
                return _Fetch(self.king.vocoder.vocode_int16(mel)[:n])

        return self._device(dispatch), mel_lens, ident

    def _complete_batch(self, reqs, handles):
        """The batch's results on the host, one per request, in order."""
        fetch, mel_lens, ident = handles
        with span("serve.fetch_wait", ident):
            host = fetch.wait()[0]
        if self.return_wav:
            hop = self.king.cfg.preprocess.stft.hop_length
            return [host[i, : mel_lens[i] * hop].copy()
                    for i in range(len(reqs))]
        return [(host[i, : mel_lens[i]].copy(), int(mel_lens[i]))
                for i in range(len(reqs))]


# --------------------------------------------------------------- HTTP front

def serve_http(king, host="127.0.0.1", port=8765, state=None, **server_kw):
    """Wrap a SynthesisServer in a stdlib HTTP front end.

    Endpoints:
      GET  /health  -> {"ok": true, "speakers": N}
      GET  /stats   -> SynthesisServer.stats(): counters, queue depth,
                       uptime
      POST /tts     -> WAV file; JSON body {"text" | "phonemes": [...],
                       "speaker", "duration_control", "pitch_control",
                       "energy_control", "deadline_ms"}; 429 + Retry-After
                       when the admission queue is full, 503 while
                       draining, 504 when the deadline passes before
                       dispatch, 500 on any other error
      POST /stream  -> chunked raw int16 PCM (audio/L16), same body:
                       first chunk after one FS2 call + one vocoder window

    state: a load_serving_state() dict from a previous process: adopts its
    tuned padding grids and prewarms its traffic's shape grid
    (SynthesisServer.from_serving_state).

    Returns (httpd, synthesis_server); the caller runs httpd.serve_forever()
    and closes both. Port 0 binds an ephemeral port
    (httpd.server_address[1]).
    """
    import io
    import wave
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from itertools import chain

    if state is not None:
        server = SynthesisServer.from_serving_state(king, state, **server_kw)
    else:
        server = SynthesisServer(king, **server_kw)
    sr = king.cfg.preprocess.audio.sampling_rate

    class _StreamAborted(Exception):
        """Mid-stream failure after the 200 + chunked headers went out;
        the connection is dropped instead of writing a bogus second
        response."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _synth_kwargs(self, body, with_deadline=False):
            kw = dict(speaker=body.get("speaker", 0))
            for k in ("duration_control", "pitch_control", "energy_control"):
                if k in body:
                    kw[k] = float(body[k])
            if with_deadline and "deadline_ms" in body:
                kw["deadline_ms"] = float(body["deadline_ms"])
            if "phonemes" in body:
                kw["phonemes"] = np.asarray(body["phonemes"], np.int32)
            else:
                kw["text"] = body["text"]
            return kw

        def _error(self, code, msg, retry_after=None):
            payload = json.dumps({"error": msg}).encode()
            try:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                self.end_headers()
                self.wfile.write(payload)
            except OSError:
                pass    # the client went away

        def do_GET(self):
            if self.path in ("/health", "/stats"):
                doc = ({"ok": True, "speakers": len(king.speakers)}
                       if self.path == "/health" else server.stats())
                payload = json.dumps(doc).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            else:
                self.send_error(404)

        def do_POST(self):
            try:
                body = self._body()
                if self.path == "/tts":
                    try:
                        fut = server.submit(
                            **self._synth_kwargs(body, with_deadline=True))
                    except ServerDraining as e:
                        return self._error(503, str(e))
                    except ServerOverloaded as e:
                        return self._error(429, str(e), retry_after=1)
                    try:
                        wav = fut.result(timeout=600)
                    except DeadlineExceeded as e:
                        return self._error(504, str(e))
                    buf = io.BytesIO()
                    with wave.open(buf, "wb") as w:
                        w.setnchannels(1)
                        w.setsampwidth(2)
                        w.setframerate(sr)
                        w.writeframes(np.asarray(wav, np.int16).tobytes())
                    data = buf.getvalue()
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/stream":
                    gen = server.stream(**self._synth_kwargs(body))
                    # Pull the first chunk before committing to a 200:
                    # errors before any audio exists (bad text, unknown
                    # speaker) come back as clean JSON 500s, not a
                    # connection reset halfway through a chunked response.
                    first = next(gen, None)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     f"audio/L16;rate={sr};channels=1")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    chunks = (chain((first,), gen)
                              if first is not None else gen)
                    try:
                        for chunk in chunks:
                            data = np.asarray(chunk, np.int16).tobytes()
                            self.wfile.write(f"{len(data):X}\r\n".encode())
                            self.wfile.write(data)
                            self.wfile.write(b"\r\n")
                        self.wfile.write(b"0\r\n\r\n")
                    except Exception:
                        # Headers are out; a second status line would be
                        # protocol garbage. Drop the connection: the
                        # missing terminating 0-chunk tells the client
                        # the stream was truncated.
                        self.close_connection = True
                        raise _StreamAborted()
                else:
                    self.send_error(404)
            except _StreamAborted:
                pass
            except ServerDraining as e:
                self._error(503, str(e))
            except Exception as e:  # surface errors as 500 JSON
                self._error(500, str(e))

    httpd = ThreadingHTTPServer((host, port), Handler)
    return httpd, server


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="tts_king_torch synthesis server (one CUDA card)")
    ap.add_argument("--config", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 weights and activations")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which raises without "
                         "CUDA; cpu runs the kernels' plain versions)")
    ap.add_argument("--admission-depth", type=int, default=64,
                    help="max queued requests before 429")
    ap.add_argument("--default-deadline-ms", type=float, default=None,
                    help="shed requests still queued past this deadline")
    ap.add_argument("--prewarm", type=int, nargs="?", const=64, default=None,
                    metavar="MAX_PHONEMES",
                    help="build the kernels and touch the full serving shape "
                         "grid before accepting traffic (avoids first-touch "
                         "stalls mid-traffic)")
    ap.add_argument("--state-file", default=None,
                    help="serving-state JSON: loaded at startup (adopt the "
                         "previous process's tuned padding grids + prewarm "
                         "its traffic's shape grid), written at graceful "
                         "shutdown (SIGTERM/SIGINT -> drain, save, exit)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="max seconds to wait for queued work at shutdown")
    args = ap.parse_args(argv)

    import signal

    from tts_king_torch.config import TTSConfig, load_config

    cfg = load_config(args.config) if args.config else TTSConfig()
    king = pipeline.TTSKing(
        cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=args.device)
    server_kw = dict(max_batch=args.max_batch,
                     admission_depth=args.admission_depth,
                     default_deadline_ms=args.default_deadline_ms)
    prior = None
    if args.state_file and os.path.exists(args.state_file):
        prior = SynthesisServer.load_serving_state(args.state_file)
        print(f"adopting serving state from {args.state_file}: "
              f"batch_buckets={prior.get('batch_buckets')} "
              f"phone_buckets={prior.get('phone_buckets')}", flush=True)
    httpd, server = serve_http(king, host=args.host, port=args.port,
                               state=prior, **server_kw)
    if args.prewarm and not (prior and prior.get("prewarm")):
        print("prewarming serving shape grid "
              f"(max_phonemes={args.prewarm})...", flush=True)
        print(f"prewarmed: {server.prewarm(max_phonemes=args.prewarm)}",
              flush=True)

    def _graceful(signum, frame):
        # Stop accepting HTTP, drain admitted work, persist tuned state.
        # shutdown() must come from another thread (serve_forever's loop).
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(/tts /stream /health /stats)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        stats = server.drain(timeout=args.drain_timeout)
        if args.state_file:
            server.save_serving_state(args.state_file)
            print(f"serving state saved to {args.state_file}", flush=True)
        print(f"drained: {stats}", flush=True)


if __name__ == "__main__":
    main()
