"""Bulk synthesis: a closed loop of batches, one at a time, as an audiobook
or voice-over producer runs it.

Each batch of sentences (in arrival order, not sorted by length) goes
through the program's normal path: ``AcousticModel.generate`` and then
``Vocoder.generate(mel, lengths)``, which returns each sentence's int16
samples on the host. The window runs batches until ``--seconds`` have
passed and ends when the last batch's samples are on the host.

End to end: ``audio_s_per_s``, the real (unpadded) audio seconds delivered,
sum(mel_lens) x hop / sample rate, over the window.

Correctness: sentences drawn from the seed among those the window finished
(and the longest, by frames), after the window, against the plain
reference (benchmark/reference/compare.py): the variance predictions and
the durations chosen from them, the postnet mel, the int16 waveform and
the lengths.
"""

import heapq

import numpy as np
import torch

from benchmark.core import program
from benchmark.core.traffic import batch_maxima, bulk_batches, rng_for
from benchmark.reference import compare


def _phone_pad(n):
    """The program's phoneme padding: the next power of two from 16."""
    b = 16
    while b < n:
        b *= 2
    return b


def warm_lengths(traffic, seed):
    """The longest-sentence lengths the warm-up runs: for each phoneme
    padding that the run's batches reach (over more passes of the pool
    than a window holds), the least and the most of their longest
    sentences, so that every padding and mel bucket is touched."""
    maxima = batch_maxima(traffic, seed,
                          traffic["warm_over_passes"] * traffic["pool"]
                          // traffic["batch"])
    out = set()
    for pad in {_phone_pad(m) for m in maxima}:
        ms = [m for m in maxima if _phone_pad(m) == pad]
        out |= {min(ms), max(ms)}
    return sorted(out)


class Sample:
    """The sentences the check compares: the ``k`` of lowest seeded
    priority among those finished, and the longest by frames. Only these
    sentences' outputs are copied to the host, in one copy a batch."""

    def __init__(self, k, seed):
        self.k, self.rng = k, rng_for(seed, 3)
        self.heap = []         # (-priority, batch index, row, record)
        self.longest = None    # (frames, record)

    def offer(self, batch_index, batch, out, frames, wavs):
        taken = {}
        for r, p in enumerate(self.rng.random(len(wavs))):
            if len(self.heap) < self.k or p < -self.heap[0][0]:
                entry = (-p, batch_index, r, taken.setdefault(r, {}))
                if len(self.heap) < self.k:
                    heapq.heappush(self.heap, entry)
                else:
                    heapq.heapreplace(self.heap, entry)
        r = int(np.argmax(frames))
        if self.longest is None or frames[r] > self.longest[0]:
            self.longest = (int(frames[r]), taken.setdefault(r, {}))
        if taken:
            _fill(taken, batch, out, frames, wavs)

    def records(self):
        recs = [h[3] for h in self.heap]
        if self.longest is not None:
            recs.append(self.longest[1])
        return recs


def _fill(taken, batch, out, frames, wavs):
    """What the check needs of the rows in ``taken`` (row -> a dict to
    fill): their inputs, the program's choices and outputs, and the shapes
    they ran at."""
    rows = sorted(taken)
    idx = torch.tensor(rows, device=out["postnet_mel"].device)
    choices = torch.stack([out["log_duration_prediction"],
                           out["duration_rounded"], out["pitch_prediction"],
                           out["energy_prediction"]], 1)[idx].float().cpu()
    mels = out["postnet_mel"][idx].float().cpu()
    for i, r in enumerate(rows):
        n = int(frames[r])
        taken[r].update(
            phonemes=batch["phonemes"][r], length=int(batch["src_lens"][r]),
            speaker=int(batch["speakers"][r]), log_duration=choices[i, 0],
            duration=choices[i, 1], pitch=choices[i, 2],
            energy=choices[i, 3], frames=n,
            mel_bucket=int(out["mel_bucket"]), mel=mels[i, :n],
            vocoder_frames=int(out["postnet_mel"].shape[1]),
            wav=np.asarray(wavs[r]))


def run(ctx):
    cfg, traffic = ctx.config, ctx.traffic
    precision = traffic["precision"]
    ctx.setup_step("imported")
    n_symbols = cfg["model"]["n_symbols"]
    calib = bulk_batches(traffic, ctx.seed, n_symbols,
                         cfg["model"]["n_speakers"], streams=(6, 7))
    weights = program.make_weights(
        cfg, precision, ctx.seed, ctx.device,
        [(ph, n) for _ in range(traffic["calibration_batches"])
         for b in [next(calib)] for ph, n in zip(b["phonemes"],
                                                 b["src_lens"])])
    ctx.setup_step("weights made")
    acoustic, vocoder = program.build(cfg, precision, weights, ctx.device)
    ctx.setup_step("program built")
    hop = program.hop(cfg)
    batches = bulk_batches(traffic, ctx.seed, n_symbols,
                           cfg["model"]["n_speakers"])

    def one(batch, fs2_range="bench.fs2", voc_range="bench.vocoder"):
        with ctx.range(fs2_range):
            out = acoustic.generate(batch["phonemes"],
                                    speaker_name=batch["speakers"],
                                    src_lens=batch["src_lens"])
        with ctx.range(voc_range):
            lens = out["mel_lens"].cpu().numpy()
            wavs = vocoder.generate(out["postnet_mel"], lens * hop)
        return out, lens, wavs

    longest = warm_lengths(traffic, ctx.seed) * traffic["warm_passes"]
    for b in bulk_batches(traffic, ctx.seed, n_symbols,
                          cfg["model"]["n_speakers"], streams=(4, 5),
                          longest=longest):
        one(b)
    ctx.setup_done()

    sample = Sample(traffic["check_sentences"], ctx.seed)
    frames, sentences, shapes = 0, 0, []
    with ctx.window() as clock:
        i = 0
        while clock() < ctx.seconds:
            batch = next(batches)
            out, lens, wavs = one(batch)
            frames += int(lens.sum())
            sentences += len(lens)
            shapes.append({"B": len(lens),
                           "phone_pad": int(out["log_duration_prediction"].shape[1]),
                           "src_lens": batch["src_lens"].tolist(),
                           "mel_bucket": int(out["mel_bucket"]),
                           "mel_lens": lens.tolist()})
            sample.offer(i, batch, out, lens, wavs)
            i += 1
    ctx.read_device()
    ctx.records.update(batches=shapes, frames=frames)
    audio_s = program.audio_seconds(cfg, frames)

    records = sample.records()
    del acoustic, vocoder, out, wavs
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare.sentences(cfg, precision, weights, records, ctx.device)
    return {"end_to_end": {"audio_s_per_s": audio_s / ctx.window_s},
            "attempted": sentences, "failed": 0, "numbers": numbers}
