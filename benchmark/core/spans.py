"""What the readers of the program's own spans share.

The program (tts_king_torch) opens a named host range at each of its layer
boundaries while a profiler runs (``utils.profiling.span``): on the bulk
path ``fs2.generate`` around ``AcousticModel.generate`` and, inside it,
``fs2.encoder``, ``fs2.variance``, ``fs2.decoder`` and ``fs2.postnet``;
``vocoder.generate`` around ``Vocoder.generate`` and, inside it,
``vocoder.net``, ``vocoder.int16`` and ``vocoder.fetch``. The trace reads
them as it reads the benchmark's own ranges.

Every value is per batch: summed over the window and divided by the
instances of the batch's span (``fs2.generate``, ``vocoder.generate``),
not by the inner span's own count, so that a stage that runs twice in a
batch (an overflow redo) reads larger. None where the trace holds no
instance of a span read (a program that records none).
"""

import bisect

from benchmark.core.trace import clipped_length


def device_ms_per_batch(run, names, batch_span):
    """Milliseconds of device work launched under the spans ``names``
    (each instance's work as a union, summed over the spans), per instance
    of ``batch_span``."""
    tr = run.records["trace"]
    batches = len(tr.ranges.get(batch_span, []))
    total = 0.0
    for name in names:
        seconds, n = tr.range_device_s(name)
        if not n:
            return None
        total += seconds
    return total / batches * 1e3 if batches else None


def idle_ms_per_batch(run, batch_span):
    """Milliseconds the device ran nothing while the host was inside
    ``batch_span``, per instance: each instance's length, clipped to the
    window, less the device's busy union clipped to it (only the busy
    intervals that reach into the instance are summed)."""
    tr = run.records["trace"]
    spans = tr.ranges.get(batch_span, [])
    if not spans:
        return None
    lo, hi = tr.window
    starts = [s for s, _ in tr.busy]
    ends = [e for _, e in tr.busy]
    idle = 0.0
    for s, e in spans:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            near = tr.busy[bisect.bisect_right(ends, s):
                           bisect.bisect_left(starts, e)]
            idle += (e - s) - clipped_length(near, s, e)
    return idle / len(spans) * 1e-3
