"""Device milliseconds a bulk batch's Vocoder.generate launched (the
benchmark's bench.vocoder range, its fetch of the mel lengths with it), per
batch."""

from benchmark.core.readers import range_ms


def read(run):
    return range_ms(run, "bench.vocoder")
