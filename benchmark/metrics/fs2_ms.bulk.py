"""Device milliseconds a bulk batch's AcousticModel.generate launched (the
benchmark's bench.fs2 range), per batch."""

from benchmark.core.readers import range_ms


def read(run):
    return range_ms(run, "bench.fs2")
