"""Device milliseconds a bulk batch's postnet and its residual add
launched (the program's fs2.postnet span), per batch (fs2.generate)."""

from benchmark.core.spans import device_ms_per_batch


def read(run):
    return device_ms_per_batch(run, ["fs2.postnet"], "fs2.generate")
