"""Device milliseconds a bulk batch's FastSpeech2 encoder launched (the
program's fs2.encoder span), per batch (fs2.generate)."""

from benchmark.core.spans import device_ms_per_batch


def read(run):
    return device_ms_per_batch(run, ["fs2.encoder"], "fs2.generate")
