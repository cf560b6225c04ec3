"""Device milliseconds a bulk batch's FastSpeech2 decoder and mel_linear
launched (the program's fs2.decoder span), per batch (fs2.generate)."""

from benchmark.core.spans import device_ms_per_batch


def read(run):
    return device_ms_per_batch(run, ["fs2.decoder"], "fs2.generate")
