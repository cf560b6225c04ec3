"""Device milliseconds a bulk batch's vocoder network launched (the
program's vocoder.net span in Vocoder.vocode_int16), per batch
(vocoder.generate)."""

from benchmark.core.spans import device_ms_per_batch


def read(run):
    return device_ms_per_batch(run, ["vocoder.net"], "vocoder.generate")
