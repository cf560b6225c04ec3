"""Device milliseconds a bulk batch's waveform took from the network's
output to the host: the int16 cast (vocoder.int16) and the copy of the
padded int16 batch to host memory (vocoder.fetch), per batch
(vocoder.generate)."""

from benchmark.core.spans import device_ms_per_batch


def read(run):
    return device_ms_per_batch(run, ["vocoder.int16", "vocoder.fetch"],
                               "vocoder.generate")
