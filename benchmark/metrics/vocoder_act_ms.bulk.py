"""Device milliseconds a bulk batch's anti-aliased SnakeBeta activations
launched (the program's vocoder.act span around each of BigVGAN's
activation calls), per batch (vocoder.generate)."""

from benchmark.core.spans import device_ms_per_batch


def read(run):
    return device_ms_per_batch(run, ["vocoder.act"], "vocoder.generate")
