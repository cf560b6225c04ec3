"""Device milliseconds a bulk batch's AMP convs launched (the program's
vocoder.amp_conv span around each of BigVGAN's 108 AMP block convs, the
residual add outside it), per batch (vocoder.generate)."""

from benchmark.core.spans import device_ms_per_batch


def read(run):
    return device_ms_per_batch(run, ["vocoder.amp_conv"], "vocoder.generate")
