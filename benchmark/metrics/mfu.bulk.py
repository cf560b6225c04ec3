"""The whole bulk step's share of the card's peak: the model FLOPs of the
window's real (unpadded) sentences, each part over the peak of its dtype,
over the window, in %."""

from benchmark.core.readers import model_peak_seconds


def read(run):
    return 100.0 * model_peak_seconds(run) / run.records["trace"].window_s
