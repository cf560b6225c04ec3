"""Device milliseconds a bulk batch's speaker embedding and variance
adaptor (predictors, bucketize, embeddings, length regulation) launched
(the program's fs2.variance span), per batch (fs2.generate)."""

from benchmark.core.spans import device_ms_per_batch


def read(run):
    return device_ms_per_batch(run, ["fs2.variance"], "fs2.generate")
