"""Milliseconds a bulk batch's device ran nothing while the host was
inside AcousticModel.generate (the program's fs2.generate span), per
batch."""

from benchmark.core.spans import idle_ms_per_batch


def read(run):
    return idle_ms_per_batch(run, "fs2.generate")
