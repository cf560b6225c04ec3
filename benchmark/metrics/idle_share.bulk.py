"""The share of the bulk window in which the device ran nothing (kernels,
copies and memsets as one union), in %."""

from benchmark.core.readers import idle_pct


def read(run):
    return idle_pct(run)
