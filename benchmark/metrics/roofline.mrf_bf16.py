"""Row 2, the bf16 MRF kernel: its bound at each batch's mel bucket and
stage over its launches' device time, in %."""

from benchmark.core.readers import mrf_bound_s, roofline_pct


def read(run):
    return roofline_pct(run, "roofline.mrf_bf16", mrf_bound_s(run, "bf16"))
