"""Row 1, the inference attention kernel (FastSpeech2's, f32 in the bulk
cells): its bound over each call's valid keys over its launches' device
time, in %."""

from benchmark.core.readers import attention_bound_s, roofline_pct


def read(run):
    return roofline_pct(run, "roofline.attention.bulk",
                        attention_bound_s(run))
