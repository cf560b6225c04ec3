"""The fused anti-aliased SnakeBeta kernel (BigVGAN's activations, bf16):
its least work over its launches' device time, in %. The work is counted
at each sentence's real frames (the records' mel_lens), not at the padded
mel bucket the kernel runs: the least that the delivered samples need
(benchmark/reference/bigvgan.act_work). Bound: the larger of its bytes
over the HBM peak and its operations over the CUDA cores' float32 peak,
where the kernel computes."""

from benchmark.core.counts import peaks
from benchmark.core.readers import roofline_pct
from benchmark.reference import bigvgan

# H100 SXM data sheet: float32 outside the tensor cores, dense, at 700 W.
F32_CUDA_CORE_OPS_PER_S = 67e12


def read(run):
    batches = run.records["batches"]
    frames = sum(sum(b["mel_lens"]) for b in batches)
    ops, nbytes = bigvgan.act_work(run.config["vocoder"], frames,
                                   len(batches), 2)
    bound_s = max(ops / F32_CUDA_CORE_OPS_PER_S,
                  nbytes / peaks()["hbm_bytes_per_s"])
    return roofline_pct(run, "roofline.amp_act_bf16", bound_s)
