"""The frozen work counts reproduce the kernel table's bounds (PERF.md,
the port's kernel table: rows 1, 2, 2f and 3a, as chip_smoke.py counted
them) at the same shapes, the model FLOP counts their closed forms, and
each configuration's vocoder family (benchmark/reference/<family>.py)
counts the FLOPs frozen in tests/frozen/<config>.json."""

import numpy as np
import pytest

from benchmark.core import counts, harness
from benchmark.reference import hifigan, melgan, vocoders
from benchmark.tests import micro
from benchmark.tests.test_bench_weights import frozen

SHIPPED_VOCODER = {"upsample_rates": [8, 8, 2, 2],
                   "upsample_kernel_sizes": [16, 16, 4, 4],
                   "upsample_initial_channel": 512,
                   "resblock_kernel_sizes": [3, 7, 11],
                   "resblock_dilation_sizes": [[1, 3, 5]] * 3,
                   "num_mels": 80}


def mrf_bound_ms(B, t_mel, dtype):
    total = 0.0
    for C, T in counts.fused_stages(SHIPPED_VOCODER, t_mel):
        total += counts.bound_s(*counts.mrf_work(B, C, T, [3, 7, 11], 3,
                                                 dtype), dtype)
    return total * 1e3


def test_fused_stages_are_the_narrow_stages():
    assert counts.fused_stages(SHIPPED_VOCODER, 1000) == [
        (128, 64000), (64, 128000), (32, 256000)]


@pytest.mark.parametrize("B, t_mel, dtype, want", [
    (32, 1000, "bf16", 14.96),     # row 2: the bench shape
    (1, 192, "f32", 0.538),        # row 2f: speak's 192-frame sentence
])
def test_mrf_bound_matches_kernel_table(B, t_mel, dtype, want):
    assert mrf_bound_ms(B, t_mel, dtype) == pytest.approx(want, abs=5e-3)


def test_mrf_count_at_a_bucket_is_the_count_of_its_frames():
    """A launch at a mel bucket of 1000 counts the bucket's frames: B items
    of 1000 frames are B x 1000 frames, whatever the split."""
    ops_batch = sum(counts.mrf_work(32, C, T, [3, 7, 11], 3, "bf16")[0]
                    for C, T in counts.fused_stages(SHIPPED_VOCODER, 1000))
    ops_frames = sum(counts.mrf_work(1, C, T, [3, 7, 11], 3, "bf16")[0]
                     for C, T in counts.fused_stages(SHIPPED_VOCODER,
                                                     32 * 1000))
    assert ops_batch == ops_frames
    # per frame: 2 x 6 convs x (3 + 7 + 11) taps x C^2 x samples a frame
    assert ops_frames / (32 * 1000) == 12 * 21 * (128 ** 2 * 64
                                                  + 64 ** 2 * 128
                                                  + 32 ** 2 * 256)


def test_attention_bound_matches_row_1():
    """Row 1: B=32 H=2 T=1000 D=128 bf16 over 16,821 valid keys."""
    lens = [16821 // 32] * 31 + [16821 - 31 * (16821 // 32)]
    ops, nbytes = counts.attention_work(32, 2, 1000, 128, lens, "bf16")
    assert counts.bound_s(ops, nbytes, "bf16") * 1e3 == pytest.approx(
        0.0174, abs=5e-5)


def test_flash_forward_bound_matches_row_3a():
    """Row 3a: the decoder call of the bench training step, B=16 H=2 T=640
    D=128 f32, the key lengths of bench.py's superbatch (seeded as
    chip_smoke.bench_train_superbatch seeds them)."""
    rng = np.random.RandomState(4)
    d = rng.randint(4, 9, (4, 16, 96))
    lens = np.minimum(d.sum(-1), 640)[0]
    (ops_f, bytes_f), _ = counts.flash_work(16, 2, 640, 128, lens)
    assert counts.bound_s(ops_f, bytes_f, "f32") * 1e3 == pytest.approx(
        0.036, abs=5e-4)


def test_model_flops_per_frame():
    """HiFi-GAN V1 ~614 MFLOP and MelGAN ~90 MFLOP a mel frame (exactly
    614,105,088 and 90,341,376); FastSpeech2 at ~5 frames a phoneme ~45
    MFLOP a frame."""
    assert hifigan.flops_per_frame(SHIPPED_VOCODER) == pytest.approx(
        613.6e6, rel=2e-3)
    assert hifigan.flops_per_frame(SHIPPED_VOCODER) == 614_105_088
    melgan_v = {"upsample_rates": [8, 8, 2, 2], "ngf": 32,
                "n_residual_layers": 3, "num_mels": 80}
    assert melgan.flops_per_frame(melgan_v) == pytest.approx(
        90.3e6, rel=5e-3)
    assert melgan.flops_per_frame(melgan_v) == 90_341_376
    model = {"transformer": {"encoder_layer": 4, "encoder_head": 2,
                             "encoder_hidden": 256, "decoder_layer": 6,
                             "decoder_head": 2, "decoder_hidden": 256,
                             "conv_filter_size": 1024,
                             "conv_kernel_size": [9, 1]},
             "variance_predictor": {"filter_size": 256, "kernel_size": 3},
             "postnet_dim": 512, "n_mel_channels": 80}
    per_frame = counts.fs2_flops(model, 100, 500) / 500
    assert 40e6 < per_frame < 55e6


def test_f32_peak_is_3xtf32():
    p = counts.peaks()
    assert p["f32_ops_per_s"] == pytest.approx(p["tf32_ops_per_s"] / 3, rel=1e-3)


@pytest.mark.parametrize("name", micro.configs())
def test_family_flops_per_frame_are_frozen(name):
    cfg = harness.load_json("configs", f"{name}.json")
    family = vocoders.find(cfg["model"]["vocoder_model"])
    assert (family.flops_per_frame(cfg["vocoder"])
            == frozen(name)["vocoder_flops_per_frame"])
