"""BigVGAN-v2 in the port (models/bigvgan.py, ops/kernels/amp_act.py)
against the benchmark's plain reference (benchmark/reference/bigvgan.py,
plain PyTorch that imports nothing of the port) and the published
equations, on the CPU in float32:

  * the generator at the reference's MICRO widths (all six stages);
  * the anti-aliased activation's plain version against the reference's
    and against the equations written out index by index, with x's and the
    2x signal's replicate padding, at odd and even T;
  * the filter against the published formula;
  * frames, the Vocoder built from a config, the published checkpoint's
    layout, the receptive field that streaming uses, and the launch count.

The ``chip`` tests hold the CUDA kernel against its plain version on the
card; run them there with ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_bigvgan.py -m chip`` (tests/conftest.py
loads JAX, which the card's machine lacks).
"""

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.reference import bigvgan as reference  # noqa: E402
from tts_king_torch.config import (BIGVGAN_V2,  # noqa: E402
                                   VocoderModelConfig)
from tts_king_torch.models.bigvgan import BigVGAN  # noqa: E402
from tts_king_torch.ops.dilated_conv import laid_out  # noqa: E402
from tts_king_torch.ops.kernels import amp_act as amp  # noqa: E402

PUBLISHED = dict(upsample_rates=[4, 4, 2, 2, 2, 2],
                 upsample_kernel_sizes=[8, 8, 4, 4, 4, 4],
                 upsample_initial_channel=1536, max_wav_value=32767.0)


def bigvgan_config(**kw):
    return VocoderModelConfig(**dict(PUBLISHED, **kw))


def ref_v(cfg):
    """The reference's vocoder dict: the widths and BigVGAN-v2's keys."""
    return dict(dataclasses.asdict(cfg), **BIGVGAN_V2)


def micro_config():
    return bigvgan_config(**reference.MICRO)


def seeded(module, seed):
    """The port's seeded weights, conv_post as the benchmark's rule scales
    it (so that no sample clamps and the comparison sees every sample)."""
    from tts_king_torch.weights import load_into, seeded_state_dict

    sd = seeded_state_dict(module, seed)
    sd["conv_post.weight"] = sd["conv_post.weight"] * reference.CONV_POST_SCALE
    return load_into(module, sd).eval(), sd


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the readings of the tolerances below were taken so,
    and the suite's workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_generator_matches_the_reference_at_micro_widths():
    """All six stages, three AMP branches. The port's convs add their bias
    inside the conv and the reference's after it, so the two round in other
    orders; through six stages of residual sums the samples drift up to
    ~3e-6 apart (benchmark/reference/bigvgan.py MICRO), hence 1e-5 on a
    waveform of RMS ~0.1, where no sample clamps."""
    cfg = micro_config()
    model, sd = seeded(BigVGAN(cfg), 3)
    mel = torch.randn(2, 29, 80, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(mel)
        for b in range(2):
            ref = reference.generate(sd, ref_v(cfg), mel[b])
            assert got[b].shape == ref.shape == (29 * 256,)
            assert float(ref.abs().max()) < 1.0   # nothing clamped
            assert float(ref.pow(2).mean().sqrt()) > 0.02
            assert float((got[b] - ref).abs().max()) < 1e-5


def _act_by_index(x, alpha, beta, f):
    """The published equations, one sample at a time (float64): u[n] = 2
    sum_k f[k] x[clamp(p - 5)] over n + 15 = 2p + k; s = u + sin^2(u
    e^alpha) / (e^beta + 1e-9); y[t] = sum_k f[k] s[clamp(2t + k - 5)]."""
    x = x.double().numpy()
    f = f.double().numpy()
    B, C, T = x.shape
    y = np.zeros_like(x)
    for b in range(B):
        for c in range(C):
            a = math.exp(float(alpha[c]))
            ib = 1.0 / (math.exp(float(beta[c])) + 1e-9)
            u = np.zeros(2 * T)
            for n in range(2 * T):
                for k in range(12):
                    if (n + 15 - k) % 2 == 0:
                        p = (n + 15 - k) // 2
                        u[n] += 2 * f[k] * x[b, c, min(max(p - 5, 0), T - 1)]
            s = u + ib * np.sin(u * a) ** 2
            for t in range(T):
                y[b, c, t] = sum(f[k] * s[min(max(2 * t + k - 5, 0), 2 * T - 1)]
                                 for k in range(12))
    return torch.from_numpy(y)


@pytest.mark.parametrize("T", [1, 2, 7, 64])
def test_activation_matches_the_reference_and_the_equations(T):
    """At odd and even T, down to one sample: the port's plain version
    equals the reference's activation (the same ops in f32) and the
    equations index by index, with both replicate paddings, to f32's
    rounding (1e-5 on values up to ~4)."""
    g = torch.Generator().manual_seed(T)
    x = 2.0 * torch.randn(2, 3, T, generator=g)
    alpha = 0.3 * torch.randn(3, generator=g)
    beta = 0.3 * torch.randn(3, generator=g)
    got = amp.amp_act_plain(x, alpha, beta)
    assert got.shape == x.shape and got.dtype == x.dtype
    ref = reference._act(x, alpha, beta, lambda t: t,
                         reference.lowpass_filter())
    assert float((got - ref).abs().max()) < 1e-6
    exact = _act_by_index(x, alpha, beta, reference.lowpass_filter())
    assert float((got.double() - exact).abs().max()) < 1e-5


def test_activation_edges_are_replicate_padded_at_both_rates():
    """A constant row stays constant through up, snake and down (the
    filter sums to 1 and both paddings repeat the edge), while zero
    padding at either rate would bend its ends."""
    x = torch.full((1, 1, 9), 0.7)
    alpha, beta = torch.tensor([0.2]), torch.tensor([-0.1])
    snake = 0.7 + math.sin(0.7 * math.exp(0.2)) ** 2 / (math.exp(-0.1) + 1e-9)
    got = amp.amp_act_plain(x, alpha, beta)
    torch.testing.assert_close(got, torch.full_like(x, snake), rtol=0,
                               atol=2e-6)


def test_filter_is_the_published_formula():
    f = amp.lowpass_filter()
    assert amp.kaiser_beta() == pytest.approx(4.6638, abs=5e-5)
    assert f.shape == (12,) and f.dtype == torch.float32
    assert float(f.sum()) == pytest.approx(1.0, abs=1e-6)
    torch.testing.assert_close(f, f.flip(0), rtol=0, atol=1e-8)
    torch.testing.assert_close(f, reference.lowpass_filter(), rtol=0, atol=0)
    # kaiser_sinc_filter1d's taps, as NVIDIA/BigVGAN's buffers hold them
    torch.testing.assert_close(f[:6], torch.tensor(
        [0.0020, 0.0094, -0.0255, -0.0577, 0.1286, 0.4432]), rtol=0,
        atol=5e-5)


def test_frames_do_not_move_the_samples():
    cfg = micro_config()
    model, _ = seeded(BigVGAN(cfg), 4)
    mel = torch.randn(2, 16, 80, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        whole = model(mel)
        cut = model(mel, [5, 16])
    assert torch.equal(whole, cut)


def test_launch_count_per_generator_call(monkeypatch):
    """6 activations an AMP block (stages x branches of them) and one
    before conv_post, each under a vocoder.act span; their inputs'
    base-rate sizes are the reference's count. 5 of a block's 6 take the
    conv bias that their input's conv left out, 2 of them the residual too
    (act1 of the block's second and third dilation): 90 and 36 of the 109
    at the published 18 blocks. On the card each call is one launch,
    counted in amp_act.launches, amp_act.elements, amp_act.bias_in and
    amp_act.residual_in (chip_smoke row 4 holds them against the trace); on
    the CPU the calls launch nothing and count nothing, so the model's
    calls are counted here."""
    from tts_king_torch.models import bigvgan
    from tts_king_torch.utils import profiling

    calls, spans = [], []

    def recording(x, a, b, bias=None, residual=None):
        calls.append((x.numel(), bias is not None, residual is not None))
        return amp.amp_act(x, a, b, bias, residual)

    recording.fuses_prologue = True
    monkeypatch.setattr(bigvgan, "amp_act", recording)
    real_span = profiling.span

    def counting_span(name, *args):
        spans.append(name)
        return real_span(name, *args)

    monkeypatch.setattr(bigvgan, "span", counting_span)
    cfg = micro_config()
    model, _ = seeded(BigVGAN(cfg), 5)
    mel = torch.randn(1, 10, 80, generator=torch.Generator().manual_seed(3))
    counters = ("launches", "elements", "bias_in", "residual_in")
    before = [getattr(amp, n) for n in counters]
    with torch.no_grad():
        model(mel)
    n_blocks = len(cfg.upsample_rates) * len(cfg.resblock_kernel_sizes)
    assert n_blocks == 18
    assert len(calls) == spans.count("vocoder.act") == 6 * n_blocks + 1
    assert sum(n for n, _, _ in calls) == reference.act_elements_per_frame(
        ref_v(cfg)) * 10
    assert sum(b for _, b, _ in calls) == 5 * n_blocks == 90
    assert sum(r for _, _, r in calls) == 2 * n_blocks == 36
    assert all(b for _, b, r in calls if r)
    assert [getattr(amp, n) for n in counters] == before


def test_a_stand_in_activation_gets_the_summed_input(monkeypatch):
    """A stand-in for amp_act that takes (x, alpha, beta) alone (the
    benchmark's control without anti-aliasing is one) is handed x + bias +
    residual, summed by PyTorch in the module's dtype: in f32 the same sums,
    so the same waveform."""
    from tts_king_torch.models import bigvgan

    cfg = micro_config()
    model, _ = seeded(BigVGAN(cfg), 9)
    mel = torch.randn(1, 11, 80, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        fused = model(mel)
        monkeypatch.setattr(bigvgan, "amp_act", lambda x, a, b: (
            amp.amp_act_plain(x, a, b)))
        stand_in = model(mel)
    torch.testing.assert_close(stand_in, fused, rtol=0, atol=1e-6)


def _lies_as_its_dtype(t):
    """Whether (B, C, T) ``t`` lies in its dtype's layout: bf16 in (B, T,
    C) memory, f32 contiguous (B, C, T)."""
    return laid_out(t) is t


def _signal(shape, gen, dtype, scale=1.0):
    """A (B, C, T) signal of ``dtype`` in its layout."""
    B, C, T = shape
    return laid_out((scale * torch.randn(B, T, C, generator=gen)).transpose(
        1, 2).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", ["none", "bias", "residual"])
@pytest.mark.parametrize("shape", [(1, 24, 13), (2, 24, 7), (3, 5, 1),
                                   (2, 16, 37)])
def test_wrapper_sums_bias_and_residual_in_f32(shape, prologue, dtype):
    """On inputs in their dtype's layout (bf16 (B, T, C), f32 (B, C, T)):
    y = amp_act_plain(a + bias + r) with the sum in f32 from the inputs as
    given, and with a residual the sum rounded once to the inputs' dtype;
    both outputs in that layout. T not a multiple of 8, one sample, C = 24
    and a batch of one."""
    g = torch.Generator().manual_seed(sum(shape))
    a = _signal(shape, g, dtype, 2.0)
    alpha = (0.3 * torch.randn(shape[1], generator=g)).to(dtype)
    beta = (0.3 * torch.randn(shape[1], generator=g)).to(dtype)
    bias = (torch.randn(shape[1], generator=g)).to(dtype)
    r = _signal(shape, g, dtype)
    s = a.float()
    if prologue != "none":
        s = s + bias.float()[:, None]
    if prologue == "residual":
        s = s + r.float()
    ref = amp.amp_act_plain(s, alpha, beta).to(dtype)
    got = amp.amp_act(a, alpha, beta, *{
        "none": (), "bias": (bias,), "residual": (bias, r)}[prologue])
    if prologue == "residual":
        total, got = got
        assert total.dtype == dtype and torch.equal(total, s.to(dtype))
        assert _lies_as_its_dtype(total)
    assert got.shape == a.shape and got.dtype == dtype
    assert _lies_as_its_dtype(got)
    assert torch.equal(got, ref)


def test_published_layout_has_109_activations_and_112m_parameters():
    with torch.device("meta"):
        model = BigVGAN(bigvgan_config())
    acts = [m for m in model.modules()
            if type(m).__name__ == "AntiAliasedSnakeBeta"]
    assert len(acts) == 109
    assert sum(p.numel() for p in model.parameters()) == 112_199_472
    assert model.conv_post.bias is None


def test_bigvgan_refuses_what_the_port_does_not_run():
    """BigVGAN's published keys are checked where a config is read and
    dropped: the port runs BigVGAN-v2's, which follow from vocoder_model."""
    from tts_king_torch.config import take_bigvgan_keys

    v = dict(ref_v(micro_config()))
    assert take_bigvgan_keys(v, "BigVGAN") == dataclasses.asdict(
        micro_config())
    for key, value in (("activation", "snake"), ("snake_logscale", False),
                       ("use_tanh_at_final", True),
                       ("use_bias_at_final", True)):
        with pytest.raises(ValueError, match=key):
            take_bigvgan_keys(dict(v, **{key: value}), "BigVGAN")
    with pytest.raises(ValueError, match="HiFi-GAN"):
        take_bigvgan_keys({"activation": "snakebeta"}, "HiFi-GAN")
    with pytest.raises(ValueError, match="resblock"):
        BigVGAN(bigvgan_config(resblock="2"))


def test_clamp_and_no_bias_at_final():
    """BigVGAN-v2 clamps to [-1, 1] in f32 and conv_post has no bias: a
    model made loud (conv_post x 200) clamps as the reference does. The
    tolerance is the MICRO generator test's 1e-5, scaled by the 200 that
    conv_post multiplies the drift between the two by."""
    cfg = micro_config()
    model, sd = seeded(BigVGAN(cfg), 6)
    assert "conv_post.bias" not in sd and model.conv_post.bias is None
    sd["conv_post.weight"] = sd["conv_post.weight"] * 200.0
    model.conv_post.weight.data.copy_(sd["conv_post.weight"])
    mel = torch.randn(1, 8, 80, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = model(mel)[0]
        ref = reference.generate(sd, ref_v(cfg), mel[0])
    assert float((got.abs() == 1.0).float().mean()) > 0.1
    assert float(got.abs().max()) == 1.0
    assert float((got - ref).abs().max()) < 200 * 1e-5


def test_vocoder_is_built_from_a_config_file(tmp_path):
    """``vocoder.model: BigVGAN`` in the reference layout, and
    ``model.vocoder_model`` in the native one, build the BigVGAN Vocoder;
    its int16 waveform is scaled by max_wav_value 32767, so a clamped +1.0
    stays +32767."""
    import yaml

    from tts_king_torch.config import load_config
    from tts_king_torch.pipeline import Vocoder, wav_to_int16

    voc = {k: v for k, v in ref_v(micro_config()).items()
           if k in ("upsample_rates", "upsample_kernel_sizes",
                    "upsample_initial_channel", "activation",
                    "use_tanh_at_final", "use_bias_at_final",
                    "max_wav_value")}
    native = tmp_path / "native.yaml"
    native.write_text(yaml.safe_dump({"model": {"vocoder_model": "BigVGAN"},
                                      "vocoder": voc}))
    ref_layout = tmp_path / "reference.yaml"
    hifi = {k: v for k, v in voc.items() if k != "max_wav_value"}
    hifi["MAX_WAV_VALUE"] = 32767.0
    ref_layout.write_text(yaml.safe_dump({
        "model_config": {"vocoder": {"model": "BigVGAN"}}, "hifi": hifi}))
    for path in (native, ref_layout):
        cfg = load_config(str(path))
        assert cfg.model.vocoder_model == "BigVGAN"
        assert cfg.vocoder.max_wav_value == 32767.0
        vocoder = Vocoder(cfg, device="cpu")
        assert isinstance(vocoder.model, BigVGAN)
        mel = torch.randn(2, 12, 80, generator=torch.Generator().manual_seed(5))
        wavs = vocoder.generate(mel, np.array([12 * 256, 7 * 256]))
        assert [len(w) for w in wavs] == [12 * 256, 7 * 256]
        assert wavs[0].dtype == np.int16
        whole = vocoder.generate(mel)
        np.testing.assert_array_equal(whole[1, :7 * 256], wavs[1])
    assert wav_to_int16(torch.tensor([1.0, -1.0]), 32767.0).tolist() == [
        32767, -32767]
    hifigan = tmp_path / "hifigan.yaml"
    hifigan.write_text(yaml.safe_dump({"vocoder": voc}))
    with pytest.raises(ValueError, match="BigVGAN"):
        load_config(str(hifigan))


def _upstream_state(sd, cfg, filters=True):
    """A state dict in NVIDIA/BigVGAN's layout for the port's ``sd``:
    weight norm as (weight_g, weight_v) pairs with g = ||v|| / 2 (dim 0)
    and v = 2 x the weight, so that folding gives the weight back."""
    up = {}

    def wn(src, dst):
        w = sd[f"{src}.weight"]
        g = w.flatten(1).norm(dim=1).view(-1, *[1] * (w.dim() - 1))
        up[f"{dst}.weight_v"] = 2.0 * w
        up[f"{dst}.weight_g"] = g
        if f"{src}.bias" in sd:
            up[f"{dst}.bias"] = sd[f"{src}.bias"]

    def act(src, dst):
        up[f"{dst}.act.alpha"] = sd[f"{src}.alpha"]
        up[f"{dst}.act.beta"] = sd[f"{src}.beta"]
        if filters:
            f = amp.lowpass_filter().view(1, 1, 12)
            up[f"{dst}.upsample.filter"] = f.clone()
            up[f"{dst}.downsample.lowpass.filter"] = f.clone()

    wn("conv_pre", "conv_pre")
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        wn(f"ups_{i}", f"ups.{i}.0")
        for j in range(n_k):
            n = i * n_k + j
            for d in range(3):
                for g in ("convs1", "convs2"):
                    wn(f"resblocks_{n}.{g}_{d}", f"resblocks.{n}.{g}.{d}")
            for m in range(6):
                act(f"resblocks_{n}.activations_{m}",
                    f"resblocks.{n}.activations.{m}")
    act("activation_post", "activation_post")
    wn("conv_post", "conv_post")
    return up


def test_published_checkpoint_layout_loads_through_the_vocoder(tmp_path):
    from tts_king_torch.checkpoint import convert_bigvgan_generator
    from tts_king_torch.config import TTSConfig
    from tts_king_torch.pipeline import Vocoder

    cfg = micro_config()
    model, sd = seeded(BigVGAN(cfg), 7)
    upstream = _upstream_state(sd, cfg)
    converted = convert_bigvgan_generator(
        upstream, n_ups=6, dilations=cfg.resblock_dilation_sizes)
    assert converted.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(converted[k], sd[k], rtol=1e-6, atol=1e-7)
    path = tmp_path / "bigvgan_generator.pt"
    torch.save({"generator": upstream}, path)
    tc = TTSConfig()
    tc.model.vocoder_model = "BigVGAN"
    tc.vocoder = dataclasses.replace(cfg, weights_path=str(path))
    vocoder = Vocoder(tc, device="cpu")
    mel = torch.randn(1, 9, 80, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        torch.testing.assert_close(vocoder(mel), model(mel), rtol=0,
                                   atol=1e-5)
    bad = dict(upstream)
    bad["activation_post.upsample.filter"] = torch.ones(1, 1, 12) / 12
    with pytest.raises(ValueError, match="Kaiser"):
        convert_bigvgan_generator(bad, n_ups=6,
                                  dilations=cfg.resblock_dilation_sizes)
    with pytest.raises(ValueError, match="conv_post.bias"):
        convert_bigvgan_generator(
            dict(upstream, **{"conv_post.bias": torch.zeros(1)}), n_ups=6,
            dilations=cfg.resblock_dilation_sizes)


def test_receptive_field():
    """Each family's field (pipeline.VOCODERS): BigVGAN's adds its
    activations' filters (5 samples a side each, two a dilation and one
    before conv_post); HiFi-GAN's is 17 at V1, and 17 at the benchmark's
    MelGAN configuration, whose VocoderModelConfig keeps HiFi-GAN's default
    kernels (MelGAN takes HiFi-GAN's field, as in the JAX package). The
    Vocoder's halo is its family's."""
    from tts_king_torch.config import TTSConfig
    from tts_king_torch.pipeline import Vocoder, vocoder_family

    def field(name, cfg):
        return vocoder_family(name).receptive_field(cfg)

    assert field("HiFi-GAN", VocoderModelConfig()) == 17
    melgan = VocoderModelConfig(
        upsample_rates=[8, 8, 2, 2], num_mels=80, hop_size=256,
        sampling_rate=22050, max_wav_value=32768.0)
    assert field("MelGAN", melgan) == 17
    assert field("BigVGAN", bigvgan_config()) == 42
    tc = TTSConfig()
    tc.model.vocoder_model = "BigVGAN"
    tc.vocoder = micro_config()
    assert Vocoder(tc, device="cpu").halo_frames == BigVGAN.receptive_field(
        micro_config()) == 42
    with pytest.raises(ValueError, match="HiFi-GAN, MelGAN, BigVGAN"):
        vocoder_family("WaveGlow")


def test_streaming_matches_the_whole_utterance():
    """Chunks vocoded with the receptive field as halo equal the whole
    pass in the interior (the utterance's edges see the edge frames
    repeated, where the whole pass sees the convs' zero padding)."""
    from tts_king_torch.ops.streaming import stream_vocoder

    cfg = micro_config()
    model, _ = seeded(BigVGAN(cfg), 8)
    rf = BigVGAN.receptive_field(cfg)
    mel = np.random.RandomState(0).randn(1, 3 * rf, 80).astype(np.float32)

    def vocode(m):
        with torch.no_grad():
            return model(torch.from_numpy(m)).numpy()

    chunks = list(stream_vocoder(vocode, mel, chunk_frames=24,
                                 halo_frames=rf, hop=256))
    full = vocode(mel)[0]
    streamed = np.concatenate(chunks)
    assert streamed.shape == full.shape
    edge = rf * 256
    np.testing.assert_allclose(streamed[edge:-edge], full[edge:-edge],
                               rtol=0, atol=1e-5)
    # a halo short of the activations' reach does not reproduce it
    short = np.concatenate(list(stream_vocoder(
        vocode, mel, chunk_frames=24, halo_frames=2, hop=256)))
    assert np.abs(short[edge:-edge] - full[edge:-edge]).max() > 1e-4


def test_port_seeds_log_scale_parameters_near_zero():
    from tts_king_torch.weights import seeded_state_dict

    with torch.device("meta"):
        model = BigVGAN(micro_config())
    sd = seeded_state_dict(model, 0)
    alphas = torch.cat([v for k, v in sd.items() if k.endswith(".alpha")])
    assert float(alphas.abs().mean()) < 0.2


def _mean_parts(shape, n, dtype, gen, device="cpu"):
    """n blocks' parts (a, bias, x) for amp_mean, a and x in their dtype's
    layout."""
    B, C, T = shape
    return [tuple(t.to(dtype) if t.dim() == 1 else laid_out(t.to(dtype))
                  for t in (
        torch.randn(B, T, C, generator=gen, device=device).transpose(1, 2),
        torch.randn(C, generator=gen, device=device),
        torch.randn(B, T, C, generator=gen, device=device).transpose(1, 2)))
        for _ in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 3])
def test_stage_mean_sums_the_blocks_parts_in_f32(n, dtype):
    """amp_mean: sum_j (a_j + bias_j + x_j) / n from the parts as given,
    summed in f32 in that order and rounded once, in the dtype's layout;
    one block's mean is its output. Counts no launch on the CPU."""
    g = torch.Generator().manual_seed(n)
    parts = _mean_parts((2, 12, 9), n, dtype, g)
    s = 0
    for a, b, x in parts:
        s = s + ((a.float() + b.float()[:, None]) + x.float())
    launches = amp.mean_launches
    got = amp.amp_mean(parts)
    assert got.dtype == dtype and _lies_as_its_dtype(got)
    assert torch.equal(got, (s / n).to(dtype))
    assert amp.mean_launches == launches


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# (B, C, T) of each stage's activations at B 32 and the mel bucket 1000,
# and ragged shapes: C no multiple of 8 (one element at a time), T no
# multiple of 8, T shorter than a tile, a tile and a frame past it.
STAGE_SHAPES = [(32, 768, 4000), (32, 384, 16000), (32, 192, 32000),
                (32, 96, 64000), (32, 48, 128000), (32, 24, 256000)]
RAGGED_SHAPES = [(3, 5, 1), (2, 7, 13), (3, 9, 1027), (2, 24, 2053),
                 (2, 16, 3072), (1, 32, 5000)]


def _inputs(shape, dtype, device, seed):
    """x (and the residual) in the dtype's layout, in bf16 x a prefix of
    each item's rows of a longer signal (a compacted fold's batch stride);
    alpha, beta, bias."""
    B, C, T = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = 3.0 * torch.randn(B, T + 8, C, generator=g, device=device)
    r = torch.randn(B, T, C, generator=g, device=device)
    alpha = 0.3 * torch.randn(C, generator=g, device=device)
    beta = 0.3 * torch.randn(C, generator=g, device=device)
    bias = torch.randn(C, generator=g, device=device)
    return [laid_out(t.to(dtype)) if t.dim() == 3 else t.to(dtype)
            for t in (x[:, :T].transpose(1, 2), alpha, beta, bias,
                      r.transpose(1, 2))]


def _bf16_ulp(t):
    """One bf16 ulp at each value of a bf16 tensor (2^(e - 7))."""
    e = torch.floor(torch.log2(t.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.chip
@pytest.mark.parametrize("prologue", ["none", "bias", "residual"])
@pytest.mark.parametrize("shape", STAGE_SHAPES + RAGGED_SHAPES)
def test_kernel_matches_plain_on_the_card(cuda_device, shape, prologue):
    """The kernel on signals in their dtype's layout (bf16 (B, T, C), the
    tile kernel; f32 (B, C, T), the row kernel) against the plain version
    of the f32 sum of its inputs (none, a conv's bias, the bias and a
    residual).
    f32: within 1e-6 of the plain version relative to the largest value
    (the kernel's sums run in another order); bf16: within one bf16 ulp of
    the plain f32 result rounded once, or within 1e-5 of the largest value
    where the sums cancel to near zero and the ulp is smaller than f32's
    own rounding of them. The stored sum equals the f32 sum rounded once,
    and the outputs lie in the inputs' layout."""
    extra = {"none": lambda b, r: (), "bias": lambda b, r: (b,),
             "residual": lambda b, r: (b, r)}[prologue]
    for dtype in (torch.float32, torch.bfloat16):
        x, a, b, bias, r = _inputs(shape, dtype, cuda_device, sum(shape))
        s = x.float()
        if prologue != "none":
            s = s + bias.float()[:, None]
        if prologue == "residual":
            s = s + r.float()
        got = amp.amp_act(x, a, b, *extra(bias, r))
        if prologue == "residual":
            total, got = got
            assert torch.equal(total, s.to(dtype))
        ref = amp.amp_act_plain(s, a.float(), b.float())
        torch.cuda.synchronize()
        assert got.dtype == dtype and _lies_as_its_dtype(got)
        scale = float(ref.abs().max())
        if dtype == torch.float32:
            assert float((got - ref).abs().max()) <= 1e-6 * scale
            continue
        rounded = ref.bfloat16()
        err = (got.float() - rounded.float()).abs()
        room = torch.maximum(_bf16_ulp(rounded), torch.full_like(
            err, 1e-5 * scale))
        assert bool((err <= room).all()), float((err - room).max())


@pytest.mark.chip
@pytest.mark.parametrize("shape", [(32, 384, 16000), (2, 24, 2053),
                                   (3, 5, 7)])
def test_stage_mean_matches_plain_on_the_card(cuda_device, shape):
    """The stage-mean kernel equals the f32 sum of its parts divided by n
    and rounded once, bit for bit (the same f32 operations in the same
    order), in both dtypes; C = 5 takes the one-element path."""
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    for dtype in (torch.float32, torch.bfloat16):
        parts = _mean_parts(shape, 3, dtype, g, cuda_device)
        s = 0
        for a, b, x in parts:
            s = s + ((a.float() + b.float()[:, None]) + x.float())
        got = amp.amp_mean(parts)
        torch.cuda.synchronize()
        assert got.dtype == dtype and _lies_as_its_dtype(got)
        # a divisor on the card: PyTorch multiplies by the reciprocal of a
        # Python scalar there, where the kernel divides
        n = torch.full((), 3.0, device=cuda_device)
        assert torch.equal(got, (s / n).to(dtype))
