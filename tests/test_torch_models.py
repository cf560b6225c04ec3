"""The port's models on the CPU against the JAX package: FastSpeech2 and the
HiFi-GAN Generator on the committed golden fixtures, and against the JAX
modules with the Pallas kernels in interpret mode; plus the ops and the
weight bridge they rest on."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_king_torch.weights import (flax_to_torch, load_flax_npz, load_into,
                                    torch_to_flax)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _tiny_model_config(postnet_dim=32):
    """tests/test_train._tiny_setup's ModelConfig, in the port's config."""
    from tts_king_torch.config import (ModelConfig, TransformerConfig,
                                       VariancePredictorConfig)

    return ModelConfig(
        transformer=TransformerConfig(
            encoder_layer=1, encoder_head=2, encoder_hidden=16,
            variance_hidden=16, decoder_layer=1, decoder_head=2,
            decoder_hidden=16, conv_filter_size=32, conv_kernel_size=(9, 1)),
        variance_predictor=VariancePredictorConfig(filter_size=16),
        max_seq_len=32, postnet_dim=postnet_dim)


def _torch_fs2(variables):
    from tts_king_torch.models.fs2 import FastSpeech2

    model = FastSpeech2(_tiny_model_config(), n_speakers=3, pitch_min=-2,
                        pitch_max=2, energy_min=-2, energy_max=2)
    return load_into(model, flax_to_torch(variables)).eval()


def _run_fs2(model, speakers, texts, src_lens, **kw):
    with torch.no_grad():
        out = model(torch.as_tensor(speakers).long(),
                    torch.as_tensor(texts).long(),
                    torch.as_tensor(src_lens).int(), **kw)
    return {k: v.numpy() for k, v in out.items() if v is not None}


def test_fs2_golden_fixture():
    z = np.load(os.path.join(FIXTURES, "golden_fs2.npz"))
    model = _torch_fs2(load_flax_npz(os.path.join(FIXTURES,
                                                  "golden_fs2.npz")))
    out = _run_fs2(model, z["in::speakers"], z["in::texts"],
                   z["in::src_lens"], max_mel_len=32)
    np.testing.assert_array_equal(out["mel_lens"], z["out::mel_lens"])
    for key in ("log_duration_prediction", "mel", "postnet_mel"):
        np.testing.assert_allclose(out[key], z[f"out::{key}"], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_fs2_matches_jax_with_pallas_attention_ragged():
    """Ragged batch, d_control 1.3, against the JAX FS2 whose attention is
    the Pallas kernel in interpret mode."""
    import tts_king_tpu.ops.pallas.attention as pa
    from tts_king_tpu.config import (ModelConfig, TransformerConfig,
                                     VariancePredictorConfig)
    from tts_king_tpu.models.fs2 import FastSpeech2

    variables = load_flax_npz(os.path.join(FIXTURES, "golden_fs2.npz"))
    mc = ModelConfig(
        transformer=TransformerConfig(
            encoder_layer=1, encoder_head=2, encoder_hidden=16,
            variance_hidden=16, decoder_layer=1, decoder_head=2,
            decoder_hidden=16, conv_filter_size=32, conv_kernel_size=(9, 1)),
        variance_predictor=VariancePredictorConfig(filter_size=16),
        max_seq_len=32, postnet_dim=32, use_pallas_attention=True)
    jmodel = FastSpeech2(model_config=mc, n_speakers=3, pitch_min=-2,
                         pitch_max=2, energy_min=-2, energy_max=2)
    rng = np.random.RandomState(3)
    speakers = np.array([2, 0, 1], np.int32)
    texts = rng.randint(1, 200, (3, 12)).astype(np.int32)
    src_lens = np.array([12, 7, 3], np.int32)
    texts[1, 7:] = 0
    texts[2, 3:] = 0

    orig = pa.fused_attention
    pa.fused_attention = lambda q, k, v, m: orig(q, k, v, m, interpret=True)
    try:
        ref = jmodel.apply(jax.tree.map(jnp.asarray, variables), speakers,
                           texts, src_lens, max_mel_len=48, d_control=1.3,
                           train=False)
    finally:
        pa.fused_attention = orig
    got = _run_fs2(_torch_fs2(variables), speakers, texts, src_lens,
                   max_mel_len=48, d_control=1.3)
    for key in ("mel_lens", "mel_lens_raw"):
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(got["duration_rounded"],
                                  np.asarray(ref["duration_rounded"]))
    for key in ("log_duration_prediction", "pitch_prediction",
                "energy_prediction", "mel", "postnet_mel"):
        np.testing.assert_allclose(got[key], np.asarray(ref[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def _torch_generator(cfg, params):
    from tts_king_torch.config import VocoderModelConfig
    from tts_king_torch.models.hifigan import Generator

    gen = Generator(VocoderModelConfig(**dataclasses.asdict(cfg)))
    return load_into(gen, flax_to_torch({"params": params})).eval()


def _tiny_voc_config():
    from tts_king_tpu.config import VocoderModelConfig

    return VocoderModelConfig(upsample_rates=[4, 4],
                              upsample_kernel_sizes=[8, 8],
                              upsample_initial_channel=32)


def _gen(gen, mel):
    with torch.no_grad():
        return gen(torch.from_numpy(np.asarray(mel, np.float32))).numpy()


def test_generator_golden_vocoder_fixture():
    z = np.load(os.path.join(FIXTURES, "golden_vocoder.npz"))
    params = load_flax_npz(os.path.join(FIXTURES,
                                        "golden_vocoder.npz"))["params"]
    wav = _gen(_torch_generator(_tiny_voc_config(), params), z["in::mel"])
    np.testing.assert_allclose(wav, z["out::wav"], rtol=1e-5, atol=1e-5)


def test_generator_golden_trained_vocoder_fixture():
    from tests.test_golden_vocoder_trained import micro_voc_config

    path = os.path.join(FIXTURES, "golden_trained_vocoder.npz")
    z = np.load(path)
    wav = _gen(_torch_generator(micro_voc_config(),
                                load_flax_npz(path)["params"]), z["mel"])
    assert wav.shape == z["expected_wav"].shape
    np.testing.assert_allclose(wav, z["expected_wav"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_generator_matches_jax_fused_backend(resblock):
    """Random non-trivial weights, against the JAX Generator whose MRF
    stages run the Pallas kernel (interpret mode on the CPU). ResBlock2
    stages are not fused in either package: plain convs on both sides."""
    from tts_king_tpu.models.hifigan import Generator as JaxGenerator

    cfg = dataclasses.replace(_tiny_voc_config(), resblock=resblock)
    if resblock == "2":
        cfg = dataclasses.replace(cfg, resblock_kernel_sizes=[3, 7],
                                  resblock_dilation_sizes=[[1, 3], [1, 3]])
    rng = np.random.RandomState(1)
    mel = rng.randn(2, 16, 80).astype(np.float32)
    jgen = JaxGenerator(cfg, mrf_backend="fused")
    shapes = jax.eval_shape(lambda: jgen.init(jax.random.PRNGKey(0),
                                              jnp.asarray(mel)))["params"]
    params = jax.tree.map(
        lambda s: (rng.randn(*s.shape) * 0.05).astype(np.float32), shapes)
    ref = np.asarray(jgen.apply({"params": params}, jnp.asarray(mel)))
    got = _gen(_torch_generator(cfg, params), mel)
    assert got.shape == ref.shape
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    assert rel < 1e-5, rel


def test_generator_int8_backend_state_dict_and_cast():
    """A fused_int8 Generator has the state dict of a fused one (it loads
    the same checkpoints); its int8 taps (in the plain version's layout and
    the CUDA kernel's), f32 weight scales and f32 biases stay out of it and
    survive .to(torch.bfloat16) unchanged."""
    from tts_king_torch.models.hifigan import Generator

    cfg = _tiny_voc_config()
    fused = Generator(cfg, mrf_backend="fused")
    int8 = Generator(cfg, mrf_backend="fused_int8")
    a, b = fused.state_dict(), int8.state_dict()
    assert a.keys() == b.keys()
    assert all(a[k].shape == b[k].shape for k in a)
    int8.load_state_dict(a)
    bufs = {n: t.clone() for n, t in int8.named_buffers()}
    assert {t.dtype for t in bufs.values()} == {torch.int8, torch.float32}
    assert len(bufs) == 4 * len(cfg.upsample_rates)   # every stage fused
    int8.to(torch.bfloat16)
    for n, t in int8.named_buffers():
        assert t.dtype == bufs[n].dtype, n
        assert torch.equal(t, bufs[n]), n
    assert int8.conv_pre.weight.dtype == torch.bfloat16


def test_fs2_cwt_not_ported():
    """use_cwt=True, which raised before the CWT branch was ported, builds
    the CWT pitch predictor (11 scales, its own dropout module at 0.1, so
    the no-dropout helpers reach it) and the mean and std heads
    (tests/test_torch_cwt.py holds them to JAX)."""
    from tts_king_torch.models.fs2 import FastSpeech2
    from tts_king_torch.models.layers import CNNScalar, Dropout

    va = FastSpeech2(dataclasses.replace(_tiny_model_config(), use_cwt=True)
                     ).variance_adaptor
    assert va.pitch_predictor.linear_layer.out_features == 11
    assert isinstance(va.pitch_predictor.dropout, Dropout)
    assert va.pitch_predictor.dropout.p == 0.1
    assert va.energy_predictor.dropout.p == 0.5
    assert isinstance(va.pitch_mean, CNNScalar)
    assert isinstance(va.pitch_std, CNNScalar)
    plain = FastSpeech2(_tiny_model_config()).variance_adaptor
    assert not hasattr(plain, "pitch_mean")


@pytest.mark.parametrize("fixture", ["golden_fs2.npz", "golden_vocoder.npz"])
def test_weight_bridge_round_trip(fixture):
    variables = load_flax_npz(os.path.join(FIXTURES, fixture))
    back = torch_to_flax(flax_to_torch(variables))

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    a = dict(flat(variables))
    b = dict(flat(back))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def test_conv_transpose_bridge_matches_jax():
    """(k, Cin, Cout) flax transposed-conv kernel -> torch (Cin, Cout, k)
    with no flip gives the JAX package's conv_transpose1d."""
    from tts_king_tpu.ops.convs import conv_transpose1d

    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 6).astype(np.float32)
    kern = rng.randn(16, 6, 4).astype(np.float32)
    bias = rng.randn(4).astype(np.float32)
    ref = np.asarray(conv_transpose1d(jnp.asarray(x), jnp.asarray(kern),
                                      jnp.asarray(bias), stride=8,
                                      padding=4))
    sd = flax_to_torch({"params": {"ups_0": {"kernel": kern, "bias": bias}}})
    conv = torch.nn.ConvTranspose1d(6, 4, 16, stride=8, padding=4)
    conv.load_state_dict({"weight": sd["ups_0.weight"],
                          "bias": sd["ups_0.bias"]})
    with torch.no_grad():
        got = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_length_regulate_matches_jax():
    from tts_king_torch.ops.length_regulator import length_regulate
    from tts_king_tpu.ops.length_regulator import \
        length_regulate as jax_length_regulate

    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 5).astype(np.float32)
    dur = rng.randint(0, 5, (3, 7)).astype(np.float32)
    dur[2] = 9.0   # overflows the output length: clamped output, raw length
    for T in (16, 40):
        ref, ref_len = jax_length_regulate(jnp.asarray(x), jnp.asarray(dur), T)
        got, got_len = length_regulate(torch.from_numpy(x),
                                       torch.from_numpy(dur), T)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))


def test_round_durations_half_to_even_matches_jax():
    from tts_king_torch.ops.length_regulator import round_durations
    from tts_king_tpu.ops.length_regulator import \
        round_durations as jax_round_durations

    # exp(logd) - 1 = 0.5, 1.5, 2.5, 3.5 and a negative one
    logd = np.log(np.array([[1.5, 2.5, 3.5, 4.5, 0.2]], np.float32))
    for c in (1.0, 1.3):
        ref = np.asarray(jax_round_durations(jnp.asarray(logd), c))
        got = round_durations(torch.from_numpy(logd), c).numpy()
        np.testing.assert_array_equal(got, ref)


def test_mask_from_lengths():
    from tts_king_torch.ops.masks import lengths_from_mask, mask_from_lengths

    m = mask_from_lengths(torch.tensor([0, 2, 4], dtype=torch.int32), 4)
    np.testing.assert_array_equal(m.numpy(), np.arange(4)[None] >=
                                  np.array([0, 2, 4])[:, None])
    np.testing.assert_array_equal(lengths_from_mask(m).numpy(), [0, 2, 4])
