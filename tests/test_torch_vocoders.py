"""The port's vocoder side on the CPU against the JAX package: upstream
HiFi-GAN and MelGAN checkpoints (``.pth`` / ``.pth.tar`` written here with
torch.save, weight norm folded) through both packages' ``Vocoder``, the
torch checkpoint reader on the committed pth_reader fixture, MelGAN against
the recorded upstream oracle and against the JAX module at an odd ratio, the
weight bridge for MelGAN's upsamplers, and streaming (``stream_vocoder``,
``TTSKing.speak_streaming``) against the JAX streaming and the full pass.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle_util import run_oracle
from tts_king_torch.weights import flax_to_torch, load_into, torch_to_flax

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _configs(**vocoder):
    """The same TTSConfig in the JAX package's and the port's config."""
    from tts_king_torch import config as port_config
    from tts_king_tpu.config import TTSConfig, VocoderModelConfig

    cfg = TTSConfig(vocoder=VocoderModelConfig(**vocoder))
    port = port_config._build(port_config.TTSConfig,
                              dataclasses.asdict(cfg)).validate()
    return cfg, port


def _tiny_hifigan(resblock):
    kw = dict(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
              upsample_initial_channel=32, resblock=resblock)
    if resblock == "2":
        kw.update(resblock_kernel_sizes=[3, 7],
                  resblock_dilation_sizes=[[1, 3], [1, 3]])
    return kw


def _weight_normed(rng, shape):
    """Upstream weight norm (dim=0): v and g of shape (out, 1, ..., 1)."""
    return {"weight_v": rng.randn(*shape).astype(np.float32) * 0.1,
            "weight_g": (1.0 + 0.1 * rng.randn(shape[0], *[1] * (len(shape)
                                                                 - 1)))
            .astype(np.float32)}


@pytest.mark.parametrize("resblock", ["1", "2"])
@pytest.mark.parametrize("suffix", [".pth.tar", ".pth"])
def test_hifigan_torch_checkpoint_matches_jax_vocoder(tmp_path, resblock,
                                                      suffix):
    """{"generator": weight-normed state dict} saved with torch.save, loaded
    by the port's Vocoder and by the JAX Vocoder: the waveforms agree."""
    from tts_king_torch.pipeline import Vocoder
    from tts_king_tpu.pipeline import Vocoder as JaxVocoder

    from chip_smoke import upstream_hifigan_state

    jcfg, pcfg = _configs(**_tiny_hifigan(resblock))
    rng = np.random.RandomState(int(resblock))
    path = str(tmp_path / f"g_00100000{suffix}")
    torch.save({"generator": upstream_hifigan_state(pcfg.vocoder,
                                                    int(resblock))}, path)
    jcfg.vocoder.weights_path = pcfg.vocoder.weights_path = path
    mel = rng.randn(2, 12, 80).astype(np.float32)
    got = Vocoder(pcfg, device="cpu")(mel).numpy()
    ref = np.asarray(JaxVocoder(jcfg)(mel))
    assert got.shape == ref.shape == (2, 12 * 16)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_fold_weight_norm_matches_torch_weight_norm():
    from tts_king_torch.checkpoint import fold_weight_norm

    conv = torch.nn.utils.parametrizations.weight_norm(
        torch.nn.ConvTranspose1d(6, 4, 8))
    with torch.no_grad():
        conv.parametrizations.weight.original0.mul_(1.7)
    state = {"up.weight_g": conv.parametrizations.weight.original0,
             "up.weight_v": conv.parametrizations.weight.original1}
    torch.testing.assert_close(fold_weight_norm(state, "up"),
                               conv.weight.detach(), rtol=1e-6, atol=1e-7)


def test_load_torch_checkpoint_reads_the_pth_reader_fixture():
    """The committed mixed.pth.tar (every dtype and layout a state dict
    holds) reads to mixed_expected.npz."""
    from tts_king_torch.checkpoint import load_torch_checkpoint

    ck = load_torch_checkpoint(os.path.join(FIXTURES, "pth_reader",
                                            "mixed.pth.tar"))
    assert ck["step"] == 290000
    assert ck["optimizer"]["param_groups"][0]["lr"] == 1e-4
    expected = np.load(os.path.join(FIXTURES, "pth_reader",
                                    "mixed_expected.npz"))
    assert len(expected.files) > 10
    for key in expected.files:
        node = ck
        for part in key.split("|"):
            node = node[part]
        if node.dtype == torch.bfloat16:   # recorded as raw bits
            got = node.view(torch.int16).numpy().view(np.uint16)
        else:
            got = node.detach().numpy()
        np.testing.assert_array_equal(got, expected[key], err_msg=key)


# -- MelGAN


def _port_melgan(state, **kw):
    from tts_king_torch.checkpoint import convert_melgan_state
    from tts_king_torch.models.melgan import MelGANGenerator

    model = MelGANGenerator(**kw)
    return load_into(model, convert_melgan_state(
        state, kw["ratios"], kw["n_residual_layers"])).eval()


def test_melgan_matches_upstream_oracle():
    """The recorded upstream MelGAN (tests/test_melgan.py's inputs): the
    weight-normed Sequential state, converted, at its tolerance."""
    rng = np.random.RandomState(0)
    B, T = 2, 17
    ngf, n_res, ratios = 4, 2, (4, 2)
    mel = rng.randn(B, 80, T).astype(np.float32)
    out = run_oracle("melgan", dict(seed=3, ngf=ngf, n_residual_layers=n_res,
                                    ratios=np.array(ratios), mel=mel))
    state = {k[len("state__"):]: torch.from_numpy(v) for k, v in out.items()
             if k.startswith("state__")}
    model = _port_melgan(state, ngf=ngf, n_residual_layers=n_res,
                         ratios=ratios)
    with torch.no_grad():
        wav = model(torch.from_numpy(mel.transpose(0, 2, 1).copy())).numpy()
    ref = out["wav"][:, 0, :]
    assert wav.shape == ref.shape == (B, T * 8)
    np.testing.assert_allclose(wav, ref, rtol=1e-4, atol=1e-5)


def _jax_melgan_params(model, mel, seed):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.asarray(mel)))
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda s: (rng.randn(*s.shape) * 0.1).astype(np.float32), shapes)


@pytest.mark.parametrize("ratios", [(3, 2), (5, 3)])
def test_melgan_odd_ratio_matches_jax(ratios):
    """At an odd ratio the JAX module appends a zero sample where upstream
    computes one (output_padding); the port follows the JAX module. The
    flax tree crosses the weight bridge, whose transposed-conv rule covers
    MelGAN's up_<i>."""
    from tts_king_torch.models.melgan import MelGANGenerator
    from tts_king_tpu.models.melgan import MelGANGenerator as JaxMelGAN

    kw = dict(ngf=4, n_residual_layers=2, ratios=ratios)
    mel = np.random.RandomState(1).randn(2, 11, 80).astype(np.float32)
    jmodel = JaxMelGAN(**kw)
    variables = _jax_melgan_params(jmodel, mel, seed=2)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(mel)))
    model = load_into(MelGANGenerator(**kw), flax_to_torch(variables)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (2, 11 * int(np.prod(ratios)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_weight_bridge_round_trips_a_flax_melgan_tree():
    from tts_king_torch.models.melgan import MelGANGenerator
    from tts_king_tpu.models.melgan import MelGANGenerator as JaxMelGAN

    kw = dict(ngf=4, n_residual_layers=2, ratios=(4, 2))
    mel = np.zeros((1, 8, 80), np.float32)
    variables = _jax_melgan_params(JaxMelGAN(**kw), mel, seed=3)
    sd = flax_to_torch(variables)
    assert tuple(sd["up_0.weight"].shape) == (16, 8, 8)   # (Cin, Cout, k)
    load_into(MelGANGenerator(**kw), sd)
    back = torch_to_flax(sd)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    a, b = flat(variables), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=str(k))


def _upstream_melgan_state(ratios, n_res, ngf, rng):
    """A weight-normed descript MelGAN state dict (``model.{idx}``)."""
    state = {}

    def conv(idx, shape, transposed=False):
        for name, a in _weight_normed(rng, shape).items():
            state[f"model.{idx}.{name}"] = torch.from_numpy(a)
        out = shape[1] if transposed else shape[0]
        state[f"model.{idx}.bias"] = torch.from_numpy(
            (0.02 * rng.randn(out)).astype(np.float32))

    ch = ngf * 2 ** len(ratios)
    conv(1, (ch, 80, 7))                      # after the ReflectionPad1d
    idx = 3
    for r in ratios:                          # LeakyReLU, convT, blocks
        conv(idx, (ch, ch // 2, 2 * r), transposed=True)
        ch //= 2
        for j in range(n_res):
            idx += 1
            conv(f"{idx}.block.2", (ch, ch, 3))
            conv(f"{idx}.block.4", (ch, ch, 1))
            conv(f"{idx}.shortcut", (ch, ch, 1))
        idx += 2
    conv(idx + 1, (1, ch, 7))                 # after LeakyReLU, pad
    return state


def test_melgan_vocoder_loads_a_torch_checkpoint_like_jax(tmp_path):
    """Vocoder(vocoder_model="MelGAN") on a ``mel2wav.``-prefixed .pth (the
    hub wrapper's state dict), against the JAX Vocoder on the same file: the
    natural-log mel is divided by ln 10 in both."""
    from tts_king_torch.pipeline import Vocoder
    from tts_king_tpu.pipeline import Vocoder as JaxVocoder

    jcfg, pcfg = _configs(upsample_rates=[4, 2])
    jcfg.model.vocoder_model = pcfg.model.vocoder_model = "MelGAN"
    rng = np.random.RandomState(5)
    state = _upstream_melgan_state((4, 2), 3, 32, rng)
    assert "model.8.weight_v" in state and "model.14.bias" in state
    path = str(tmp_path / "multi_speaker.pt")
    torch.save({f"mel2wav.{k}": v for k, v in state.items()}, path)
    jcfg.vocoder.weights_path = pcfg.vocoder.weights_path = path
    mel = rng.randn(1, 9, 80).astype(np.float32)
    voc = Vocoder(pcfg, device="cpu")
    got = voc(mel).numpy()
    ref = np.asarray(JaxVocoder(jcfg)(mel))
    assert got.shape == ref.shape == (1, 9 * 8)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    wav = voc.generate(mel)
    assert wav.dtype == np.int16 and wav.shape == (1, 72)


# -- streaming


def _stream_setup():
    from tests.test_vocoder_training import _tiny_cfg
    from tts_king_torch import config as port_config
    from tts_king_torch.models.hifigan import Generator
    from tts_king_tpu.models.hifigan import Generator as JaxGenerator

    jcfg = _tiny_cfg()   # hop 16, upsample 4 x 4, 16 mel bands
    pcfg = port_config._build(port_config.VocoderModelConfig,
                              dataclasses.asdict(jcfg))
    jgen = JaxGenerator(jcfg)
    variables = jgen.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8, jcfg.num_mels)))
    gen = load_into(Generator(pcfg), flax_to_torch(variables)).eval()
    return jcfg, pcfg, jax.jit(jgen.apply), variables, gen


def test_stream_vocoder_matches_jax_and_full_pass():
    """The port's chunks equal the JAX streaming's chunks on the same
    weights, and the full pass in the interior (tests/test_streaming.py)."""
    from tts_king_torch.ops.streaming import (generator_receptive_field,
                                              stream_vocoder)
    from tts_king_tpu.ops.streaming import \
        generator_receptive_field as jax_receptive_field
    from tts_king_tpu.ops.streaming import stream_vocoder as jax_stream

    jcfg, pcfg, japply, variables, gen = _stream_setup()
    rf = generator_receptive_field(pcfg)
    assert rf == jax_receptive_field(jcfg) and rf < 40
    mel = np.random.RandomState(0).randn(1, 150, jcfg.num_mels).astype(
        np.float32)

    def vocode(m):
        with torch.no_grad():
            return gen(torch.from_numpy(m)).numpy()

    chunks = list(stream_vocoder(vocode, mel, chunk_frames=48,
                                 halo_frames=rf, hop=pcfg.hop_size))
    ref = list(jax_stream(japply, variables, mel, chunk_frames=48,
                          halo_frames=rf, hop=jcfg.hop_size))
    assert [len(c) for c in chunks] == [len(c) for c in ref]
    assert len(chunks[0]) == 48 * pcfg.hop_size
    for a, b in zip(chunks, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    full = vocode(mel)[0]
    streamed = np.concatenate(chunks)
    assert streamed.shape == full.shape
    edge = rf * pcfg.hop_size
    np.testing.assert_allclose(streamed[edge:-edge], full[edge:-edge],
                               rtol=1e-4, atol=1e-5)


def test_speak_streaming_matches_speak(tmp_path):
    """int16 chunks whose total length is speak()'s and whose interior is
    speak()'s waveform (tests/test_streaming.py:49-68)."""
    from tts_king_torch.config import micro_config
    from tts_king_torch.ops.streaming import generator_receptive_field
    from tts_king_torch.pipeline import TTSKing

    cfg = micro_config()
    lex = tmp_path / "mini.dict"
    lex.write_text("привет P R I0 V E0 T\n", encoding="utf-8")
    cfg.preprocess.lexicon_path = str(lex)
    king = TTSKing(cfg, device="cpu")
    head = king.tts.model.variance_adaptor.duration_predictor.linear_layer
    with torch.no_grad():
        head.bias.fill_(1.8)
    chunks = list(king.speak_streaming("привет", chunk_frames=16))
    assert len(chunks) > 1
    assert all(c.dtype == np.int16 for c in chunks)
    assert len(chunks[0]) == 16 * cfg.preprocess.stft.hop_length
    wav = king.speak("привет")[0]
    streamed = np.concatenate(chunks)
    assert streamed.shape == wav.shape
    edge = generator_receptive_field(cfg.vocoder) * \
        cfg.preprocess.stft.hop_length
    diff = np.abs(streamed[edge:-edge].astype(np.int32)
                  - wav[edge:-edge].astype(np.int32))
    assert diff.max() <= 1   # f32 sums over other window lengths: one LSB
