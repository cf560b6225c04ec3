"""The port's HiFi-GAN training modules on the CPU against the JAX package:
the weight-norm convs, the weight-norm Generator on the plain route and its
fold into the fused inference Generator, the discriminators (MPD, the
spectral-normed MSD) and the GAN losses, live against JAX and against
golden_gan_step.npz (scripts/export_gan_step_golden.py), the full-width
discriminators through the upstream converter against the reference
oracle's recordings, and the weight bridge for v / g / weight_orig / the
spectral buffers.

Layouts: the port's feature maps are NCHW (MPD) and NCT (MSD), the JAX
package's NHWC and NTC; they are transposed before comparing."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import gan_golden, gan_golden_batch, gan_state_dicts
from tts_king_torch.weights import flax_to_torch, load_into, torch_to_flax


@pytest.fixture(scope="module")
def golden():
    return gan_golden()


def _port_vocoder_config(meta):
    from tts_king_torch.config import VocoderModelConfig

    return VocoderModelConfig(**meta["vocoder"])


def _jax_layout(f):
    """A port feature map as the JAX package lays it out."""
    f = np.asarray(f.detach().float().numpy())
    return f.transpose(0, 2, 3, 1) if f.ndim == 4 else f.transpose(0, 2, 1)


def _assert_close(got, want, rtol=1e-5, **kw):
    """rtol, with an atol of rtol times the peak of ``want``: scores sum
    terms of both signs (and, through an unsettled spectral norm, of
    magnitude 1e5), so a value near 0 carries the rounding of the large
    terms."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()), **kw)


def _absmeans(fmaps):
    return np.asarray([[float(f.detach().float().abs().mean()) for f in fm]
                       for fm in fmaps])


@pytest.mark.parametrize("transposed", [False, True],
                         ids=["conv", "conv_transpose"])
def test_weight_norm_convs_match_jax(transposed):
    """TorchConv1d / TorchConvTranspose1d(weight_norm=True) against WNConv
    / WNConvTranspose1d with the same (v, g, bias) through the bridge (g
    per output channel of a conv, per input channel of a transposed conv),
    rtol 1e-5."""
    from tts_king_torch.models.hifigan import WNConv, WNConvTranspose1d
    from tts_king_tpu.models.hifigan import (TorchConv1d,
                                             TorchConvTranspose1d)

    rng = np.random.RandomState(3)
    x = rng.randn(2, 11, 6).astype(np.float32)
    if transposed:
        jmod = TorchConvTranspose1d(4, 8, stride=4, padding=2,
                                    weight_norm=True)
        port = WNConvTranspose1d(6, 4, 8, stride=4, padding=2)
        name = "ups_0"
    else:
        jmod = TorchConv1d(4, 5, padding=6, dilation=3, weight_norm=True)
        port = WNConv(6, 4, (5,), padding=6, dilation=3)
        name = "conv"
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))["params"]
    params = {k: (rng.randn(*s.shape) * (0.3 if k == "v" else 1.0) + (
        1.0 if k == "g" else 0.0)).astype(np.float32)
        for k, s in shapes.items()}
    assert params["g"].shape == ((6,) if transposed else (4,))
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    sd = flax_to_torch({"params": {name: params}})
    load_into(port, {k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_weight_norm_generator_and_export(golden):
    """The weight-norm Generator on the plain route at the golden's initial
    params reproduces the JAX waveform (rtol 1e-5); its fold
    (export_inference_params) in Generator(mrf_backend="fused") -- the
    MRF stage's plain version on the CPU -- and in the plain inference
    Generator equals the weight-norm forward at rtol 1e-5, atol 1e-6 (as
    tests/test_vocoder_training.py::test_weight_norm_export_matches_
    inference holds JAX's)."""
    from tts_king_torch.models.hifigan import Generator
    from tts_king_torch.train.vocoder import export_inference_params

    meta, z, trees = golden
    cfg = _port_vocoder_config(meta)
    gen = Generator(cfg, mrf_backend="plain", weight_norm=True)
    load_into(gen, gan_state_dicts(trees)[0])
    with torch.no_grad():
        y = gen(gan_golden_batch(z)["mel"]).numpy()
    np.testing.assert_allclose(y, z["fwd::y_hat"], rtol=1e-5, atol=1e-6)

    mel = torch.from_numpy(np.random.RandomState(1).randn(
        1, 8, cfg.num_mels).astype(np.float32))
    folded = export_inference_params(gen)
    with torch.no_grad():
        wn = gen(mel).numpy()
        for backend in ("fused", "plain"):
            inf = load_into(Generator(cfg, mrf_backend=backend), folded)
            np.testing.assert_allclose(inf(mel).numpy(), wn, rtol=1e-5,
                                       atol=1e-6, err_msg=backend)


def test_generator_backend_errors():
    from tts_king_torch.config import VocoderModelConfig
    from tts_king_torch.models.hifigan import Generator

    cfg = VocoderModelConfig(upsample_rates=[4, 4],
                             upsample_kernel_sizes=[8, 8],
                             upsample_initial_channel=8)
    with pytest.raises(ValueError, match="'plain'"):
        Generator(cfg, mrf_backend="xla")
    with pytest.raises(ValueError, match="trains on mrf_backend='plain'"):
        Generator(cfg, mrf_backend="fused", weight_norm=True)
    with pytest.raises(ValueError, match="compute_dtype"):
        Generator(cfg, mrf_backend="plain", compute_dtype=torch.bfloat16)
    gen = Generator(cfg, mrf_backend="plain")
    assert not any(n.startswith("mrf_") for n, _ in gen.named_buffers())


def _port_discriminators(meta, trees, spectral="spectral"):
    from tts_king_torch.train.vocoder import VocoderTrainer

    trainer = VocoderTrainer(_port_vocoder_config(meta),
                             disc_p_channels=meta["disc_p_channels"],
                             msd_width=meta["msd_width"], device="cpu")
    _, disc = trainer.build()
    disc = disc.to_empty(device="cpu")
    disc.load_state_dict(gan_state_dicts(trees, spectral=spectral)[1])
    return disc


def test_discriminators_match_golden(golden):
    """MPD and MSD (two calls) on (wav, y_hat) at the golden's initial
    variables: scores rtol 1e-5 (atol 1e-5 of their peak: without the power
    iteration the MSD's first scale divides by the initial random vectors'
    sigma, and its scores reach 4e5), feature-map absmeans rtol 1e-5, the MSD
    without and with the power iteration, whose buffers after d(y) and
    d(y_hat) match the JAX ones at rtol 1e-4."""
    meta, z, trees = golden
    disc = _port_discriminators(meta, trees)
    wav = torch.from_numpy(z["in::wav"])
    y_hat = torch.from_numpy(z["fwd::y_hat"])
    with torch.no_grad():
        runs = [("mpd", disc.mpd(wav, y_hat, pair_batched=False)),
                ("eval_msd", disc.msd(wav, y_hat, pair_batched=False)),
                ("train_msd", disc.msd(wav, y_hat, update_sn=True,
                                       pair_batched=False))]
    for tag, (rs, gs, fr, fg) in runs:
        for i, (r, g) in enumerate(zip(rs, gs)):
            _assert_close(r.numpy(), z[f"fwd::{tag}_r_{i}"])
            _assert_close(g.numpy(), z[f"fwd::{tag}_g_{i}"])
        np.testing.assert_allclose(_absmeans(fr), z[f"fwd::{tag}_fr_absmean"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(_absmeans(fg), z[f"fwd::{tag}_fg_absmean"],
                                   rtol=1e-5, atol=1e-7)
    want = flax_to_torch({"spectral": trees["fwd_spectral"]})
    for k, w in want.items():
        np.testing.assert_allclose(disc.state_dict()[k].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def _jax_disc_apply(module, variables, *args, **kw):
    return module.apply(variables, *map(jnp.asarray, args), **kw)


@pytest.mark.parametrize("pair_batched", [False, True],
                         ids=["two_calls", "pair_batched"])
def test_discriminators_match_jax(golden, pair_batched):
    """The JAX MPD and MSD, live, on a ragged T (MPD reflect pads to each
    period) against the port's, the golden's variables: scores and every
    feature map (transposed to JAX's layout) rtol 1e-5 with an atol of 1e-5
    of the peak, and the spectral
    buffers after the train-mode call (one power iteration when
    pair-batched, two otherwise) rtol 1e-4."""
    from tts_king_tpu.models.hifigan import (MultiPeriodDiscriminator,
                                             MultiScaleDiscriminator)

    meta, z, trees = golden
    disc = _port_discriminators(meta, trees)
    rng = np.random.RandomState(5)
    y = (0.3 * rng.randn(2, 517)).astype(np.float32)
    y_hat = (0.3 * rng.randn(2, 517)).astype(np.float32)
    mpd = MultiPeriodDiscriminator(channels=tuple(meta["disc_p_channels"]),
                                   pair_batched=pair_batched)
    msd = MultiScaleDiscriminator(width=meta["msd_width"],
                                  pair_batched=pair_batched)
    ref_p = _jax_disc_apply(mpd, {"params": trees["params"]["mpd"]}, y, y_hat)
    ref_s, upd = _jax_disc_apply(
        msd, {"params": trees["params"]["msd"],
              "spectral": trees["spectral"]["msd"]}, y, y_hat,
        update_sn=True, mutable=["spectral"])
    with torch.no_grad():
        yt, ht = torch.from_numpy(y), torch.from_numpy(y_hat)
        got_p = disc.mpd(yt, ht, pair_batched=pair_batched)
        got_s = disc.msd(yt, ht, update_sn=True, pair_batched=pair_batched)
    for got, ref in ((got_p, ref_p), (got_s, ref_s)):
        for part in (0, 1):
            for a, b in zip(got[part], ref[part]):
                _assert_close(a.numpy(), b)
        for part in (2, 3):
            for fa, fb in zip(got[part], ref[part]):
                for a, b in zip(fa, fb):
                    _assert_close(_jax_layout(a), b)
    want = flax_to_torch({"spectral": {"msd": upd["spectral"]}})
    for k, w in want.items():
        np.testing.assert_allclose(disc.state_dict()[k].numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_losses_and_pool_match_jax():
    """feature_loss, discriminator_loss, generator_loss and the MSD's
    average pool against JAX's (rtol 1e-6); feature_loss of bf16 maps sums
    in f32."""
    from tts_king_torch.models import hifigan as port
    from tts_king_tpu.models import hifigan as ref

    rng = np.random.RandomState(2)
    x = rng.randn(3, 37).astype(np.float32)
    np.testing.assert_allclose(
        port.avg_pool1d(torch.from_numpy(x)).numpy(),
        np.asarray(ref._avg_pool1d(jnp.asarray(x), 4, 2, 2)), rtol=1e-6,
        atol=1e-7)
    fr = [[rng.randn(2, 4, 7).astype(np.float32) for _ in range(3)]
          for _ in range(2)]
    fg = [[rng.randn(2, 4, 7).astype(np.float32) for _ in range(3)]
          for _ in range(2)]
    outs_r = [rng.randn(2, 9).astype(np.float32) for _ in range(4)]
    outs_g = [rng.randn(2, 9).astype(np.float32) for _ in range(4)]
    t = lambda tree: [torch.from_numpy(a) if isinstance(a, np.ndarray)
                      else t(a) for a in tree]
    j = lambda tree: [jnp.asarray(a) if isinstance(a, np.ndarray)
                      else j(a) for a in tree]
    np.testing.assert_allclose(float(port.feature_loss(t(fr), t(fg))),
                               float(ref.feature_loss(j(fr), j(fg))),
                               rtol=1e-6)
    got, got_r, got_g = port.discriminator_loss(t(outs_r), t(outs_g))
    want, want_r, want_g = ref.discriminator_loss(j(outs_r), j(outs_g))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose([float(a) for a in got_r + got_g],
                               [float(a) for a in want_r + want_g],
                               rtol=1e-6)
    got, got_terms = port.generator_loss(t(outs_g))
    want, want_terms = ref.generator_loss(j(outs_g))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose([float(a) for a in got_terms],
                               [float(a) for a in want_terms], rtol=1e-6)
    bf = [[torch.from_numpy(a).bfloat16() for a in fm] for fm in fr]
    assert port.feature_loss(bf, bf).dtype == torch.float32


# tests/test_parity_discriminators.py's inputs
DET_SEED, ORACLE_T = 11, 2048


def _oracle_wavs():
    rng = np.random.RandomState(123)
    t = np.arange(ORACLE_T) / 22050.0
    y = (0.5 * np.sin(2 * np.pi * 220 * t) +
         0.1 * rng.randn(ORACLE_T)).astype(np.float32)[None]
    y_hat = (0.5 * np.sin(2 * np.pi * 233 * t) +
             0.1 * rng.randn(ORACLE_T)).astype(np.float32)[None]
    return y, y_hat


@pytest.mark.parametrize("train_mode", [0, 1], ids=["eval", "train"])
def test_full_width_discriminators_match_upstream_oracle(train_mode):
    """The port's MPD and MSD at the published widths, with upstream
    ``do_*`` state dicts regenerated by tests/det_weights.py and converted
    by the port's convert_hifigan_discriminators, against the upstream
    discriminators' recorded outputs (tests/fixtures/oracle_cache), at
    tests/test_parity_discriminators.py's tolerances: scores rtol/atol
    1e-4, feature-map absmeans rtol 1e-4 atol 1e-6, u / v after the
    forward rtol 1e-4 atol 1e-5. Train mode power-iterates once per call,
    d(y) then d(y_hat); eval mode settles the buffers so first and then
    runs on them unchanged."""
    from tests.det_weights import det_state_dict
    from tests.oracle_util import run_oracle
    from tts_king_torch.checkpoint import convert_hifigan_discriminators
    from tts_king_torch.models.hifigan import (MultiPeriodDiscriminator,
                                               MultiScaleDiscriminator)

    y, y_hat = _oracle_wavs()
    out = run_oracle("reference_discriminators", dict(
        seed=5, det_weights=DET_SEED, y=y, y_hat=y_hat,
        train_mode=train_mode))

    def upstream(prefix):
        return det_state_dict(
            [(k[len(prefix):], tuple(int(x) for x in out[k]))
             for k in out if k.startswith(prefix)], seed=DET_SEED)

    mpd_sd, msd_sd = convert_hifigan_discriminators(
        {"mpd": upstream("mpd_shape__"), "msd": upstream("msd_shape__")})
    mpd = load_into(MultiPeriodDiscriminator(), mpd_sd)
    msd = load_into(MultiScaleDiscriminator(), msd_sd)
    yt, ht = torch.from_numpy(y), torch.from_numpy(y_hat)
    with torch.no_grad():
        p_rs, p_gs, p_fr, p_fg = mpd(yt, ht)
        s = msd(yt, ht, update_sn=True)
        if not train_mode:
            s = msd(yt, ht)
    s_rs, s_gs, s_fr, s_fg = s
    for i in range(5):
        np.testing.assert_allclose(p_rs[i].numpy(), out[f"mpd_r_{i}"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(p_gs[i].numpy(), out[f"mpd_g_{i}"],
                                   rtol=1e-4, atol=1e-4)
    for i in range(3):
        np.testing.assert_allclose(s_rs[i].numpy(), out[f"msd_r_{i}"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(s_gs[i].numpy(), out[f"msd_g_{i}"],
                                   rtol=1e-4, atol=1e-4)
    for tag, fmaps in (("mpd_fr", p_fr), ("mpd_fg", p_fg), ("msd_fr", s_fr),
                       ("msd_fg", s_fg)):
        np.testing.assert_allclose(_absmeans(fmaps), out[tag + "_absmean"],
                                   rtol=1e-4, atol=1e-6, err_msg=tag)
    for j in list(range(7)) + ["post"]:
        up = (f"discriminators.0.convs.{j}" if j != "post"
              else "discriminators.0.conv_post")
        conv = msd.disc_s0.conv_post if j == "post" else getattr(
            msd.disc_s0, f"convs_{j}")
        np.testing.assert_allclose(conv.u.numpy(), out[f"post__{up}.weight_u"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(conv.v.numpy(), out[f"post__{up}.weight_v"],
                                   rtol=1e-4, atol=1e-5)


def test_discriminator_converter_matches_jax():
    """convert_hifigan_discriminators against the JAX converter on narrow
    upstream state dicts (MPD channels 4..8, MSD width 32): the port's state
    dicts carried to flax trees by torch_to_flax equal the JAX package's
    params and spectral buffers exactly."""
    from tts_king_torch.checkpoint import convert_hifigan_discriminators
    from tts_king_torch.models.hifigan import (MultiPeriodDiscriminator,
                                               MultiScaleDiscriminator)
    from tts_king_tpu.checkpoint import \
        convert_hifigan_discriminators as jax_convert

    rng = np.random.RandomState(4)
    mpd = MultiPeriodDiscriminator(channels=(4, 8, 8, 8, 8))
    msd = MultiScaleDiscriminator(width=32)

    def upstream(module, prefix_of):
        sd = {}
        for k, v in module.state_dict().items():
            mod, name = k.rsplit(".", 1)
            disc, conv = mod.split(".", 1)
            i = prefix_of(disc)
            up = f"discriminators.{i}.{conv.replace('convs_', 'convs.')}"
            a = rng.randn(*v.shape).astype(np.float32)
            names = {"v": "weight_v", "g": "weight_g", "u": "weight_u",
                     "weight_orig": "weight_orig", "bias": "bias"}
            if name == "v" and v.dim() == 1:      # an SNConv's buffer
                names["v"] = "weight_v"
            if name == "g":
                a = a.reshape(-1, *[1] * (module.state_dict()[
                    f"{mod}.v"].dim() - 1))
            sd[f"{up}.{names[name]}"] = torch.from_numpy(a)
        return sd

    periods = (2, 3, 5, 7, 11)
    ckpt = {"mpd": upstream(mpd, lambda d: periods.index(int(d[6:]))),
            "msd": upstream(msd, lambda d: int(d[6:]))}
    mpd_sd, msd_sd = convert_hifigan_discriminators(ckpt)
    j_mpd, j_msd, j_spectral = jax_convert(
        {k: {n: t.numpy() for n, t in v.items()} for k, v in ckpt.items()})
    got = torch_to_flax({**{f"mpd.{k}": v for k, v in mpd_sd.items()},
                         **{f"msd.{k}": v for k, v in msd_sd.items()}})
    want = {"params": {"mpd": j_mpd, "msd": j_msd},
            "spectral": {"msd": j_spectral}}
    flat = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    a, b = flat(got), flat(jax.tree.map(np.asarray, want))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def test_gan_weight_bridge_round_trip(golden):
    """flax_to_torch / torch_to_flax round-trip the golden's variables
    (weight-norm v and g of 1-D, transposed and (k, 1) 2-D convs,
    weight_orig, the spectral collection) exactly, and the port's state
    dicts load them."""
    meta, z, trees = golden
    variables = {"params": trees["params"], "spectral": trees["spectral"]}
    back = torch_to_flax(flax_to_torch(variables))
    flat = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    a, b = flat(variables), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    v = trees["params"]["mpd"]["disc_p2"]["convs_0"]["v"]
    assert flax_to_torch({"params": {"c": {"v": v}}})["c.v"].shape == (
        v.shape[3], v.shape[2], v.shape[0], v.shape[1])
    # the bridge's keys are the trainer's modules' own
    disc = _port_discriminators(meta, trees)
    assert set(disc.state_dict()) == set(gan_state_dicts(trees)[1])


def test_optax_adamw_state_bridge():
    """optax_adam_to_torch reads the moments out of optax.adamw's chain
    state (its ScaleByAdamState), keyed by state-dict name."""
    import optax

    from tts_king_torch.weights import optax_adam_to_torch

    params = {"ups_0": {"v": jnp.ones((4, 3, 2)), "g": jnp.ones((3,)),
                        "bias": jnp.zeros((2,))}}
    tx = optax.adamw(1e-3, b1=0.8, b2=0.99, weight_decay=0.01)
    st = tx.init(params)
    grads = jax.tree.map(lambda p: 0.5 * jnp.ones_like(p), params)
    _, st = tx.update(grads, st, params)
    adam = optax_adam_to_torch(st)
    assert adam.count == 1
    assert set(adam.mu) == {"ups_0.v", "ups_0.g", "ups_0.bias"}
    assert tuple(adam.mu["ups_0.v"].shape) == (3, 2, 4)
    np.testing.assert_allclose(adam.mu["ups_0.g"].numpy(), 0.1, rtol=1e-6)
    with pytest.raises(ValueError, match="no Adam state"):
        optax_adam_to_torch((optax.EmptyState(),))
