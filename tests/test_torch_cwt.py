"""The port's FastSpeech2 CWT branch on the CPU against the JAX package: the
CWT ops (inverse_batch_cwt against the reference oracle and JAX at several
batch sizes), CNNScalar and its adaptive pool, the CWT model (through the
weight bridge, through the .pth.tar converter on the reference oracle's
state, and the committed golden), the CWT loss, and two CWT train steps
(the committed golden of the JAX train step).

Weights are seeded in numpy and carried across with weights.flax_to_torch;
in the train-step comparisons every dropout is the identity on both sides
(tests/test_torch_train.py)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest as cf
from chip_smoke import (GOLDEN_CWT_TRAIN, TRAIN_N_SPEAKERS, TRAIN_STATS,
                        compare_cwt_outputs, port_model_no_dropout,
                        replay_cwt_fs2_golden, replay_train_step_golden,
                        seeded_flax_variables)
from tests.oracle_util import run_oracle
from tests.test_convs import golden  # noqa: F401  (fixture)
from tests.test_torch_train import TINY_MODEL, _jax_model
from tts_king_torch.weights import flax_to_torch, load_into

CWT_MODEL = dict(TINY_MODEL, use_cwt=True)


def cwt_inputs(seed=17):
    """B = 3 phoneme rows of lengths 10 / 7 / 4, zero-padded to L = 10."""
    rng = np.random.RandomState(seed)
    src_lens = np.array([10, 7, 4], np.int32)
    texts = rng.randint(1, 200, (3, 10)).astype(np.int32)
    texts[np.arange(10)[None] >= src_lens[:, None]] = 0
    return np.array([2, 0, 1], np.int32), texts, src_lens


def cwt_variables(model_cfg, seed=5):
    """Seeded flax-layout weights of the FastSpeech2 of ``model_cfg``
    (TRAIN_STATS, TRAIN_N_SPEAKERS) with a duration head of bias log(1 + 5)
    and a tenth of its random weight: about five frames a phoneme, so the
    mel has frames to compare."""
    from tts_king_torch import config as pcfg
    from tts_king_torch.models.fs2 import build_fastspeech2

    variables = seeded_flax_variables(lambda: build_fastspeech2(
        pcfg._build(pcfg.ModelConfig, model_cfg), TRAIN_STATS,
        TRAIN_N_SPEAKERS), seed)
    head = variables["params"]["variance_adaptor"]["duration_predictor"]
    head["linear_layer"]["kernel"] *= 0.1
    head["linear_layer"]["bias"][:] = np.log(6.0)
    return variables


def jax_forward(model_cfg, variables, speakers, texts, src_lens,
                max_mel_len, **kw):
    """The JAX FastSpeech2's eval forward, as numpy (None entries kept)."""
    out = _jax_model(model_cfg).apply(
        jax.tree.map(jnp.asarray, variables), speakers, texts, src_lens,
        max_mel_len=max_mel_len, train=False, **kw)
    return {k: None if v is None else np.asarray(v) for k, v in out.items()}


def port_forward(model, speakers, texts, src_lens, max_mel_len, **kw):
    with torch.no_grad():
        out = model.eval()(torch.as_tensor(speakers).long(),
                           torch.as_tensor(texts).long(),
                           torch.as_tensor(src_lens).int(),
                           max_mel_len=max_mel_len, **kw)
    return {k: None if v is None else v.float().numpy()
            for k, v in out.items()}


# ------------------------------------------------------------------ ops


@pytest.mark.skipif(not cf.oracle_available(),
                    reason="no reference and no oracle recordings")
def test_inverse_batch_cwt_matches_reference():
    """tests/test_signal.py::test_inverse_batch_cwt_parity's oracle
    recording, through the port."""
    from tts_king_torch.ops.cwt import inverse_batch_cwt

    coefs = np.random.RandomState(0).randn(3, 40, 11).astype(np.float32)
    want = run_oracle("reference_inverse_cwt", dict(coefs=coefs))["recon"]
    got = inverse_batch_cwt(torch.from_numpy(coefs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B", [1, 3, 5])
def test_inverse_batch_cwt_matches_jax(B):
    """Distinct rows, so a standardization over the wrong axis would show;
    at B = 1 the batch standardization leaves exactly 0 (a flat pitch)."""
    from tts_king_torch.ops.cwt import inverse_batch_cwt, inverse_cwt
    from tts_king_tpu.ops import cwt as jcwt

    rng = np.random.RandomState(B)
    coefs = (rng.randn(B, 40, 11) * (1 + np.arange(B))[:, None, None]
             ).astype(np.float32)
    got = inverse_batch_cwt(torch.from_numpy(coefs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcwt.inverse_batch_cwt(coefs)),
                               rtol=1e-5, atol=1e-5)
    if B == 1:
        assert not got.any()
    single = inverse_cwt(torch.from_numpy(coefs[0])).numpy()
    np.testing.assert_allclose(single, np.asarray(jcwt.inverse_cwt(coefs[0])),
                               rtol=1e-5, atol=1e-5)
    # bf16 in, the recomposition and its standardization in f32
    half = inverse_batch_cwt(torch.from_numpy(coefs).bfloat16())
    assert half.dtype == torch.bfloat16


def test_cnn_scalar_matches_jax():
    from tts_king_torch.models.layers import CNNScalar
    from tts_king_tpu.models.layers import CNNScalar as JaxCNNScalar
    from tts_king_torch.weights import seeded_state_dict, torch_to_flax

    rng = np.random.RandomState(0)
    for L in (10, 45):   # shorter and longer than the pool's 30
        x1 = rng.randn(3, L, 16).astype(np.float32)
        x2 = rng.randn(3, L, 11).astype(np.float32)
        with torch.device("meta"):
            shapes = CNNScalar(16, 11)
        variables = torch_to_flax(seeded_state_dict(shapes, seed=L))
        want = np.asarray(JaxCNNScalar().apply(
            jax.tree.map(jnp.asarray, variables), x1, x2))
        port = load_into(CNNScalar(16, 11), flax_to_torch(variables))
        with torch.no_grad():
            got = port(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
        assert got.shape == want.shape == (3, 1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cnn_flat_pool_matches_oracle(golden):  # noqa: F811
    """CNNFlat's pool (F.adaptive_avg_pool1d) against the torch oracle's
    recordings of tests/test_convs.py, lengths below and above the size."""
    import torch.nn.functional as F

    cases, want = golden["pool"]
    for key, (x, size) in cases.items():
        got = F.adaptive_avg_pool1d(torch.from_numpy(x), size).numpy()
        np.testing.assert_allclose(got, want[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)


# ---------------------------------------------------------------- model


def test_fs2_cwt_matches_jax():
    """B = 3 (lengths 10 / 7 / 4) through the weight bridge, eval mode, at
    controls 1 and at pitch control 1.3 (the embedding is bucketized from
    pitch * p_control)."""
    variables = cwt_variables(CWT_MODEL)
    speakers, texts, src_lens = cwt_inputs()
    model = port_model_no_dropout(CWT_MODEL, variables)
    for kw in ({}, {"p_control": 1.3}):
        want = jax_forward(CWT_MODEL, variables, speakers, texts, src_lens,
                           64, **kw)
        got = port_forward(model, speakers, texts, src_lens, 64, **kw)
        assert got["pitch_prediction"].shape == (3, 10, 11)
        assert got["pitch_mean"].shape == got["pitch_std"].shape == (3, 1)
        compare_cwt_outputs(got, want)


def test_fs2_cwt_batch_of_one_has_flat_pitch():
    """A batch of one: the batch-standardized recomposition is exactly 0,
    so the pitch embedding is that of pitch_mean at every phoneme, as in
    JAX; the port still matches the JAX model."""
    from tts_king_torch.ops.cwt import inverse_batch_cwt

    variables = cwt_variables(CWT_MODEL)
    speakers, texts, src_lens = cwt_inputs()
    model = port_model_no_dropout(CWT_MODEL, variables)
    got = port_forward(model, speakers[:1], texts[:1], src_lens[:1], 64)
    want = jax_forward(CWT_MODEL, variables, speakers[:1], texts[:1],
                       src_lens[:1], 64)
    compare_cwt_outputs(got, want)
    assert not inverse_batch_cwt(
        torch.from_numpy(got["pitch_prediction"])).any()


def test_fs2_cwt_golden():
    """tests/fixtures/torch_port/golden_cwt_fs2.npz (exported from the JAX
    model by scripts/export_cwt_features_golden.py) through the port."""
    errs = replay_cwt_fs2_golden(device="cpu")
    assert errs["pitch_prediction"] < 1e-4


@pytest.mark.skipif(not cf.oracle_available(),
                    reason="reference tree not mounted and no oracle "
                           "recordings")
def test_fs2_cwt_matches_reference_oracle():
    """The reference FastSpeech2 in CWT mode (the oracle recording of
    tests/test_parity_fs2_extra.py::test_cwt_mode_parity) through the
    port's .pth.tar converter (use_cwt=True) and model."""
    import dataclasses

    from tests.test_parity_fs2 import (DEC_LAYERS, ENC_LAYERS, FILTER, HIDDEN,
                                       N_SPEAKERS, POSTNET_DIM, STATS_DIR,
                                       _model_config)
    from tts_king_torch import config as pcfg
    from tts_king_torch.checkpoint import convert_fs2_state
    from tts_king_torch.models.fs2 import build_fastspeech2

    rng = np.random.RandomState(17)
    B, L = 3, 10
    texts = rng.randint(1, 206, size=(B, L)).astype(np.int64)
    src_lens = np.array([10, 7, 4], np.int64)
    for b, n in enumerate(src_lens):
        texts[b, n:] = 0
    speakers = rng.randint(0, N_SPEAKERS, size=(B,)).astype(np.int64)
    out = run_oracle("reference_fs2", dict(
        seed=23, postnet_dim=POSTNET_DIM, stats_dir=STATS_DIR,
        encoder_layer=ENC_LAYERS, decoder_layer=DEC_LAYERS, hidden=HIDDEN,
        filter=FILTER, max_seq_len=96, n_speakers=N_SPEAKERS, use_cwt=True,
        texts=texts, src_lens=src_lens, speakers=speakers,
        p_control=1.0, e_control=1.0, d_control=1.0))
    state = {k[len("state__"):]: torch.from_numpy(v) for k, v in out.items()
             if k.startswith("state__")}
    with open(os.path.join(STATS_DIR, "stats.json")) as f:
        stats = json.load(f)
    mc = pcfg._build(pcfg.ModelConfig, dataclasses.asdict(dataclasses.replace(
        _model_config(), use_cwt=True, max_seq_len=96)))
    model = build_fastspeech2(mc, stats, N_SPEAKERS)
    load_into(model, convert_fs2_state(state, ENC_LAYERS, DEC_LAYERS,
                                       use_cwt=True))
    got = port_forward(model, speakers, texts, src_lens, 96)
    compare_cwt_outputs(got, {k: out.get(k) for k in (
        "pitch_prediction", "log_duration_prediction", "mel_lens", "mel")})


def test_fs2_cwt_bf16_runs():
    """The CWT model cast to bf16: finite outputs in bf16 (the
    recomposition and its standardization run in f32 inside)."""
    variables = cwt_variables(CWT_MODEL)
    speakers, texts, src_lens = cwt_inputs()
    model = port_model_no_dropout(CWT_MODEL, variables).to(torch.bfloat16)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(speakers).long(),
                           torch.from_numpy(texts).long(),
                           torch.from_numpy(src_lens).int(), max_mel_len=64)
    assert out["pitch_mean"].dtype == torch.bfloat16
    for key in ("pitch_prediction", "pitch_mean", "pitch_std", "mel"):
        assert torch.isfinite(out[key].float()).all(), key


# ----------------------------------------------------------------- train


def test_cwt_loss_matches_jax():
    from tts_king_torch.train.loss import fastspeech2_loss
    from tts_king_tpu.train.loss import fastspeech2_loss as jax_loss

    rng = np.random.RandomState(1)
    B, L, T = 3, 10, 24
    batch = dict(mels=rng.randn(B, T + 3, 80).astype(np.float32),
                 energies=rng.randn(B, L).astype(np.float32),
                 durations=rng.randint(0, 5, (B, L)).astype(np.int32),
                 pitches_cwt=rng.randn(B, L, 11).astype(np.float32),
                 pitches_mean=rng.randn(B).astype(np.float32),
                 pitches_std=rng.rand(B).astype(np.float32))
    outputs = dict(
        mel=rng.randn(B, T, 80).astype(np.float32),
        postnet_mel=rng.randn(B, T, 80).astype(np.float32),
        pitch_prediction=rng.randn(B, L, 11).astype(np.float32),
        pitch_mean=rng.rand(B, 1).astype(np.float32),
        pitch_std=rng.rand(B, 1).astype(np.float32),
        energy_prediction=rng.randn(B, L).astype(np.float32),
        log_duration_prediction=rng.randn(B, L).astype(np.float32),
        src_masks=np.arange(L)[None] >= np.array([10, 7, 4])[:, None],
        mel_masks=np.arange(T)[None] >= np.array([24, 15, 8])[:, None])
    want = jax_loss({k: jnp.asarray(v) for k, v in batch.items()},
                    {k: jnp.asarray(v) for k, v in outputs.items()},
                    use_cwt=True)
    got = fastspeech2_loss({k: torch.from_numpy(v) for k, v in batch.items()},
                           {k: torch.from_numpy(v)
                            for k, v in outputs.items()}, use_cwt=True)
    for name in want._fields:
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert float(got.pitch_mean) > 0 and float(got.pitch_std) > 0


def test_cwt_train_step_golden_replay():
    """Two optimizer steps of a CWT model at acc = 2 against the JAX
    make_train_step(use_cwt=True), dropout off on both sides: the golden
    tests/fixtures/torch_port/golden_cwt_train_step.npz
    (scripts/export_cwt_features_golden.py) through the port, held to
    compare_train_step's two-step bounds (losses, the mean and std terms
    among them, params, Adam moments, running stats)."""
    losses, _ = replay_train_step_golden(device="cpu", path=GOLDEN_CWT_TRAIN)
    assert np.isfinite(losses["total"]) and losses["pitch_mean"] > 0
