"""The port's FastSpeech2 training on the CPU against the JAX package: the
Noam schedule, the loss, the train-mode forward (with the decoder's
truncation past max_seq_len), the optimizer step with grad accumulation
(losses, clipped grads, new params, Adam moments, BatchNorm running stats),
the committed train-step golden, the dataset's superbatches, and the loop's
resume and emergency checkpoint; plus the paths that are not ported yet.

Weights are seeded in numpy and carried across with weights.flax_to_torch;
every dropout is the identity on both sides (flax.linen.intercept_methods on
the JAX side, p = 0 on the port's side), since the two frameworks draw
different masks from any seed."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import (TRAIN_N_SPEAKERS, TRAIN_STATS, compare_train_step,
                        port_model_no_dropout, port_train_steps,
                        replay_train_step_golden)
from tts_king_torch import config as pcfg
from tts_king_torch.weights import (flax_to_torch, seeded_state_dict,
                                    torch_to_flax)

# tests/test_train._tiny_setup's model, as a plain dict that either
# package's config builds
TINY_MODEL = {
    "transformer": {"encoder_layer": 1, "encoder_head": 2,
                    "encoder_hidden": 16, "variance_hidden": 16,
                    "decoder_layer": 1, "decoder_head": 2,
                    "decoder_hidden": 16, "conv_filter_size": 32,
                    "conv_kernel_size": [9, 1]},
    "variance_predictor": {"filter_size": 16},
    "max_seq_len": 32, "postnet_dim": 32}
N_SPEAKERS, STATS = TRAIN_N_SPEAKERS, TRAIN_STATS
# warm-up 4 so the first steps move the weights by a visible lr (0.03);
# eps 1e-3 keeps Adam's update well conditioned in the gradients
# (chip_smoke.compare_train_step)
TINY_OPT = {"grad_acc_step": 2, "warm_up_step": 4, "eps": 1e-3}


def seeded_variables(model_cfg, seed=0, n_speakers=N_SPEAKERS, stats=STATS):
    """Seeded numpy weights in the flax layout, running stats included."""
    from tts_king_torch.models.fs2 import build_fastspeech2

    with torch.device("meta"):
        model = build_fastspeech2(pcfg._build(pcfg.ModelConfig, model_cfg),
                                  stats, n_speakers)
    return torch_to_flax(seeded_state_dict(model, seed))


def synthetic_superbatch(acc, B, L, T, seed, n_speakers=N_SPEAKERS):
    """(acc, B, ...) targets in the dataset's layout: ragged phoneme counts,
    durations of 1-4 frames, mel lengths capped at T as the dataset caps
    them (so one item's durations may run past T)."""
    rng = np.random.RandomState(seed)
    src_lens = rng.randint(L // 2, L + 1, (acc, B)).astype(np.int32)
    src_lens[:, 0] = L
    valid = np.arange(L)[None, None] < src_lens[..., None]
    d = (rng.randint(1, 5, (acc, B, L)) * valid).astype(np.int32)
    d[0, 0] = 5     # runs past T: the length regulator clamps it
    return dict(
        speakers=rng.randint(0, n_speakers, (acc, B)).astype(np.int32),
        texts=(rng.randint(1, 200, (acc, B, L)) * valid).astype(np.int32),
        src_lens=src_lens,
        mels=rng.randn(acc, B, T, 80).astype(np.float32),
        mel_lens=np.minimum(d.sum(-1), T).astype(np.int32),
        energies=(rng.randn(acc, B, L) * valid).astype(np.float32),
        durations=d,
        pitches_raw=(rng.randn(acc, B, L) * valid).astype(np.float32),
        pitches_cwt=rng.randn(acc, B, L, 11).astype(np.float32),
        pitches_mean=rng.randn(acc, B).astype(np.float32),
        pitches_std=rng.rand(acc, B).astype(np.float32))


def _no_dropout(next_fun, args, kwargs, context):
    import flax.linen as nn

    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _jax_model(model_cfg, n_speakers=N_SPEAKERS, stats=STATS):
    from tts_king_tpu import config as jcfg
    from tts_king_tpu.models.fs2 import build_fastspeech2

    return build_fastspeech2(jcfg._build(jcfg.ModelConfig, model_cfg), stats,
                             n_speakers)


def jax_train(model_cfg, opt_cfg, variables, superbatches):
    """The JAX package's make_train_step from ``variables`` (with the
    config's use_cwt), one step per superbatch, dropout intercepted. Returns numpy trees per step:
    losses, params, batch_stats and the Adam state (count, mu, nu)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from tts_king_tpu import config as jcfg
    from tts_king_tpu.train.state import TrainState, make_optimizer
    from tts_king_tpu.train.step import make_train_step

    mc = jcfg._build(jcfg.ModelConfig, model_cfg)
    model = _jax_model(model_cfg)
    opt = make_optimizer(jcfg._build(jcfg.OptimizerConfig, opt_cfg),
                         mc.transformer.encoder_hidden)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray,
                                                variables["batch_stats"]),
                       opt_state=opt.init(params))
    step = make_train_step(model, opt, use_cwt=mc.use_cwt)
    out = []
    for i, sb in enumerate(superbatches):
        with nn.intercept_methods(_no_dropout):
            state, losses = step(state, sb, jax.random.PRNGKey(i))
        adam = state.opt_state[1]
        out.append(jax.tree.map(np.asarray, {
            "losses": losses._asdict(), "params": state.params,
            "batch_stats": state.batch_stats, "count": adam.count,
            "mu": adam.mu, "nu": adam.nu}))
    return out


def test_noam_schedule_matches_jax():
    from tts_king_torch.train.schedule import noam_schedule
    from tts_king_tpu.train.schedule import noam_schedule as jax_noam

    args = (256, 4000, [300000, 400000, 500000], 0.7)
    got, want = noam_schedule(*args), jax_noam(*args)
    # counts 0 and 1, the warm-up end, and either side of each anneal
    for count in (0, 1, 3998, 3999, 4000, 299999, 300000, 399999, 400000,
                  499999, 500000, 600000):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, err_msg=f"count {count}")
    # the 0-based count is evaluated at step count + 1
    assert got(0) == pytest.approx(256 ** -0.5 * 4000 ** -1.5, rel=1e-6)


def test_loss_matches_jax():
    """Same numpy outputs into both losses; the mel targets are longer than
    the (truncated) mel mask, and mel/source masks are ragged."""
    import jax.numpy as jnp

    from tts_king_torch.train.loss import fastspeech2_loss
    from tts_king_tpu.train.loss import fastspeech2_loss as jax_loss

    rng = np.random.RandomState(0)
    B, L, T = 3, 10, 24
    batch = dict(mels=rng.randn(B, T + 3, 80).astype(np.float32),
                 energies=rng.randn(B, L).astype(np.float32),
                 durations=rng.randint(0, 5, (B, L)).astype(np.int32),
                 pitches_raw=rng.randn(B, L).astype(np.float32))
    outputs = dict(
        mel=rng.randn(B, T, 80).astype(np.float32),
        postnet_mel=rng.randn(B, T, 80).astype(np.float32),
        pitch_prediction=rng.randn(B, L).astype(np.float32),
        energy_prediction=rng.randn(B, L).astype(np.float32),
        log_duration_prediction=rng.randn(B, L).astype(np.float32),
        src_masks=np.arange(L)[None] >= np.array([10, 7, 4])[:, None],
        mel_masks=np.arange(T)[None] >= np.array([24, 15, 8])[:, None])
    want = jax_loss({k: jnp.asarray(v) for k, v in batch.items()},
                    {k: jnp.asarray(v) for k, v in outputs.items()})
    got = fastspeech2_loss({k: torch.from_numpy(v) for k, v in batch.items()},
                           {k: torch.from_numpy(v)
                            for k, v in outputs.items()})
    for name in want._fields:
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-5,
                                   err_msg=name)
    # without CWT the mean and std terms are 0 (tests/test_torch_cwt.py
    # holds the CWT loss)
    assert float(got.pitch_mean) == float(got.pitch_std) == 0.0


@pytest.mark.parametrize("T", [24, 40], ids=["T24", "T40_past_max_seq_len"])
def test_train_mode_forward_matches_jax(T):
    """Train mode, dropout off: teacher-forced outputs and the BatchNorm
    stats the forward leaves behind. At T = 40 > max_seq_len = 32 the
    decoder truncates to 32 frames."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from tts_king_torch.train.step import to_device

    variables = seeded_variables(TINY_MODEL, seed=1)
    sb = synthetic_superbatch(1, 4, 12, T, seed=2)
    b = {k: v[0] for k, v in sb.items()}
    jm = _jax_model(TINY_MODEL)
    with nn.intercept_methods(_no_dropout):
        ref, mutated = jm.apply(
            jax.tree.map(jnp.asarray, variables), b["speakers"], b["texts"],
            b["src_lens"], max_mel_len=T, mel_lens=b["mel_lens"],
            energy_targets=b["energies"], duration_targets=b["durations"],
            pitch_raw_targets=b["pitches_raw"], train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
    model = port_model_no_dropout(TINY_MODEL, variables).train()
    tb = to_device(b, "cpu")
    out = model(tb["speakers"], tb["texts"], tb["src_lens"], max_mel_len=T,
                mel_lens=tb["mel_lens"], energy_targets=tb["energies"],
                duration_targets=tb["durations"],
                pitch_raw_targets=tb["pitches_raw"])
    assert tuple(out["mel"].shape) == (4, min(T, 32), 80)
    np.testing.assert_array_equal(out["mel_masks"].numpy(),
                                  np.asarray(ref["mel_masks"]))
    for key in ("mel_lens", "duration_rounded"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    for key in ("log_duration_prediction", "pitch_prediction",
                "energy_prediction", "mel", "postnet_mel"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    stats = flax_to_torch({"batch_stats": mutated["batch_stats"]})
    sd = model.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_train_step_matches_jax():
    """Two optimizer steps at acc = 2 from the same weights, past
    max_seq_len (T = 40), against make_train_step: losses, clipped grads,
    params, Adam moments and BatchNorm running stats after each step (the
    running stats catch flax's biased-variance update)."""
    from tts_king_torch.train.schedule import noam_schedule

    variables = seeded_variables(TINY_MODEL, seed=3)
    sbs = [synthetic_superbatch(2, 4, 12, 40, seed=s) for s in (4, 5)]
    want = jax_train(TINY_MODEL, TINY_OPT, variables, sbs)
    got = port_train_steps(TINY_MODEL, TINY_OPT, variables, sbs)
    lr = noam_schedule(16, TINY_OPT["warm_up_step"], [300000], 0.7)
    compare_train_step(got[0], want[0], lr(0))
    # The second step starts from weights that already differ by up to
    # 1e-3 * lr (3e-5); summed over a conv's 400 inputs that moves the
    # postnet's batch means by ~1e-5, so its running stats are held at atol
    # 1e-4. The unbiased-variance trap would still show: it moves the
    # running variance by 0.1 * var / (B * T - 1), 8e-4 here.
    compare_train_step(got[1], want[1], lr(1), stats_atol=1e-4)


def test_golden_train_step_replay():
    """tests/fixtures/torch_port/golden_train_step.npz (exported by
    scripts/export_train_step_golden.py from the JAX step) through the
    port on the CPU."""
    losses, _ = replay_train_step_golden(device="cpu")
    assert np.isfinite(losses["total"])


def test_objective_metrics_match_jax():
    """MCD over the DTW path and duration MAE: the port's numpy copy gives
    the JAX package's values."""
    from tts_king_torch.train import metrics
    from tts_king_tpu.train import metrics as jax_metrics

    rng = np.random.RandomState(0)
    pred, gt = rng.randn(37, 80), rng.randn(45, 80)
    mcd, path = metrics.mcd_dtw(pred, gt)
    want, want_path = jax_metrics.mcd_dtw(pred, gt)
    assert mcd == want and path == want_path
    d_pred, d_gt = rng.randint(0, 9, 12), rng.randint(0, 9, 10)
    assert (metrics.duration_mae(d_pred, d_gt)
            == jax_metrics.duration_mae(d_pred, d_gt))


# ------------------------------------------------------------ data + loop


def _write_corpus(root, n_train=24, n_val=3):
    from tts_king_torch.data.synthetic import write_feature_corpus

    return write_feature_corpus(str(root), n_train, n_val, n_speakers=3,
                                phones=(6, 20), frames=(24, 70), seed=0)


def test_dataset_superbatches_match_jax(tmp_path):
    """FS2Dataset's superbatches (masking, sorting, quantized padding, the
    resume fast-forward) and eval batches equal the JAX package's
    FS2Dataset(use_native_loader=False) exactly."""
    from tts_king_torch.config import OptimizerConfig as POpt
    from tts_king_torch.config import PreprocessConfig as PPre
    from tts_king_torch.config import TrainConfig as PTrain
    from tts_king_torch.data.dataset import FS2Dataset
    from tts_king_tpu.config import OptimizerConfig as JOpt
    from tts_king_tpu.config import PreprocessConfig as JPre
    from tts_king_tpu.config import TrainConfig as JTrain
    from tts_king_tpu.data.dataset import FS2Dataset as JaxDataset

    root = _write_corpus(tmp_path)
    port = FS2Dataset("train.txt", PPre(preprocessed_path=root),
                      PTrain(optimizer=POpt(batch_size=3, grad_acc_step=2)),
                      max_mel_len=64)
    ref = JaxDataset("train.txt", JPre(preprocessed_path=root),
                     JTrain(optimizer=JOpt(batch_size=3, grad_acc_step=2)),
                     max_mel_len=64, use_native_loader=False)
    assert port.superbatches_per_epoch() == ref.superbatches_per_epoch() == 4
    for seed, start in ((1235, 0), (1236, 2)):
        a = list(port.epoch_superbatches(seed=seed, start_batch=start))
        b = list(ref.epoch_superbatches(seed=seed, start_batch=start))
        assert len(a) == len(b) == 4 - start
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    # masking ran: some phoneme became the mask symbol
    from tts_king_torch.text import text_to_sequence

    mask_id = text_to_sequence("{mask}")[0]
    assert any((sb["texts"] == mask_id).any() for sb in a)
    val_p = FS2Dataset("val.txt", PPre(preprocessed_path=root), PTrain(),
                       drop_last=False, apply_masking=False)
    val_j = JaxDataset("val.txt", JPre(preprocessed_path=root), JTrain(),
                       drop_last=False, apply_masking=False,
                       use_native_loader=False)
    for x, y in zip(val_p.batches(), val_j.batches()):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _loop_config(root, ckpt, **step):
    from tts_king_torch.config import (OptimizerConfig, PreprocessConfig,
                                       StepConfig, TrainConfig, TTSConfig)

    return TTSConfig(
        preprocess=PreprocessConfig(preprocessed_path=root),
        model=pcfg._build(pcfg.ModelConfig, TINY_MODEL),
        train=TrainConfig(
            ckpt_path=str(ckpt), result_path=str(ckpt) + "_result",
            optimizer=OptimizerConfig(batch_size=3, grad_acc_step=2,
                                      warm_up_step=4),
            step=StepConfig(**{"total_step": 100, "log_step": 1,
                               "val_step": 2, "save_step": 2, **step}),
            objective_val_utts=2))


def test_train_resume_equals_uninterrupted_run(tmp_path):
    """train() for 5 steps (across an epoch boundary, dropout on) equals
    train() for 3 steps, then a resume from the step-2 checkpoint to 5: the
    same params, BatchNorm stats and Adam state, bit for bit. Metrics and
    checkpoints are written at their intervals."""
    from tts_king_torch.train.checkpoint import restore_train_state
    from tts_king_torch.train.loop import train

    root = _write_corpus(tmp_path / "corpus")
    full = train(_loop_config(root, tmp_path / "a"), max_steps=5,
                 device="cpu")
    assert full.step == 5
    cfg = _loop_config(root, tmp_path / "b")
    train(cfg, max_steps=3, device="cpu")
    assert sorted(os.listdir(cfg.train.ckpt_path)) == [
        "step_00000002", "step_00000003"]
    cfg.acoustic.restore_step = 2
    resumed = train(cfg, max_steps=5, device="cpu")
    assert resumed.step == 5
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert full.opt_state.count == resumed.opt_state.count == 5
    for k in full.opt_state.mu:
        assert torch.equal(full.opt_state.mu[k], resumed.opt_state.mu[k]), k
        assert torch.equal(full.opt_state.nu[k], resumed.opt_state.nu[k]), k
    payload = restore_train_state(cfg.train.ckpt_path)     # the latest
    assert payload["step"] == 5 and "speaker_emb.weight" in payload["model"]
    with open(os.path.join(cfg.train.result_path,
                           "multi.metrics.jsonl")) as f:
        phases = {json.loads(line)["phase"] for line in f}
    assert {"train", "val", "objective"} <= phases


def test_emergency_checkpoint_on_failure(tmp_path, monkeypatch):
    """An exception during the run saves the last completed step, logs it,
    and is re-raised."""
    from tts_king_torch.train import loop

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(loop, "evaluate", boom)
    root = _write_corpus(tmp_path / "corpus")
    cfg = _loop_config(root, tmp_path / "ckpt", save_step=100)
    with pytest.raises(RuntimeError, match="injected"):
        loop.train(cfg, max_steps=5, device="cpu")
    assert os.listdir(cfg.train.ckpt_path) == ["step_00000002"]
    with open(os.path.join(cfg.train.result_path,
                           "multi.metrics.jsonl")) as f:
        assert '"emergency_checkpoint": 1.0' in f.read()


def test_cli_trains_from_a_yaml_config(tmp_path):
    import yaml

    from tts_king_torch.train.__main__ import main

    root = _write_corpus(tmp_path / "corpus")
    cfg = _loop_config(root, tmp_path / "ckpt")
    path = tmp_path / "cfg.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(dataclasses.asdict(cfg))), f)
    assert main([str(path), "--steps", "1", "--device", "cpu"]) == 0
    assert os.listdir(cfg.train.ckpt_path) == ["step_00000001"]


def test_unported_training_paths_raise(tmp_path):
    from tts_king_torch.config import MeshConfig
    from tts_king_torch.train.__main__ import main
    from tts_king_torch.train.checkpoint import restore_train_state
    from tts_king_torch.train.loop import train

    root = _write_corpus(tmp_path / "corpus", n_train=6)
    cfg = _loop_config(root, tmp_path / "ckpt")
    with pytest.raises(NotImplementedError, match="parallel"):
        train(dataclasses.replace(cfg, mesh=MeshConfig(dp=2)), device="cpu")
    bf16 = dataclasses.replace(cfg.model, attention_probs_bf16=True)
    with pytest.raises(NotImplementedError, match="bf16"):
        train(dataclasses.replace(cfg, model=bf16), device="cpu")
    with pytest.raises(NotImplementedError, match="parallelism"):
        main(["--distributed"])
    # an orbax directory (no train_state.pt) names the export script
    os.makedirs(tmp_path / "orbax" / "step_00000007")
    with pytest.raises(NotImplementedError, match="export_flax_variables"):
        restore_train_state(str(tmp_path / "orbax"), 7)
    with pytest.raises(RuntimeError, match="no batches"):
        train(dataclasses.replace(
            cfg, train=dataclasses.replace(
                cfg.train, optimizer=pcfg.OptimizerConfig(batch_size=8))),
            device="cpu")
