#!/usr/bin/env python
"""Export one HiFi-GAN GAN training step of the JAX package as a golden
fixture that the PyTorch port replays without JAX.

Writes tests/fixtures/torch_port/golden_gan_step.npz. The JAX
VocoderTrainer runs at the tiny configuration of
tests/test_vocoder_training._tiny_cfg (hop 16, 8 channels, two ×4
upsamplers, one ResBlock1 of dilations (1, 3)), with MPD channels (4, 8, 8,
8, 8) and MSD width 32, on the seeded two-sine batch of
test_gan_step_runs_and_learns (B = 2, 512 samples, the mel at fmax 8 kHz);
both optimizers are rebuilt with eps = 1e-3 (see chip_smoke.compare_gan_step).
It records:

  * the initial variables: ``var::params::{gen,mpd,msd}/...`` and the MSD's
    power-iteration buffers ``var::spectral::msd/...``; the batch
    (``in::mel``, ``in::wav``, ``in::mel_loss``);
  * at those variables: the weight-norm Generator's waveform
    (``fwd::y_hat``); the MPD (``fwd::mpd_...``) and the MSD on (wav,
    y_hat) in two calls, the MSD both without the power iteration
    (``fwd::eval_msd_...``) and with it (``fwd::train_msd_...``, the
    updated buffers under ``var::fwd_spectral::msd/...``): each
    discriminator's scores in full (``..._r_<i>``, ``..._g_<i>``) and its
    feature maps as absmeans (``..._fr_absmean`` / ``..._fg_absmean``, one
    row per discriminator);
  * one train step: the losses (``out::loss::<name>``), the updated params
    and buffers (``var::out_params::...``, ``var::out_spectral::...``), the
    Adam moments of both optimizers (``var::out_{gen,disc}_{mu,nu}::...``)
    and their counts (``out::{gen,disc}_count``);
  * the eval step's mel L1 after the step (``out::eval_mel_l1``);
  * ``meta::config``: the vocoder config, the discriminators' widths, eps,
    steps_per_epoch, as JSON.

Runs with JAX on the CPU (about a minute):

  JAX_PLATFORMS=cpu python scripts/export_gan_step_golden.py
"""

import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repo root in place of scripts/, whose profile.py would shadow the
# standard library's profile module that torch imports
sys.path[0] = REPO

import numpy as np

OUT = os.path.join(REPO, "tests", "fixtures", "torch_port",
                   "golden_gan_step.npz")
DISC_P_CHANNELS = (4, 8, 8, 8, 8)
MSD_WIDTH = 32
EPS = 1e-3
STEPS_PER_EPOCH = 1000


def sine_batch(cfg):
    """test_gan_step_runs_and_learns's batch: 220 and 330 Hz at 0.5."""
    from tts_king_tpu.ops.stft import hifigan_mel

    frames = cfg.segment_size // cfg.hop_size
    t = np.arange(cfg.segment_size) / cfg.sampling_rate
    wav = np.stack([0.5 * np.sin(2 * np.pi * 220 * t),
                    0.5 * np.sin(2 * np.pi * 330 * t)]).astype(np.float32)
    mel = np.asarray(hifigan_mel(wav, cfg.n_fft, cfg.num_mels,
                                 cfg.sampling_rate, cfg.hop_size,
                                 cfg.win_size, 0.0, 8000.0))[:, :frames]
    return {"mel": mel, "wav": wav, "mel_loss": mel}


def absmeans(fmaps):
    return np.asarray([[float(np.mean(np.abs(np.asarray(f, np.float32))))
                        for f in fm] for fm in fmaps])


def disc_outputs(tag, outs):
    rs, gs, fr, fg = outs
    flat = {f"fwd::{tag}_r_{i}": np.asarray(r) for i, r in enumerate(rs)}
    flat.update({f"fwd::{tag}_g_{i}": np.asarray(g) for i, g in enumerate(gs)})
    flat[f"fwd::{tag}_fr_absmean"] = absmeans(fr)
    flat[f"fwd::{tag}_fg_absmean"] = absmeans(fg)
    return flat


def main():
    import jax
    import optax

    from scripts.export_flax_variables import flatten_variables
    from tests.test_vocoder_training import _tiny_cfg
    from tts_king_tpu.train.vocoder import VocoderTrainer

    cfg = _tiny_cfg()
    tr = VocoderTrainer(cfg, disc_p_channels=DISC_P_CHANNELS,
                        msd_width=MSD_WIDTH, steps_per_epoch=STEPS_PER_EPOCH)
    lr = optax.exponential_decay(cfg.learning_rate,
                                 transition_steps=STEPS_PER_EPOCH,
                                 decay_rate=cfg.lr_decay, staircase=True)
    tr.gen_tx = optax.adamw(lr, b1=cfg.adam_b1, b2=cfg.adam_b2, eps=EPS,
                            weight_decay=0.01)
    tr.disc_tx = optax.adamw(lr, b1=cfg.adam_b1, b2=cfg.adam_b2, eps=EPS,
                             weight_decay=0.01)
    state = tr.init_state(jax.random.PRNGKey(0),
                          cfg.segment_size // cfg.hop_size)
    batch = sine_batch(cfg)

    flat = flatten_variables({
        "params": {"gen": state.gen_params, "mpd": state.mpd_params,
                   "msd": state.msd_params},
        "spectral": {"msd": state.msd_spectral}})
    flat.update({f"in::{k}": v for k, v in batch.items()})

    # the forwards at the initial variables, discriminators in two calls
    y_hat = tr.gen.apply({"params": state.gen_params}, batch["mel"])
    flat["fwd::y_hat"] = np.asarray(y_hat)
    mpd = dataclasses.replace(tr.mpd, pair_batched=False)
    msd = dataclasses.replace(tr.msd, pair_batched=False)
    flat.update(disc_outputs("mpd", mpd.apply(
        {"params": state.mpd_params}, batch["wav"], y_hat)))
    variables = {"params": state.msd_params, "spectral": state.msd_spectral}
    flat.update(disc_outputs("eval_msd", msd.apply(
        variables, batch["wav"], y_hat)))
    outs, upd = msd.apply(variables, batch["wav"], y_hat, update_sn=True,
                          mutable=["spectral"])
    flat.update(disc_outputs("train_msd", outs))
    flat.update(flatten_variables({"fwd_spectral": {"msd": upd["spectral"]}}))

    new, losses = jax.jit(tr.make_train_step())(state, batch)
    flat.update({f"out::loss::{k}": np.asarray(v)
                 for k, v in losses._asdict().items()})
    gen_adam, disc_adam = new.gen_opt[0], new.disc_opt[0]
    flat.update(flatten_variables({
        "out_params": {"gen": new.gen_params, "mpd": new.mpd_params,
                       "msd": new.msd_params},
        "out_spectral": {"msd": new.msd_spectral},
        "out_gen_mu": {"gen": gen_adam.mu}, "out_gen_nu": {"gen": gen_adam.nu},
        "out_disc_mu": disc_adam.mu, "out_disc_nu": disc_adam.nu}))
    flat["out::gen_count"] = np.asarray(gen_adam.count)
    flat["out::disc_count"] = np.asarray(disc_adam.count)
    flat["out::step"] = np.asarray(new.step)
    flat["out::eval_mel_l1"] = np.asarray(
        jax.jit(tr.make_eval_step())(new, batch))
    flat["meta::config"] = np.asarray(json.dumps({
        "vocoder": dataclasses.asdict(cfg),
        "disc_p_channels": list(DISC_P_CHANNELS), "msd_width": MSD_WIDTH,
        "eps": EPS, "steps_per_epoch": STEPS_PER_EPOCH}))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **{k: np.asarray(v, np.float32)
                                if np.asarray(v).dtype == np.float64
                                else v for k, v in flat.items()})
    host = {k: float(v) for k, v in losses._asdict().items()}
    print(f"{OUT}: {len(flat)} arrays, {os.path.getsize(OUT)} bytes, "
          f"losses {json.dumps(host)}")


if __name__ == "__main__":
    main()
