"""FastSpeech2 training loop (train.py:78-235 equivalent).

Port of tts_king_tpu/train/loop.py for one process and one device: the
preprocessed corpus, the FastSpeech2 of the config, the optimizer and its
resume (the reference saved the optimizer state but never restored it,
SURVEY.md §5.4), periodic train/val/objective metrics and checkpoints, the
resume to the right epoch and offset, and an emergency checkpoint when the
run fails.

Attention: every attention call with a gradient goes through the port's
flash kernels (ops/kernels/flash_attention.py), the validation forward
through the inference kernel. ``ModelConfig.use_flash_attention`` selects
between the JAX package's two training attentions, which compute one
function; it does not matter here.

Not ported yet, and raising ``NotImplementedError``: a device mesh
(``MeshConfig`` other than one device, or ``--distributed``; the
parallelism slice), ``attention_probs_bf16=True`` (a bf16 training slice)
and synthesis previews through a ``vocoder`` (a later slice; they need
matplotlib).
"""

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from tts_king_torch.config import TTSConfig
from tts_king_torch.data.dataset import FS2Dataset
from tts_king_torch.models.fs2 import build_fastspeech2
from tts_king_torch.pipeline import resolve_device
from tts_king_torch.train.checkpoint import (load_train_state,
                                             restore_train_state,
                                             save_train_state)
from tts_king_torch.train.evaluate import evaluate
from tts_king_torch.train.state import Optimizer, TrainState, init_state_dict
from tts_king_torch.train.step import (make_eval_step, make_train_step,
                                       to_device)
from tts_king_torch.utils.logging import MetricsLogger
from tts_king_torch.weights import load_into


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of optimizer step ``step``: a function of
    (seed, step) alone, as the JAX loop's fold_in(rng, step) is, so a
    resumed run draws the same masks as an uninterrupted one."""
    s = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(s[0]) << 31) ^ int(s[1]))


def _check_ported(cfg: TTSConfig, vocoder):
    if cfg.mesh.tp != 1 or cfg.mesh.dp not in (-1, 1):
        raise NotImplementedError(
            f"mesh dp={cfg.mesh.dp} tp={cfg.mesh.tp}: data and tensor "
            "parallel training is not ported yet; it comes with the "
            "parallelism slice of the port")
    if cfg.model.attention_probs_bf16:
        raise NotImplementedError(
            "attention_probs_bf16=True: bf16 training is not ported yet; it "
            "comes with a bf16 training slice of the port")
    if vocoder is not None:
        raise NotImplementedError(
            "synthesis previews through a vocoder are not ported yet; they "
            "come in a later slice of the port (pass vocoder=None)")


def train(cfg: TTSConfig, max_steps: Optional[int] = None, vocoder=None,
          device="cuda") -> TrainState:
    """Run FS2 training from a preprocessed corpus; returns the final state.
    ``device`` defaults to the card; the CPU is used only when asked for."""
    _check_ported(cfg, vocoder)
    device = resolve_device(device)
    pp, tc = cfg.preprocess, cfg.train
    root = pp.preprocessed_path
    with open(os.path.join(root, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(root, "speakers.json")) as f:
        n_speakers = len(json.load(f))

    train_ds = FS2Dataset("train.txt", pp, tc,
                          max_mel_len=cfg.model.max_seq_len)
    val_ds = FS2Dataset("val.txt", pp, tc, drop_last=False,
                        apply_masking=False,
                        max_mel_len=cfg.model.max_seq_len)
    if train_ds.superbatches_per_epoch() == 0:
        raise RuntimeError(
            f"training set produces no batches: {len(train_ds.meta)} "
            f"utterances < batch_size*group_size = "
            f"{tc.optimizer.batch_size * tc.optimizer.grad_acc_step}")

    with torch.device("meta"):
        model = build_fastspeech2(cfg.model, stats, n_speakers,
                                  pp.mel.n_mel_channels)
    sd = init_state_dict(model, tc.seed)
    model = load_into(model.to_empty(device=device), sd)
    optimizer = Optimizer(tc.optimizer, cfg.model.transformer.encoder_hidden)
    state = TrainState(model, optimizer.init(model),
                       cfg.acoustic.restore_step)

    if cfg.acoustic.restore_step:
        if not os.path.isdir(tc.ckpt_path):
            # fail loudly: training from random weights while the step
            # counter claims a resume would look like a successful run
            raise FileNotFoundError(
                f"restore_step={cfg.acoustic.restore_step} but checkpoint "
                f"directory {tc.ckpt_path!r} does not exist")
        load_train_state(state, restore_train_state(
            tc.ckpt_path, cfg.acoustic.restore_step))

    train_step = make_train_step(optimizer)
    eval_step = make_eval_step()
    logger = MetricsLogger(tc.result_path, cfg.exp_name,
                           cfg.logger.wandb_key, cfg.logger.offline)
    os.makedirs(tc.ckpt_path, exist_ok=True)

    if cfg.run_debug_eval:
        val = evaluate(eval_step, state, val_ds, device, max_batches=4)
        logger.log_losses(state.step, val, prefix="val")

    total = max_steps if max_steps is not None else tc.step.total_step
    # resume continues the epoch's data sequence where the run left off
    spe = train_ds.superbatches_per_epoch()
    epoch, start_batch = divmod(state.step, spe)
    # the last completed step, for the emergency checkpoint
    progress = {"step": state.step}
    try:
        _run_epochs(cfg, state, total, epoch, start_batch, train_ds, val_ds,
                    train_step, eval_step, logger, device, progress)
    except BaseException:
        # failure containment (the reference has none, SURVEY.md §5.3):
        # save the last completed step so the run can resume, then re-raise
        try:
            try:
                save_train_state(tc.ckpt_path, progress["step"], state)
                logger.log(progress["step"], {"emergency_checkpoint": 1.0},
                           prefix="failure")
            except Exception as save_err:
                import sys

                sys.stderr.write(
                    f"[train] emergency checkpoint failed: {save_err}\n")
        finally:
            logger.close()
        raise
    save_train_state(tc.ckpt_path, state.step, state)
    logger.close()
    return state


def _run_epochs(cfg, state, total, epoch, start_batch, train_ds, val_ds,
                train_step, eval_step, logger, device, progress):
    tc = cfg.train
    t_last = time.time()
    while state.step < total:
        epoch += 1
        for superbatch in train_ds.epoch_superbatches(
                seed=tc.seed + epoch, start_batch=start_batch):
            losses = train_step(state, to_device(superbatch, device),
                                step_generator(tc.seed, state.step, device))
            progress["step"] = step = state.step
            if step % tc.step.log_step == 0:
                dt = (time.time() - t_last) / tc.step.log_step
                t_last = time.time()
                host = torch.stack(list(losses)).double().cpu().numpy()
                logger.log_losses(step, host, prefix="train",
                                  extra={"sec_per_step": dt, "epoch": epoch})
            if step % tc.step.val_step == 0:
                val = evaluate(eval_step, state, val_ds, device)
                logger.log_losses(step, val, prefix="val")
                if tc.objective_val_utts:
                    # free-running MCD / duration MAE (train/metrics.py); F0
                    # metrics need a vocoder (scripts/evaluate.py has them)
                    from tts_king_torch.train.metrics import \
                        evaluate_objective

                    obj = evaluate_objective(
                        state.model, val_ds, device,
                        max_utts=tc.objective_val_utts,
                        max_mel_len=cfg.model.max_seq_len)
                    logger.log(step, obj, prefix="objective")
            if step % tc.step.save_step == 0:
                save_train_state(tc.ckpt_path, step, state)
            if step >= total:
                return
        start_batch = 0   # the fast-forward applies to the resume epoch only
