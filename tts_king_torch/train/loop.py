"""FastSpeech2 training loop (train.py:78-235 equivalent).

Port of tts_king_tpu/train/loop.py for one process and one device: the
preprocessed corpus, the FastSpeech2 of the config, the optimizer and its
resume (the reference saved the optimizer state but never restored it,
SURVEY.md §5.4), periodic train/val/objective metrics and checkpoints, the
resume to the right epoch and offset, and an emergency checkpoint when the
run fails.

Attention: every attention call with a gradient goes through the port's
flash kernels (ops/kernels/flash_attention.py), the validation forward
through the inference kernel. Without ``ModelConfig.attention_probs_bf16``
the JAX package's attentions compute one function, so
``use_flash_attention`` and ``use_pallas_attention`` do not matter here.
With it the port follows the JAX MultiHeadAttention's routes
(models/layers.MultiHeadAttention): the train step rounds the softmax
probabilities to bf16 unless ``use_flash_attention``, and the validation,
the objective metrics and the previews round them unless
``use_flash_attention`` or ``use_pallas_attention``; the kernels' bf16-
probability mode computes the rounded calls, their gradient included.

Synthesis previews: with a ``vocoder`` (pipeline.Vocoder), every
``synth_step`` steps one validation utterance, rotating through the split,
is synthesized free-running and written as ``step_<n>.wav`` under
``result_path``, with ``step_<n>.png`` (predicted and ground-truth mels)
where matplotlib imports; without it one log line says the plot was
skipped.

Multi-process: in a ``torch.distributed`` run (``python -m
tts_king_torch.train --distributed``, or torchrun) the processes form a
dp x tp mesh from ``cfg.mesh`` (parallel/mesh.py, rank r at (r // tp,
r % tp)), with JAX's checks: tp divides the ranks of a host, dp is a
multiple of the hosts, and the batch size of dp. Each rank loads its dp
index's rows of every batch (FS2Dataset(shard=...)); the step computes the
global batch's loss and gradients (train/step.py); validation runs over dp;
checkpoints hold the full state in the single-process format
(train/checkpoint.py). Rank 0 alone logs, and runs the previews and the
objective validation where its model computes alone (tp = 1 and no CWT
pitch, whose standardization is over the global batch); elsewhere they are
skipped with a line on stderr. A single process trains on one device.

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


def build_train_mesh(cfg: TTSConfig, device):
    """The dp x tp mesh of a multi-process run (None in one process), with
    the JAX loop's checks (tts_king_tpu/train/loop.py:66-90); a host is
    the LOCAL_WORLD_SIZE ranks torchrun starts there (every rank of a run
    launched by --num-processes). One process asked for every device
    (``mesh.dp`` -1) on a host of several cards is told on stderr that it
    trains on ``device`` alone."""
    import torch.distributed as dist

    from tts_king_torch.parallel.lockstep import local_world_size
    from tts_king_torch.parallel.mesh import build_mesh, note_one_card

    if not dist.is_initialized():
        if cfg.mesh.tp != 1 or cfg.mesh.dp not in (-1, 1):
            raise ValueError(
                f"mesh dp={cfg.mesh.dp} x tp={cfg.mesh.tp} needs "
                f"{max(cfg.mesh.dp, 1) * cfg.mesh.tp} processes: launch "
                "them with --distributed or torchrun (one process trains "
                "on one device)")
        if cfg.mesh.dp == -1:
            note_one_card(device, "train()")
        return None
    mesh = build_mesh(dp=cfg.mesh.dp, tp=cfg.mesh.tp)
    local = local_world_size()
    hosts = max(dist.get_world_size() // local, 1)
    if local % mesh.tp:
        raise ValueError(
            f"tp={mesh.tp} must divide the {local} ranks per host so tp "
            f"stays inside a host and the dp axis crosses hosts in "
            f"contiguous blocks.")
    if mesh.dp % hosts:
        raise ValueError(
            f"dp={mesh.dp} must be a multiple of the {hosts} hosts for "
            f"per-host batch sharding.")
    if cfg.train.optimizer.batch_size % mesh.dp:
        raise ValueError(
            f"batch_size={cfg.train.optimizer.batch_size} does not shard "
            f"evenly over the data axis (dp={mesh.dp}). Pick a batch_size "
            f"divisible by dp, or set mesh.dp to a divisor of the batch "
            f"size.")
    if mesh.rank is None:
        raise ValueError(f"rank {dist.get_rank()} is outside the dp="
                         f"{mesh.dp} x tp={mesh.tp} mesh")
    return mesh


def train(cfg: TTSConfig, max_steps: Optional[int] = None, vocoder=None,
          device="cuda") -> TrainState:
    """Run FS2 training from a preprocessed corpus; returns the final state.
    ``device`` defaults to the card; the CPU is used only when asked for.
    ``vocoder`` (pipeline.Vocoder or None) writes the synthesis previews.
    In a multi-process run every rank calls this, on its own device."""
    device = resolve_device(device)
    mesh = build_train_mesh(cfg, device)
    shard = (mesh.dp_axis.index, mesh.dp) if mesh is not None else (0, 1)
    rank0 = mesh is None or mesh.rank == 0
    pp, tc = cfg.preprocess, cfg.train
    root = pp.preprocessed_path
    with open(os.path.join(root, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(root, "speakers.json")) as f:
        n_speakers = len(json.load(f))

    train_ds = FS2Dataset("train.txt", pp, tc,
                          max_mel_len=cfg.model.max_seq_len, shard=shard)
    val_ds = FS2Dataset("val.txt", pp, tc, drop_last=False,
                        apply_masking=False,
                        max_mel_len=cfg.model.max_seq_len, shard=shard)
    if train_ds.superbatches_per_epoch() == 0:
        raise RuntimeError(
            f"training set produces no batches: {len(train_ds.meta)} "
            f"utterances < batch_size*group_size = "
            f"{tc.optimizer.batch_size * tc.optimizer.grad_acc_step}")

    with torch.device("meta"):
        model = build_fastspeech2(cfg.model, stats, n_speakers,
                                  pp.mel.n_mel_channels)
    sd = init_state_dict(model, tc.seed)
    if mesh is not None:
        from tts_king_torch.parallel.mesh import (shard_fs2,
                                                  shard_state_dict)

        shard_fs2(model, mesh)
        sd = shard_state_dict(sd, mesh)
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
            tc.ckpt_path, cfg.acoustic.restore_step), mesh)

    train_step = make_train_step(optimizer, mesh)
    eval_step = make_eval_step(mesh)
    logger = (MetricsLogger(tc.result_path, cfg.exp_name,
                            cfg.logger.wandb_key, cfg.logger.offline)
              if rank0 else _NullLogger())
    os.makedirs(tc.ckpt_path, exist_ok=True)
    # rank 0's model computes alone only without tp and the CWT pitch
    alone = rank0 and (mesh is None or (mesh.tp == 1
                                        and not cfg.model.use_cwt))
    if not alone and rank0 and (vocoder is not None
                                or tc.objective_val_utts):
        import sys

        sys.stderr.write("[train] previews and objective validation "
                         "skipped: the model is split over tp or its CWT "
                         "pitch standardizes over the global batch\n")
    if not alone:
        vocoder = None

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
                    train_step, eval_step, logger, device, progress, vocoder,
                    mesh, alone)
    except BaseException:
        # failure containment (the reference has none, SURVEY.md §5.3):
        # save the last completed step so the run can resume, then re-raise.
        # One process only, as in the JAX loop: a mesh's save gathers over
        # tp and waits for every rank, and a failure need not be every
        # rank's
        try:
            if mesh is None:
                try:
                    save_train_state(tc.ckpt_path, progress["step"], state)
                    logger.log(progress["step"],
                               {"emergency_checkpoint": 1.0},
                               prefix="failure")
                except Exception as save_err:
                    import sys

                    sys.stderr.write(
                        f"[train] emergency checkpoint failed: {save_err}\n")
        finally:
            logger.close()
        raise
    save_train_state(tc.ckpt_path, state.step, state, mesh)
    logger.close()
    return state


class _NullLogger:
    """The metrics sink of every rank but 0."""

    def log_losses(self, *a, **k):
        pass

    def log(self, *a, **k):
        pass

    def close(self):
        pass


def _run_epochs(cfg, state, total, epoch, start_batch, train_ds, val_ds,
                train_step, eval_step, logger, device, progress, vocoder,
                mesh=None, alone=True):
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
                if tc.objective_val_utts and alone:
                    # free-running MCD / duration MAE (train/metrics.py); F0
                    # metrics need a vocoder (scripts/evaluate.py has them)
                    from tts_king_torch.train.metrics import \
                        evaluate_objective

                    obj = evaluate_objective(
                        state.model, val_ds, device,
                        max_utts=tc.objective_val_utts,
                        max_mel_len=cfg.model.max_seq_len)
                    logger.log(step, obj, prefix="objective")
            if step % tc.step.synth_step == 0 and vocoder is not None:
                synth_preview(cfg, state.model, val_ds, vocoder, step,
                              device)
            if step % tc.step.save_step == 0:
                save_train_state(tc.ckpt_path, step, state, mesh)
            if step >= total:
                return
        start_batch = 0   # the fast-forward applies to the resume epoch only


def synth_preview(cfg, model, val_ds, vocoder, step, device):
    """Synthesize one validation utterance free-running and write
    ``step_<step>.wav`` (and ``step_<step>.png``, predicted beside
    ground-truth mel, where matplotlib imports) under ``result_path``
    (tools.synth_one_sample, fs_two/utils/tools.py:141-206). The utterance
    rotates through the split with the preview step, and is padded to the
    batch loaders' quantized lengths, as the JAX loop's is."""
    from scipy.io import wavfile

    from tts_king_torch.data.dataset import L_STEP, T_STEP, _quantize
    from tts_king_torch.utils.plotting import (matplotlib_available,
                                               plot_mel, save_plot)
    from tts_king_torch.utils.synthesis import pitch_stats_of, skipped_plots

    n_val = len(val_ds.meta)
    if n_val == 0:
        return
    k = (step // max(cfg.train.step.synth_step, 1)) % n_val
    e = val_ds._entry(int(k))
    L = _quantize(len(e[3]), L_STEP)
    T = _quantize(val_ds._mel_len(e[1], e[0]), T_STEP, val_ds.max_mel_len)
    batch = to_device(val_ds._collate([val_ds._item_from_entry(e)], L, T),
                      device)
    model.eval()
    with torch.no_grad():
        out = model(batch["speakers"], batch["texts"], batch["src_lens"],
                    max_mel_len=cfg.model.max_seq_len)
    n = int(out["mel_lens"][0])
    mel_pred = out["postnet_mel"][0, :n].float().cpu().numpy()
    gt_n = int(batch["mel_lens"][0])
    mel_gt = batch["mels"][0, :gt_n].cpu().numpy()

    result = cfg.train.result_path
    os.makedirs(result, exist_ok=True)
    if matplotlib_available():
        save_plot(plot_mel([(mel_pred.T, np.zeros(n), np.zeros(n)),
                            (mel_gt.T, np.zeros(gt_n), np.zeros(gt_n))],
                           pitch_stats_of(cfg),
                           ["Synthesized", "Ground truth"]),
                  os.path.join(result, f"step_{step}.png"))
    else:
        skipped_plots(1, f"train step {step}")
    hop = cfg.preprocess.stft.hop_length
    # an utterance of no frames is an empty wav (the vocoder's first conv
    # needs at least one frame)
    wav = (vocoder.generate(mel_pred[None], lengths=[n * hop])[0] if n
           else np.zeros(0, np.int16))
    wavfile.write(os.path.join(result, f"step_{step}.wav"),
                  cfg.preprocess.audio.sampling_rate, wav)
