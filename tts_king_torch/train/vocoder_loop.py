"""HiFi-GAN training loop and its CLI.

Port of tts_king_tpu/train/vocoder_loop.py for one process and one device:
epochs over MelDataset segments, JSONL metrics (phases ``vocoder`` and
``vocoder_val``), validation mel L1 on the val split, checkpoints holding
the folded inference generator and the full GAN state (train/checkpoint.py),
the resume from one, and an emergency checkpoint when a step fails.

    python -m tts_king_torch.train.vocoder_loop [config.yaml] --wavs-dir DIR
        [--steps N] [--val-frac F] [--fine-tuning --mels-dir DIR]
        [--restore-step N] [--device cuda|cpu]

The CLI is scripts/train_vocoder.py's counterpart: the config is the JAX
package's YAML, the wavs are every ``*.wav`` under ``--wavs-dir`` (sorted;
the first ``--val-frac`` of them, at least one, validate), and training
runs on the card unless ``--device cpu`` is given. Data parallelism over
several cards or processes (``distributed=True``, ``--distributed``,
``--coordinator``; ``use_mesh=True`` on a host with more than one card)
is not ported yet and raises ``NotImplementedError``.
"""

import argparse
import os
import sys
from typing import List, Optional

import torch

from tts_king_torch.config import TTSConfig
from tts_king_torch.data.mel_dataset import MelDataset
from tts_king_torch.pipeline import resolve_device
from tts_king_torch.train.checkpoint import (load_vocoder_state,
                                             restore_vocoder_state,
                                             save_vocoder_state)
from tts_king_torch.train.vocoder import (VOC_LOSS_NAMES, VocoderTrainer,
                                         export_inference_params)
from tts_king_torch.utils.logging import MetricsLogger

_PARALLEL = ("comes with the parallelism slice of the port; pass "
             "use_mesh=False to train on one card")


def _check_ported(device, use_mesh, distributed):
    if distributed:
        raise NotImplementedError(
            "distributed=True: multi-process vocoder training is not ported "
            "yet; it " + _PARALLEL)
    if (use_mesh and device.type == "cuda"
            and torch.cuda.device_count() > 1):
        raise NotImplementedError(
            f"use_mesh=True on a host with {torch.cuda.device_count()} "
            "cards: data-parallel vocoder training is not ported yet; it "
            + _PARALLEL)


def train_vocoder(cfg: TTSConfig, wav_paths: List[str],
                  val_paths: Optional[List[str]] = None,
                  max_steps: Optional[int] = None,
                  ckpt_dir: Optional[str] = None,
                  log_every: int = 100, save_every: int = 5000,
                  fine_tuning: bool = False, base_mels_path=None,
                  restore_step: Optional[int] = None,
                  disc_p_channels=None, msd_width: int = 1,
                  use_mesh: bool = True, distributed: bool = False,
                  compute_dtype=None, device="cuda"):
    """Train HiFi-GAN on ``wav_paths``; returns the final VocoderTrainState.
    ``device`` defaults to the card; the CPU is used only when asked for.
    compute_dtype: the GAN step's conv dtype (None = f32; see
    VocoderTrainer)."""
    device = resolve_device(device)
    _check_ported(device, use_mesh, distributed)
    vc = cfg.vocoder
    ckpt_dir = ckpt_dir or os.path.join(cfg.train.ckpt_path, "vocoder")
    os.makedirs(ckpt_dir, exist_ok=True)

    dataset = MelDataset(wav_paths, vc, fine_tuning=fine_tuning,
                         base_mels_path=base_mels_path, seed=vc.seed,
                         device=device)
    if len(dataset) < vc.batch_size:
        # batches() would yield nothing and the epoch loop would spin
        raise ValueError(
            f"{len(dataset)} training wavs < vocoder batch_size="
            f"{vc.batch_size}; add data or lower the batch size")
    steps_per_epoch = max(len(dataset) // vc.batch_size, 1)
    trainer = VocoderTrainer(vc, disc_p_channels=disc_p_channels,
                             msd_width=msd_width,
                             steps_per_epoch=steps_per_epoch,
                             compute_dtype=compute_dtype, device=device)
    state = trainer.init_state(vc.seed)
    if restore_step is not None:
        load_vocoder_state(state, restore_vocoder_state(ckpt_dir,
                                                        restore_step))
    step_fn = trainer.make_train_step()

    val_set = None
    if val_paths:
        vp = list(val_paths)
        if len(vp) < vc.batch_size:
            # cycled up to one batch: each item crops with its own RNG
            vp = (vp * vc.batch_size)[: vc.batch_size]
        val_set = MelDataset(vp, vc, fine_tuning=fine_tuning,
                             base_mels_path=base_mels_path, seed=vc.seed,
                             shuffle=False, device=device)
        eval_fn = trainer.make_eval_step()
    logger = MetricsLogger(cfg.train.result_path, cfg.exp_name + "_vocoder",
                           cfg.logger.wandb_key, cfg.logger.offline)

    def validate(step):
        """Validation mel L1 over the val split (deterministic crops)."""
        if val_set is None:
            return
        vals = [eval_fn(state, vb)
                for vb in val_set.batches(vc.batch_size, seed=vc.seed)]
        if vals:
            v = float(torch.stack(vals).double().mean())
            logger.log(step, {"val_mel_l1": v}, prefix="vocoder_val")

    def save(step):
        save_vocoder_state(ckpt_dir, step, state,
                           export_inference_params(state.gen))

    total = max_steps if max_steps is not None else 10 ** 9
    step = state.step
    epoch = 0
    try:
        while step < total:
            epoch += 1
            for batch in dataset.batches(vc.batch_size, seed=vc.seed + epoch):
                losses = step_fn(state, batch)
                step = state.step
                if step % log_every == 0:
                    host = torch.stack(list(losses)).double().cpu().tolist()
                    logger.log(step, dict(zip(VOC_LOSS_NAMES, host)),
                               prefix="vocoder")
                if step % save_every == 0:
                    validate(step)
                    save(step)
                if step >= total:
                    break
    except BaseException:
        # the last completed step, so that the run can resume; a step that
        # failed in its generator half has already updated the
        # discriminators, which this checkpoint then holds
        try:
            save(step)
        except Exception as save_err:
            sys.stderr.write(
                f"[train_vocoder] emergency checkpoint failed: {save_err}\n")
        finally:
            logger.close()
        raise
    validate(step)
    save(step)
    logger.close()
    return state


def main(argv=None):
    import glob

    ap = argparse.ArgumentParser(
        prog="python -m tts_king_torch.train.vocoder_loop",
        description="HiFi-GAN GAN training on one device")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--wavs-dir", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--val-frac", type=float, default=0.02)
    ap.add_argument("--fine-tuning", action="store_true")
    ap.add_argument("--mels-dir", default=None)
    ap.add_argument("--restore-step", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process training (not ported yet)")
    ap.add_argument("--coordinator", default=None,
                    help="multi-process coordinator (not ported yet)")
    args = ap.parse_args(argv)
    if args.distributed or args.coordinator:
        raise NotImplementedError(
            "--distributed / --coordinator: multi-process vocoder training "
            "is not ported yet; it comes with the parallelism slice of the "
            "port")

    from tts_king_torch.config import load_config

    cfg = load_config(args.config) if args.config else TTSConfig()
    wavs = sorted(glob.glob(os.path.join(args.wavs_dir, "**", "*.wav"),
                            recursive=True))
    if not wavs:
        raise SystemExit(f"no wavs under {args.wavs_dir}")
    n_val = max(int(len(wavs) * args.val_frac), 1)
    state = train_vocoder(
        cfg, wavs[n_val:], val_paths=wavs[:n_val], max_steps=args.steps,
        fine_tuning=args.fine_tuning, base_mels_path=args.mels_dir,
        restore_step=args.restore_step, device=args.device)
    print(f"trained to step {state.step}; checkpoints under "
          f"{os.path.join(cfg.train.ckpt_path, 'vocoder')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
