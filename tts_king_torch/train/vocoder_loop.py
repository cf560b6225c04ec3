"""HiFi-GAN training loop and its CLI.

Port of tts_king_tpu/train/vocoder_loop.py: epochs over MelDataset segments, JSONL metrics (phases ``vocoder`` and
``vocoder_val``), validation mel L1 on the val split, checkpoints holding
the folded inference generator and the full GAN state (train/checkpoint.py),
the resume from one, and an emergency checkpoint when a step fails.

    python -m tts_king_torch.train.vocoder_loop [config.yaml] --wavs-dir DIR
        [--steps N] [--val-frac F] [--fine-tuning --mels-dir DIR]
        [--restore-step N] [--device cuda|cpu]
        [--distributed --coordinator HOST:PORT --num-processes N
         --process-id I]

The CLI is scripts/train_vocoder.py's counterpart: the config is the JAX
package's YAML, the wavs are every ``*.wav`` under ``--wavs-dir`` (sorted;
the first ``--val-frac`` of them, at least one, validate), and training
runs on the card unless ``--device cpu`` is given.

Data parallel (``distributed=True`` in a torch.distributed run: the CLI's
``--distributed``, as python -m tts_king_torch.train's, or torchrun): the
GAN state is replicated over a dp mesh of every rank, each rank loads its
row block of every batch (``MelDataset.batches(shard=...)``, the same
global batches through per-item crop RNGs) and the step averages the
gradients over dp (train/vocoder.py). Rank 0 alone logs and writes the
checkpoints. A single process trains on one device.
"""

import argparse
import os
import sys
from typing import List, Optional

import torch

from tts_king_torch.config import TTSConfig
from tts_king_torch.data.mel_dataset import MelDataset
from tts_king_torch.parallel.lockstep import add_cli_args, init_from_args
from tts_king_torch.pipeline import resolve_device, vocoder_family
from tts_king_torch.train.checkpoint import (load_vocoder_state,
                                             restore_vocoder_state,
                                             save_vocoder_state)
from tts_king_torch.train.vocoder import (VOC_LOSS_NAMES, VocoderTrainer,
                                         export_inference_params)
from tts_king_torch.utils.logging import MetricsLogger


def _vocoder_mesh(vc, use_mesh, distributed, device):
    """The dp mesh of a multi-process run (None in one process; with
    ``use_mesh`` on a host of several cards, a note on stderr that it
    trains on ``device`` alone)."""
    import torch.distributed as dist

    from tts_king_torch.parallel.mesh import build_mesh, note_one_card

    if not distributed:
        if use_mesh:
            note_one_card(device, "train_vocoder()")
        return None
    if not dist.is_initialized():
        raise ValueError(
            "distributed=True needs a torch.distributed process group: "
            "launch with --distributed or torchrun "
            "(parallel.lockstep.initialize)")
    if not use_mesh:
        raise ValueError("multi-process training requires use_mesh=True")
    mesh = build_mesh(dp=-1, tp=1)
    if vc.batch_size % mesh.dp:
        raise ValueError(
            f"vocoder batch_size={vc.batch_size} does not shard evenly over "
            f"dp={mesh.dp}; pick a divisible batch size.")
    return mesh


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
    VocoderTrainer). ``distributed``: every rank of the process group calls
    this, on its own device, and trains one data-parallel run."""
    if not vocoder_family(cfg.model.vocoder_model).trained_as_hifigan:
        raise ValueError(f"train_vocoder trains HiFi-GAN's Generator, not "
                         f"vocoder_model {cfg.model.vocoder_model!r}")
    device = resolve_device(device)
    vc = cfg.vocoder
    mesh = _vocoder_mesh(vc, use_mesh, distributed, device)
    shard = (mesh.dp_axis.index, mesh.dp) if mesh is not None else None
    rank0 = mesh is None or mesh.rank == 0
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
    step_fn = trainer.make_train_step(mesh)

    val_set = None
    if val_paths:
        vp = list(val_paths)
        if len(vp) < vc.batch_size:
            # cycled up to one batch: each item crops with its own RNG
            vp = (vp * vc.batch_size)[: vc.batch_size]
        val_set = MelDataset(vp, vc, fine_tuning=fine_tuning,
                             base_mels_path=base_mels_path, seed=vc.seed,
                             shuffle=False, device=device)
        eval_fn = trainer.make_eval_step(mesh)
    if rank0:
        logger = MetricsLogger(cfg.train.result_path,
                               cfg.exp_name + "_vocoder",
                               cfg.logger.wandb_key, cfg.logger.offline)
    else:
        from tts_king_torch.train.loop import _NullLogger

        logger = _NullLogger()

    def validate(step):
        """Validation mel L1 over the val split (deterministic crops)."""
        if val_set is None:
            return
        vals = [eval_fn(state, vb) for vb in val_set.batches(
            vc.batch_size, seed=vc.seed, shard=shard)]
        if vals:
            v = float(torch.stack(vals).double().mean())
            logger.log(step, {"val_mel_l1": v}, prefix="vocoder_val")

    def save(step):
        if rank0:
            save_vocoder_state(ckpt_dir, step, state,
                               export_inference_params(state.gen))
        if mesh is not None:
            from tts_king_torch.parallel.lockstep import coordination_barrier

            coordination_barrier(f"vocoder_save:{ckpt_dir}")

    total = max_steps if max_steps is not None else 10 ** 9
    step = state.step
    epoch = 0
    try:
        while step < total:
            epoch += 1
            for batch in dataset.batches(vc.batch_size, seed=vc.seed + epoch,
                                         shard=shard):
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
        # discriminators, which this checkpoint then holds. One process
        # only: a mesh's save waits for every rank, and a failure need not
        # be every rank's
        try:
            if mesh is None:
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
        description="HiFi-GAN GAN training")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--wavs-dir", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--val-frac", type=float, default=0.02)
    ap.add_argument("--fine-tuning", action="store_true")
    ap.add_argument("--mels-dir", default=None)
    ap.add_argument("--restore-step", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    add_cli_args(ap)
    args = ap.parse_args(argv)

    from tts_king_torch.config import load_config

    cfg = load_config(args.config) if args.config else TTSConfig()
    wavs = sorted(glob.glob(os.path.join(args.wavs_dir, "**", "*.wav"),
                            recursive=True))
    if not wavs:
        raise SystemExit(f"no wavs under {args.wavs_dir}")
    n_val = max(int(len(wavs) * args.val_frac), 1)
    device = init_from_args(args)
    try:
        state = train_vocoder(
            cfg, wavs[n_val:], val_paths=wavs[:n_val], max_steps=args.steps,
            fine_tuning=args.fine_tuning, base_mels_path=args.mels_dir,
            restore_step=args.restore_step, distributed=args.distributed,
            device=device)
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(f"trained to step {state.step}; checkpoints under "
          f"{os.path.join(cfg.train.ckpt_path, 'vocoder')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
