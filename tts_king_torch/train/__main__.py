"""FastSpeech2 training CLI of the port (scripts/train.py's counterpart):

    python -m tts_king_torch.train [config.yaml] [--steps N] [--no-vocoder]
                                  [--device cuda|cpu]

The config is the JAX package's YAML (native or reference layout). Training
runs on the card unless ``--device cpu`` is given. Synthesis previews go
through a ``Vocoder`` built from ``vocoder.weights_path`` where that file
exists, unless ``--no-vocoder`` is given.

Multi-process (one command per process; the mesh is the config's
``mesh.dp`` x ``mesh.tp``, train/loop.py):

    python -m tts_king_torch.train cfg.yaml --distributed \\
        --coordinator HOST:PORT --num-processes N --process-id I

or ``torchrun --nproc-per-node N -m tts_king_torch.train cfg.yaml
--distributed``, whose environment gives the three values. Each process
takes card ``LOCAL_RANK`` (or I) modulo the host's cards; the backend is
NCCL where every process of a host has a card of its own, else gloo.
One process on a host of several cards trains on one of them, and says so
on stderr.
"""

import argparse
import os

from tts_king_torch.parallel.lockstep import add_cli_args, init_from_args


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tts_king_torch.train",
        description="FastSpeech2 training")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--steps", type=int, default=None,
                    help="override total_step")
    ap.add_argument("--no-vocoder", action="store_true",
                    help="skip synthesis previews through the vocoder")
    ap.add_argument("--device", default="cuda")
    add_cli_args(ap)
    args = ap.parse_args(argv)

    from tts_king_torch.config import TTSConfig, load_config
    from tts_king_torch.train.loop import train

    device = init_from_args(args)
    cfg = load_config(args.config) if args.config else TTSConfig()
    vocoder = None
    if (not args.no_vocoder and cfg.vocoder.weights_path
            and os.path.exists(cfg.vocoder.weights_path)):
        from tts_king_torch.pipeline import Vocoder

        vocoder = Vocoder(cfg, device=device)
    try:
        state = train(cfg, max_steps=args.steps, vocoder=vocoder,
                      device=device)
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(f"trained to step {state.step}; checkpoints under "
          f"{cfg.train.ckpt_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
