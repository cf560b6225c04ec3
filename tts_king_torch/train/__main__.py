"""FastSpeech2 training CLI of the port (scripts/train.py's counterpart,
one process, one device):

    python -m tts_king_torch.train [config.yaml] [--steps N] [--no-vocoder]
                                  [--device cuda|cpu]

The config is the JAX package's YAML (native or reference layout). Training
runs on the card unless ``--device cpu`` is given. Synthesis previews go
through a ``Vocoder`` built from ``vocoder.weights_path`` where that file
exists, unless ``--no-vocoder`` is given. ``--distributed`` is not ported
yet and raises ``NotImplementedError``.
"""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tts_king_torch.train",
        description="FastSpeech2 training on one device")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--steps", type=int, default=None,
                    help="override total_step")
    ap.add_argument("--no-vocoder", action="store_true",
                    help="skip synthesis previews through the vocoder")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process training (not ported yet)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "--distributed: multi-process training is not ported yet; it "
            "comes with the parallelism slice of the port")

    from tts_king_torch.config import TTSConfig, load_config
    from tts_king_torch.train.loop import train

    cfg = load_config(args.config) if args.config else TTSConfig()
    vocoder = None
    if (not args.no_vocoder and cfg.vocoder.weights_path
            and os.path.exists(cfg.vocoder.weights_path)):
        from tts_king_torch.pipeline import Vocoder

        vocoder = Vocoder(cfg, device=args.device)
    state = train(cfg, max_steps=args.steps, vocoder=vocoder,
                  device=args.device)
    print(f"trained to step {state.step}; checkpoints under "
          f"{cfg.train.ckpt_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
