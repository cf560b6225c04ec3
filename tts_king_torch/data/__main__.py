"""Feature-extraction CLI of the port (scripts/prepare_data.py's
counterpart):

    python -m tts_king_torch.data [config.yaml] [--device cuda|cpu]

Reads the raw corpus at ``preprocess.raw_path`` (``<speaker>/<name>.wav``
with its MFA ``.TextGrid`` and optional ``.lab``) and writes the feature
tree to ``preprocess.preprocessed_path``, split with ``train.seed``. The
config is the JAX package's YAML (native or reference layout). The mel,
energy, YIN and CWT work runs on the card unless ``--device cpu`` is given;
the F0 backend is the Preprocessor's ``"auto"`` choice, which is printed.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tts_king_torch.data",
        description="raw corpus -> FastSpeech2 training features")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tts_king_torch.config import TTSConfig, load_config
    from tts_king_torch.data.features import Preprocessor

    cfg = load_config(args.config) if args.config else TTSConfig()
    pre = Preprocessor(cfg.preprocess, device=args.device)
    print(f"pitch backend: {pre.pitch_backend}")
    pre.build_from_path(seed=cfg.train.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
