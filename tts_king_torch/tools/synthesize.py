"""Text-to-speech CLI of the port (scripts/synthesize.py's counterpart):
each ``--text`` through ``TTSKing.speak`` into ``<out>/utt_<i>.wav``.

    python -m tts_king_torch.tools.synthesize [--config cfg.yaml]
        --text "Привет мир" [--text ...] [--speaker 0] [--out DIR]
        [--duration 1.0 --pitch 1.0 --energy 1.0]
        [--dtype float32|bfloat16] [--device cuda|cpu]

The weights are the config's (``acoustic.weights_path``,
``vocoder.weights_path``), or seeded random ones where those are absent.
"""

import argparse
import os

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tts_king_torch.tools.synthesize",
        description="text to wav through TTSKing.speak")
    ap.add_argument("--config", default=None)
    ap.add_argument("--text", required=True, action="append",
                    help="may be given multiple times")
    ap.add_argument("--speaker", default=0)
    ap.add_argument("--out", default="./output/synth")
    ap.add_argument("--duration", type=float, default=1.0)
    ap.add_argument("--pitch", type=float, default=1.0)
    ap.add_argument("--energy", type=float, default=1.0)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from scipy.io import wavfile

    from tts_king_torch.config import TTSConfig, load_config
    from tts_king_torch.pipeline import TTSKing

    cfg = load_config(args.config) if args.config else TTSConfig()
    king = TTSKing(cfg, dtype=DTYPES[args.dtype], device=args.device)
    os.makedirs(args.out, exist_ok=True)
    speaker = args.speaker
    if isinstance(speaker, str) and speaker.isdigit():
        speaker = int(speaker)
    sr = cfg.preprocess.audio.sampling_rate
    for i, text in enumerate(args.text):
        wavs = king.speak(text, args.duration, args.pitch, args.energy,
                          speaker=speaker)
        path = os.path.join(args.out, f"utt_{i}.wav")
        wavfile.write(path, sr, wavs[0])
        print(f"wrote {path} ({len(wavs[0]) / sr:.2f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
