"""Voice-over generation of the port (examples/voice_over.py's
counterpart): a multi-sentence script into one audio track with pauses
between the lines, each line with its own speaker.

    python -m tts_king_torch.examples.voice_over --out voiceover.wav \\
        --line "0|Первое предложение." --line "1|Второе предложение." \\
        [--micro] [--device cpu]

Lines are "speaker|text". With no checkpoint weights the audio is noise,
but the path (G2P -> FS2 -> HiFi-GAN -> concatenation) runs end to end.
``--time-shard`` (one long utterance vocoded across several cards) comes
with the parallelism slice of the port and raises NotImplementedError.
"""

import argparse

import numpy as np

# Naive Cyrillic -> phone transliteration for runs without a G2P backend:
# every letter maps onto a symbol of the 206-symbol inventory.
_TRANSLIT = {
    "а": "A", "б": "B", "в": "V", "г": "G", "д": "D", "е": "E", "ё": "O",
    "ж": "Z", "з": "Z", "и": "I", "й": "J", "к": "K", "л": "L", "м": "M",
    "н": "N", "о": "O", "п": "P", "р": "R", "с": "S", "т": "T", "у": "U",
    "ф": "F", "х": "H", "ц": "C", "ч": "C", "ш": "S", "щ": "S", "ъ": "",
    "ы": "Y", "ь": "", "э": "E", "ю": "U", "я": "A", " ": "sp",
}


def line_to_mel(king, text, speaker, duration):
    """text -> (mel (1, T, 80) f32 numpy, n frames), through transliterated
    phonemes where no G2P backend is available."""
    try:
        mel, lens = king.generate_mel(text, duration_control=duration,
                                      speaker=speaker)
    except ImportError:
        from tts_king_torch.text import text_to_sequence

        phones = [p for p in (_TRANSLIT.get(ch, "") for ch in text.lower())
                  if p]
        seq = text_to_sequence("{" + " ".join(phones) + "}", [])
        out = king.tts.generate(np.array([seq], np.int32),
                                duration_control=duration,
                                speaker_name=speaker)
        mel, lens = out["postnet_mel"], out["mel_lens"]
    return mel.float().cpu().numpy(), int(lens[0])


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tts_king_torch.examples.voice_over")
    ap.add_argument("--config", default=None)
    ap.add_argument("--line", action="append", required=True,
                    help='"speaker_id|text", repeatable')
    ap.add_argument("--out", default="voiceover.wav")
    ap.add_argument("--pause-ms", type=float, default=300.0)
    ap.add_argument("--duration", type=float, default=1.0)
    ap.add_argument("--time-shard", action="store_true",
                    help="vocode the track across several cards (not "
                         "ported yet)")
    ap.add_argument("--micro", action="store_true",
                    help="toy model sizes (fast on the CPU; same flow)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.time_shard:
        raise NotImplementedError(
            "--time-shard: vocoding across several cards comes with the "
            "parallelism slice of the port")

    from scipy.io import wavfile

    from tts_king_torch.examples.basic_usage import (bias_durations,
                                                     example_config,
                                                     example_king,
                                                     has_weights)

    cfg = example_config(args.micro, args.config)
    ids = [int(s) for s, _ in (ln.split("|", 1) for ln in args.line)
           if s.isdigit()]
    king = example_king(cfg, args.device, max(ids, default=0) + 1)
    if not has_weights(cfg):
        bias_durations(king)   # realistic lengths from random weights
    sr = cfg.preprocess.audio.sampling_rate
    pause = np.zeros(int(sr * args.pause_ms / 1000), np.int16)

    pieces = []
    for line in args.line:
        speaker, text = line.split("|", 1)
        mel, n = line_to_mel(
            king, text, int(speaker) if speaker.isdigit() else speaker,
            args.duration)
        wavs = king.mel_to_wav(mel[:, :n], np.asarray([n]))
        pieces += [wavs[0], pause]
    track = np.concatenate(pieces[:-1]) if pieces else np.zeros(0, np.int16)
    wavfile.write(args.out, sr, track)
    print(f"wrote {args.out}: {len(track) / sr:.2f}s, {len(args.line)} lines")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
