"""Speaker-level corpus analysis and filtering (scripts/speaker_stats.py's
counterpart): utterances and mean phones per speaker, and a keep-list.

    python -m tts_king_torch.tools.speaker_stats processed/train.txt
        [--min-utterances 20] [--remove-list removals.txt]
        [--out keep_speakers.txt]

The last line of its output is JSON: {"speakers": N, "kept": K}.
"""

import argparse
import json

from tts_king_torch.data.corpus_tools import filter_speakers, speaker_stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tts_king_torch.tools.speaker_stats",
        description="per-speaker corpus statistics and a keep-list")
    ap.add_argument("metadata")
    ap.add_argument("--min-utterances", type=int, default=20)
    ap.add_argument("--remove-list", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    stats = speaker_stats(args.metadata)
    remove = []
    if args.remove_list:
        with open(args.remove_list, encoding="utf-8") as f:
            remove = [line.strip() for line in f if line.strip()]
    keep = filter_speakers(stats, args.min_utterances, remove)

    for spk in sorted(stats, key=lambda s: -stats[s]["utterances"]):
        s = stats[spk]
        flag = "" if spk in keep else "  [FILTERED]"
        print(f"{spk:40s} {s['utterances']:6d} utts  "
              f"{s['mean_phones']:6.1f} phones/utt{flag}")
    print(json.dumps({"speakers": len(stats), "kept": len(keep)}))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write("\n".join(keep) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
