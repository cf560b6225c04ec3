"""Corpus curation utilities (data_utils/* + dataset_review/* equivalents).

Port of tts_king_tpu/data/corpus_tools.py (the same host code). One
importable, tested module replacing the reference's collection of one-off
scripts (SURVEY.md §2.19-2.20): LJSpeech-style metadata.csv -> per-speaker
wav+lab layout, vocabulary extraction, Cyrillic-only text stripping,
lab -> metadata.csv, removal of utterances MFA failed to align, mp3 -> wav
conversion (ffmpeg, gated), and the speaker-stats analysis the reference kept
in notebooks.
"""

import os
import shutil
import subprocess
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

CYRILLIC_LETTERS = (
    "АаБбВвГгДдЕеЁёЖжЗзИиЙйКкЛлМмНнОоПпРрСсТтУуФфХхЦцЧчШшЩщЪъЫыЬьЭэЮюЯя")


def read_metadata_csv(path: str) -> Iterable[Tuple[str, str]]:
    """LJ-style metadata.csv lines `name|text|normalized_text` ->
    (name, lowercased normalized text) (data_utils/dataset.py:11-17)."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) >= 3:
                yield parts[0], parts[2].lower()


def ljspeech_to_speaker_layout(dataset_root: str, out_dir: str,
                               yo_to_jo: bool = True) -> List[str]:
    """Walk `dataset_root` for `<speaker>/<set>/metadata.csv` + wavs/ trees
    and copy into `<out_dir>/<speaker>/{name.wav,name.lab}` (the MFA input
    layout; data_utils/dataset.py:19-38). Returns the vocabulary."""
    os.makedirs(out_dir, exist_ok=True)
    vocab: Counter = Counter()
    for root, _dirs, files in os.walk(dataset_root):
        if "metadata.csv" not in files:
            continue
        speaker = os.path.basename(os.path.dirname(root)) or "speaker"
        for name, text in read_metadata_csv(os.path.join(root, "metadata.csv")):
            if yo_to_jo:
                text = text.replace("ё", "йо")  # reference quirk, dataset.py:38
            wav_src = os.path.join(root, "wavs", name + ".wav")
            if not os.path.exists(wav_src):
                continue
            sdir = os.path.join(out_dir, speaker)
            os.makedirs(sdir, exist_ok=True)
            shutil.copy(wav_src, os.path.join(sdir, name + ".wav"))
            with open(os.path.join(sdir, name + ".lab"), "w",
                      encoding="utf-8") as f:
                f.write(text)
            vocab.update(text.split(" "))
    return sorted(vocab)


def strip_non_cyrillic(text: str) -> str:
    """Keep Cyrillic letters only (data_utils/clean.py:8-13)."""
    return "".join(c for c in text if c in CYRILLIC_LETTERS)


def clean_vocab(words: Iterable[str]) -> List[str]:
    """Cyrillic-strip + sort by length (data_utils/clean.py:14-19)."""
    return sorted((strip_non_cyrillic(w) for w in words), key=len)


def labs_to_metadata_csv(speaker_dir: str) -> str:
    """Build `metadata.csv` from .lab files in a speaker directory
    (data_utils/makecsv.py). Returns the written path."""
    records = set()
    for fname in sorted(os.listdir(speaker_dir)):
        if not fname.endswith(".lab"):
            continue
        with open(os.path.join(speaker_dir, fname), encoding="utf-8") as f:
            text = f.read().replace("\n", "")
        base = fname[: -len(".lab")]
        records.add(f"{base}|{text}|{text}")
    out = os.path.join(speaker_dir, "metadata.csv")
    with open(out, "w", encoding="utf-8") as f:
        for rec in sorted(records):
            f.write(rec + "\n")
    return out


def remove_unaligned(corpus_dir: str, bad_list_path: str,
                     extensions=(".wav", ".txt", ".lab")) -> int:
    """Delete utterances MFA could not align (data_utils/remove_bad_grid.py).

    bad_list_path: file with one basename per line (first whitespace-
    delimited token). Returns the number of removed utterances.
    """
    with open(bad_list_path, encoding="utf-8") as f:
        bad = {line.split(" ")[0].split("\t")[0]
               for line in f.read().split("\n") if line.strip()}
    path_by_name: Dict[str, str] = {}
    for root, _dirs, files in os.walk(corpus_dir):
        for fname in files:
            if fname.endswith(".wav"):
                base = fname[: -len(".wav")]
                path_by_name[base] = os.path.join(root, base)
    removed = 0
    for name in bad:
        stem = path_by_name.get(name)
        if stem is None:
            continue
        for ext in extensions:
            try:
                os.remove(stem + ext)
            except OSError:
                pass
        removed += 1
    return removed


def mp3_to_wav(src_dir: str, out_dir: str, sampling_rate: int = 22050) -> int:
    """ffmpeg-based mp3 -> wav conversion (audio_process.py:4-14); returns
    converted count, 0 when ffmpeg is unavailable."""
    if shutil.which("ffmpeg") is None:
        return 0
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(src_dir)):
        if not fname.endswith(".mp3"):
            continue
        out = os.path.join(out_dir, fname[:-4] + ".wav")
        subprocess.run(
            ["ffmpeg", "-y", "-i", os.path.join(src_dir, fname),
             "-ar", str(sampling_rate), "-ac", "1", out],
            check=True, capture_output=True)
        n += 1
    return n


def speaker_stats(metadata_path: str) -> Dict[str, Dict[str, float]]:
    """Per-speaker utterance counts + mean text length from a train.txt-style
    metadata file (the dataset_review/speakers_stats.ipynb analysis)."""
    counts: Counter = Counter()
    text_len: Counter = Counter()
    with open(metadata_path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 4:
                continue
            _, speaker, text, _raw = parts
            counts[speaker] += 1
            text_len[speaker] += len(text.strip("{}").split(" "))
    return {
        spk: {"utterances": counts[spk],
              "mean_phones": text_len[spk] / counts[spk]}
        for spk in counts
    }


def filter_speakers(stats: Dict[str, Dict[str, float]],
                    min_utterances: int = 20,
                    remove: Optional[Iterable[str]] = None) -> List[str]:
    """Speakers to KEEP: enough data and not on the manual removal list
    (dataset_review/filter_speakers.ipynb semantics)."""
    remove = set(remove or ())
    return sorted(
        spk for spk, s in stats.items()
        if s["utterances"] >= min_utterances and spk not in remove)
