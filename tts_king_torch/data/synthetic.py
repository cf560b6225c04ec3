"""A synthetic preprocessed corpus: random features in the layout that
``data.dataset.FS2Dataset`` reads (the feature pipeline's output), made
from a seed with numpy.

It needs no audio and no feature extraction, so a training run can be
driven at any size: each utterance draws a phoneme count and a frame count
from the given ranges, phonemes from the Russian inventory with silences
among them, durations that sum to the frame count, and standard-normal mel,
pitch and energy values. The stats.json bins span the pitch and energy
values drawn.
"""

import json
import os

import numpy as np

from tts_king_torch.text.russian import valid_symbols

_SILENCES = ("sil", "sp", "spn")


def _durations(rng, n_phones, n_frames):
    """n_phones positive ints summing to n_frames."""
    cuts = np.sort(rng.choice(np.arange(1, n_frames), n_phones - 1,
                              replace=False))
    return np.diff(np.concatenate([[0], cuts, [n_frames]])).astype(np.int64)


def write_feature_corpus(root, n_train, n_val, n_speakers=4,
                         phones=(8, 24), frames=(30, 90), seed=0):
    """Write ``n_train`` + ``n_val`` utterances under ``root`` (train.txt,
    val.txt, speakers.json, stats.json and the per-utterance .npy files).
    ``phones`` and ``frames`` are inclusive ranges; every frame count must
    be at least its phoneme count."""
    if frames[0] < phones[1]:
        raise ValueError("frames[0] must be at least phones[1]")
    rng = np.random.RandomState(seed)
    kinds = ("mel", "energy", "duration", "pitch", "cwt-pitch", "pitch-mean",
             "pitch-std")
    for d in ("mel", "energy", "duration", "pitch"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    speakers = {f"spk{i}": i for i in range(n_speakers)}
    lines = []
    for u in range(n_train + n_val):
        spk = f"spk{u % n_speakers}"
        name = f"utt{u:05d}"
        L = rng.randint(phones[0], phones[1] + 1)
        T = rng.randint(frames[0], frames[1] + 1)
        ph = [str(p) for p in rng.choice(valid_symbols, L)]
        for i in rng.choice(L, max(1, L // 8), replace=False):
            ph[i] = _SILENCES[rng.randint(len(_SILENCES))]
        feats = {
            "mel": rng.standard_normal((T, 80)).astype(np.float32),
            "energy": rng.standard_normal(L).astype(np.float32),
            "duration": _durations(rng, L, T),
            "pitch": rng.standard_normal(L).astype(np.float32),
            "cwt-pitch": rng.standard_normal((L, 11)).astype(np.float32),
            "pitch-mean": np.float32(rng.standard_normal()),
            "pitch-std": np.float32(rng.rand() + 0.5),
        }
        for kind in kinds:
            sub = "pitch" if "pitch" in kind else kind
            np.save(os.path.join(root, sub, f"{spk}-{kind}-{name}.npy"),
                    feats[kind])
        lines.append(f"{name}|{spk}|{{{' '.join(ph)}}}|raw {u}")
    with open(os.path.join(root, "train.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines[:n_train]) + "\n")
    with open(os.path.join(root, "val.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines[n_train:]) + "\n")
    with open(os.path.join(root, "speakers.json"), "w") as f:
        json.dump(speakers, f)
    with open(os.path.join(root, "stats.json"), "w") as f:
        json.dump({"pitch": [-4.0, 4.0, 0.0, 1.0],
                   "energy": [-4.0, 4.0, 0.0, 1.0]}, f)
    return root
