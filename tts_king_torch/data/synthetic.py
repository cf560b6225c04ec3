"""Synthetic corpora, made from a seed with numpy.

Two kinds:

  * ``generate_corpus`` writes a raw corpus (wav + .lab + MFA-style
    .TextGrid per utterance, in the ``raw_path/<speaker>/`` layout that the
    feature pipeline, data/features.py, reads; the reference's convention,
    fs_two/preprocessor/preprocessor.py:84-105). Vowels are formant-filtered
    glottal pulse trains with per-speaker F0 and vocal-tract scaling,
    consonants shaped noise bursts, so the acoustics follow the phone
    identity, the speaker and the prosody as real speech does. A port of
    tts_king_tpu/data/synthetic.py with numpy seeded alike, so both packages
    write byte-identical corpora from one seed.
  * ``write_feature_corpus`` writes random features in the layout that
    ``data.dataset.FS2Dataset`` reads (the feature pipeline's output). It
    needs no audio and no feature extraction, so a training run can be
    driven at any size: each utterance draws a phoneme count and a frame
    count from the given ranges, phonemes from the Russian inventory with
    silences among them, durations that sum to the frame count, and
    standard-normal mel, pitch and energy values. The stats.json bins span
    the pitch and energy values drawn.
"""

import json
import os
from dataclasses import dataclass

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


# ------------------------------------------------------------- raw corpus

VOWELS = {
    # phone: (F1, F2) Hz rough vowel-triangle targets
    "A": (800, 1200),
    "O": (500, 900),
    "U": (350, 700),
    "I": (300, 2300),
    # "E0", not "E": the symbol table has stressed E0 but no bare E (unlike
    # A/O/U/I/Y) — a bare E was silently dropped by text_to_sequence,
    # misaligning text vs duration targets for every utterance containing
    # it (the Preprocessor's phone validation refuses such phones)
    "E0": (500, 1900),
    "Y": (420, 1600),
}
CONSONANTS = {
    # phone: (noise centre Hz, bandwidth Hz, voiced?)
    "S": (5500, 3000, False),
    "T": (4000, 3500, False),
    "K": (2500, 2000, False),
    "P": (1200, 1500, False),
    "F": (4500, 3500, False),
    "Z": (5000, 3000, True),
    "B": (900, 1200, True),
    "D": (3500, 3000, True),
    "G": (2200, 1800, True),
    "M": (300, 400, True),
    "N": (350, 500, True),
    "R": (700, 900, True),
    "L": (450, 700, True),
    "V": (1000, 1400, True),
    # "J0", not "J": like E0 above — the table has palatal J0, no bare J
    "J0": (2800, 1800, True),
}


@dataclass
class Speaker:
    name: str
    f0_base: float        # Hz
    tract_scale: float    # formant multiplier (vocal tract length proxy)


def default_speakers(n=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        f0 = float(rng.uniform(95, 135) if i % 2 == 0
                   else rng.uniform(175, 235))
        out.append(Speaker(f"spk_{i:02d}", f0,
                           float(rng.uniform(0.9, 1.15))))
    return out


def _bandpass_noise(n, sr, centre, bw, rng):
    x = rng.randn(n)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    gain = np.exp(-0.5 * ((freqs - centre) / (bw / 2.0)) ** 2)
    return np.fft.irfft(spec * gain, n)


def _formant_voice(n, sr, f0_contour, formants, rng):
    """Glottal pulse train at f0 -> two formant resonances."""
    phase = 2 * np.pi * np.cumsum(f0_contour) / sr
    # pulse-ish source: saturated harmonics-rich waveform
    src = np.sin(phase) + 0.5 * np.sin(2 * phase) + 0.25 * np.sin(3 * phase)
    src = np.tanh(2.0 * src)
    src += 0.02 * rng.randn(n)
    spec = np.fft.rfft(src)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    # Vocal-tract envelope: formant resonances ON TOP of a strong low end —
    # real glottal spectra keep the fundamental dominant (suppressing it
    # makes every F0 estimator, ours included, rightly call it unvoiced).
    gain = np.zeros_like(freqs)
    for fc, amp in zip(formants, (1.0, 0.6)):
        gain += amp * np.exp(-0.5 * ((freqs - fc) / 120.0) ** 2)
    gain = (gain + 1.0) / (1.0 + (freqs / 1500.0) ** 2)
    return np.fft.irfft(spec * gain, n)


def synth_utterance(phones, durations_s, speaker: Speaker, sr=22050,
                    seed=0):
    """phones + per-phone durations -> (wav float32, intervals).

    A smooth declination F0 contour with per-utterance variation gives the
    pitch predictor something real to learn."""
    rng = np.random.RandomState(seed)
    total = int(round(sum(durations_s) * sr))
    frac = np.arange(total) / max(total, 1)      # 0..1 through the utterance
    secs = np.arange(total) / sr
    # Prosody variance (richer than a fixed declination so the pitch /
    # energy / duration predictors have real utterance- and word-level
    # structure to learn):
    #   * per-utterance F0 scale and declination depth;
    #   * per-word F0 accents (smooth bumps spanning each word);
    #   * per-word amplitude (energy) variation, applied below.
    base_scale = rng.uniform(0.92, 1.08)
    decl = rng.uniform(0.10, 0.32)
    f0 = speaker.f0_base * base_scale * (1.1 - decl * frac) * (
        1.0 + 0.03 * np.sin(2 * np.pi * (4.5 + rng.rand()) * secs))
    # word spans (split at sp/sil) -> accent + amplitude factors
    word_accent = np.ones(total)
    word_amp = {}
    w_start, w_idx = 0.0, 0
    pos_scan = 0.0
    for phone, dur in zip(phones, durations_s):
        pos_scan += dur
        if phone in ("sil", "sp", "spn", ""):
            a = int(round(w_start * sr))
            b = min(int(round(pos_scan * sr)), total)
            if b - a > 8:
                acc = rng.uniform(0.92, 1.22)
                span = np.linspace(0, np.pi, b - a)
                word_accent[a:b] *= 1.0 + (acc - 1.0) * np.sin(span)
            word_amp[w_idx] = rng.uniform(0.75, 1.2)
            w_start, w_idx = pos_scan, w_idx + 1
    f0 = f0 * word_accent
    wav = np.zeros(total)
    intervals = []
    pos = 0.0
    widx = 0
    for phone, dur in zip(phones, durations_s):
        a = int(round(pos * sr))
        b = min(int(round((pos + dur) * sr)), total)
        n = b - a
        intervals.append((pos, pos + dur, phone))
        pos += dur
        if n <= 0:
            continue
        if phone in ("sil", "sp", "spn", ""):
            seg = 0.002 * rng.randn(n)
        elif phone in VOWELS:
            f1, f2 = VOWELS[phone]
            seg = _formant_voice(
                n, sr, f0[a:b],
                (f1 * speaker.tract_scale, f2 * speaker.tract_scale), rng)
            seg *= 0.35 / (np.std(seg) + 1e-9)
        else:
            centre, bw, voiced = CONSONANTS.get(phone, (3000, 2500, False))
            seg = _bandpass_noise(n, sr, centre * speaker.tract_scale, bw,
                                  rng)
            seg *= 0.12 / (np.std(seg) + 1e-9)
            if voiced:
                vseg = _formant_voice(n, sr, f0[a:b],
                                      (400 * speaker.tract_scale, centre),
                                      rng)
                seg = 0.5 * seg + 0.3 * vseg / (np.std(vseg) + 1e-9) * 0.35
        # per-word energy variation (the energy predictor's signal)
        seg = seg * word_amp.get(widx, 1.0)
        if phone in ("sil", "sp", "spn", ""):
            widx += 1
        # 5 ms fade at both ends avoids clicks
        fade = min(n // 2, int(0.005 * sr))
        if fade > 0:
            env = np.ones(n)
            env[:fade] = np.linspace(0, 1, fade)
            env[-fade:] = np.linspace(1, 0, fade)
            seg = seg * env
        wav[a:b] = seg
    peak = np.max(np.abs(wav)) + 1e-9
    return (0.7 * wav / peak).astype(np.float32), intervals


def random_phrase(rng, n_words=(2, 5)):
    """CV(C) word salad over the Russian phone inventory + sp separators.

    Prosody richness: a per-utterance speaking-rate factor scales every
    duration, and one stressed syllable per word gets a lengthened vowel —
    duration structure correlated with phone position, as in real speech.
    """
    vowels = list(VOWELS)
    cons = list(CONSONANTS)
    rate = rng.uniform(0.8, 1.25)
    phones, durs = ["sil"], [float(rng.uniform(0.05, 0.12))]
    for w in range(rng.randint(*n_words)):
        syllables = rng.randint(1, 4)
        stressed = rng.randint(syllables)
        for s in range(syllables):
            phones.append(cons[rng.randint(len(cons))])
            durs.append(float(rng.uniform(0.04, 0.10)) * rate)
            phones.append(vowels[rng.randint(len(vowels))])
            v = float(rng.uniform(0.07, 0.18)) * rate
            durs.append(v * (1.45 if s == stressed else 1.0))
        if rng.rand() < 0.5:
            phones.append(cons[rng.randint(len(cons))])
            durs.append(float(rng.uniform(0.04, 0.09)) * rate)
        phones.append("sp")
        durs.append(float(rng.uniform(0.03, 0.08)))
    phones[-1] = "sil"
    durs[-1] = float(rng.uniform(0.06, 0.12))
    return phones, durs


def write_textgrid(path, intervals):
    total = intervals[-1][1] if intervals else 0.0
    lines = [
        'File type = "ooTextFile"', 'Object class = "TextGrid"', "",
        "xmin = 0", f"xmax = {total:.6f}", "tiers? <exists>", "size = 1",
        "item []:", "    item [1]:", '        class = "IntervalTier"',
        '        name = "phones"', "        xmin = 0",
        f"        xmax = {total:.6f}",
        f"        intervals: size = {len(intervals)}",
    ]
    for i, (a, b, p) in enumerate(intervals, 1):
        lines += [f"        intervals [{i}]:", f"            xmin = {a:.6f}",
                  f"            xmax = {b:.6f}",
                  f'            text = "{p}"']
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def generate_corpus(root, n_speakers=4, utts_per_speaker=40, sr=22050,
                    seed=0):
    """Write a full raw corpus tree; returns total audio seconds."""
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    total_s = 0.0
    for spk in default_speakers(n_speakers, seed=seed):
        d = os.path.join(root, spk.name)
        os.makedirs(d, exist_ok=True)
        for k in range(utts_per_speaker):
            phones, durs = random_phrase(rng)
            wav, intervals = synth_utterance(
                phones, durs, spk, sr=sr, seed=rng.randint(1 << 31))
            base = f"utt{k:04d}"
            wavfile.write(os.path.join(d, base + ".wav"), sr,
                          (wav * 32767).astype(np.int16))
            write_textgrid(os.path.join(d, base + ".TextGrid"), intervals)
            with open(os.path.join(d, base + ".lab"), "w") as f:
                f.write("синтетика\n")
            total_s += sum(durs)
    return total_s
