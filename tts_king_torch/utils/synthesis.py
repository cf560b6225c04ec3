"""Batch synthesis output helpers (tools.synth_samples equivalent,
fs_two/utils/tools.py:209-274): per-utterance mel plots and vocoded wav
files for a batch of FastSpeech2 outputs.

Port of tts_king_tpu/utils/synthesis.py. The plots need matplotlib: where
it does not import, the wavs are still written and one line on stderr says
that the plots were skipped.
"""

import json
import os
import sys
from typing import Sequence

import numpy as np
import torch

from tts_king_torch.ops.length_regulator import expand_values
from tts_king_torch.utils.plotting import (matplotlib_available, plot_mel,
                                           save_plot)

DEFAULT_PITCH_STATS = [-3, 9, 0, 1, -2, 6]


def host(x):
    """A tensor or array as numpy (floating tensors as f32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def pitch_stats_of(cfg):
    """[pitch min, max, mean, std, energy min, max] from the corpus's
    stats.json, or the defaults where there is none."""
    path = os.path.join(cfg.preprocess.preprocessed_path, "stats.json")
    if not os.path.exists(path):
        return list(DEFAULT_PITCH_STATS)
    with open(path) as f:
        st = json.load(f)
    return st["pitch"] + st["energy"][:2]


def skipped_plots(n, where):
    sys.stderr.write(f"[{where}] matplotlib is not installed: {n} mel "
                     "plot(s) skipped\n")


def synth_samples(outputs, basenames: Sequence[str], vocoder, cfg, path: str,
                  pitch_stats=None):
    """outputs: FastSpeech2 output dict (tensors or arrays); vocoder:
    pipeline.Vocoder or None. Writes ``<path>/<base>.png`` (where
    matplotlib imports) and ``<path>/<base>.wav`` (with a vocoder)."""
    os.makedirs(path, exist_ok=True)
    hop = cfg.preprocess.stft.hop_length
    sr = cfg.preprocess.audio.sampling_rate

    mel_lens = host(outputs["mel_lens"])
    if matplotlib_available():
        src_lens = host(outputs["src_lens"])
        postnet = host(outputs["postnet_mel"])
        pitch = torch.from_numpy(host(outputs["pitch_prediction"]))
        energy = torch.from_numpy(host(outputs["energy_prediction"]))
        durations = torch.from_numpy(
            host(outputs["duration_rounded"]).astype(np.int64))
        stats = pitch_stats or pitch_stats_of(cfg)
        for i, base in enumerate(basenames):
            n = int(mel_lens[i])
            sl = int(src_lens[i])
            d = durations[i:i + 1, :sl]
            p = expand_values(pitch[i:i + 1, :sl], d, max(n, 1))[0, :n]
            e = expand_values(energy[i:i + 1, :sl], d, max(n, 1))[0, :n]
            save_plot(plot_mel([(postnet[i, :n].T, p.numpy(), e.numpy())],
                               stats, ["Synthesized"]),
                      os.path.join(path, f"{base}.png"))
    else:
        skipped_plots(len(basenames), "synth_samples")

    if vocoder is not None:
        from scipy.io import wavfile

        wavs = vocoder.generate(outputs["postnet_mel"],
                                lengths=mel_lens * hop)
        for wav, base in zip(wavs, basenames):
            wavfile.write(os.path.join(path, f"{base}.wav"), sr, wav)
