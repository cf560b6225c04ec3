"""Objective TTS metrics on FREE-RUNNING synthesis (no teacher forcing).

Port of tts_king_tpu/train/metrics.py, the metrics the training loop logs:
the same numpy code, with the port's FastSpeech2 in eval mode as the
forward. The reference's evaluation reports teacher-forced losses only
(fs_two/evaluate.py:18-54); these are computed against the prepared
corpus's ground-truth features:

  * MCD (dB)        — mel-cepstral distortion over a DTW alignment of the
                      free-running mel vs the GT mel (lengths differ because
                      durations are predicted);
  * duration MAE    — |predicted − GT| frames per phoneme.

The JAX package's F0-RMSE and V/UV metrics need a vocoder and an F0
tracker (its scripts/evaluate.py); they are not ported yet.
"""

from typing import Dict, Optional

import numpy as np

MCD_K = 10.0 * np.sqrt(2.0) / np.log(10.0)


def mel_cepstra(mel: np.ndarray, n_coeffs: int = 13) -> np.ndarray:
    """(T, n_mels) log-mel -> (T, n_coeffs) cepstra (DCT-II, c0 dropped —
    c0 is overall energy, excluded from MCD by convention)."""
    T, M = mel.shape
    k = np.arange(1, n_coeffs + 1)
    basis = np.cos(np.pi * k[:, None] * (2 * np.arange(M) + 1)[None, :]
                   / (2.0 * M))            # (n_coeffs, M)
    return mel @ basis.T * np.sqrt(2.0 / M)


def dtw_path(cost: np.ndarray):
    """Classic DTW over a (T1, T2) cost matrix -> list of (i, j) pairs.

    Anti-diagonal sweep: every cell on diagonal d=i+j depends only on
    diagonals d-1 and d-2, so each diagonal is ONE vectorized update —
    O(T1+T2) Python iterations instead of O(T1*T2) (a row-sequential
    inner loop blocked the training loop for seconds per val utterance
    at max_seq_len-scale mels)."""
    T1, T2 = cost.shape
    acc = np.full((T1 + 1, T2 + 1), np.inf)
    acc[0, 0] = 0.0
    for d in range(2, T1 + T2 + 1):
        i = np.arange(max(1, d - T2), min(T1, d - 1) + 1)
        j = d - i
        # acc[i, j] = cost + min(acc[i-1, j], acc[i-1, j-1], acc[i, j-1]);
        # all three reads are on earlier diagonals — no aliasing
        acc[i, j] = cost[i - 1, j - 1] + np.minimum(
            np.minimum(acc[i - 1, j], acc[i, j - 1]), acc[i - 1, j - 1])
    # backtrack
    path = []
    i, j = T1, T2
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        moves = ((acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1))
        _, i, j = min(moves, key=lambda t: t[0])
    path.reverse()
    return path


def mcd_dtw(mel_pred: np.ndarray, mel_gt: np.ndarray, n_coeffs: int = 13):
    """MCD in dB between two (T, n_mels) log-mels of different lengths.
    Returns (mcd_db, path)."""
    c1 = mel_cepstra(np.asarray(mel_pred, np.float64), n_coeffs)
    c2 = mel_cepstra(np.asarray(mel_gt, np.float64), n_coeffs)
    # pairwise euclidean distances
    d2 = (np.sum(c1 * c1, 1)[:, None] + np.sum(c2 * c2, 1)[None, :]
          - 2.0 * c1 @ c2.T)
    dist = np.sqrt(np.maximum(d2, 0.0))
    path = dtw_path(dist)
    ii = np.fromiter((p[0] for p in path), np.int64)
    jj = np.fromiter((p[1] for p in path), np.int64)
    return float(MCD_K * np.mean(dist[ii, jj])), path


def duration_mae(d_pred: np.ndarray, d_gt: np.ndarray) -> float:
    """Mean |pred − GT| frames per phoneme (arrays trimmed to real length)."""
    n = min(len(d_pred), len(d_gt))
    if n == 0:
        return float("nan")
    return float(np.mean(np.abs(np.asarray(d_pred[:n], np.float64)
                                - np.asarray(d_gt[:n], np.float64))))


def evaluate_objective(model, dataset, device, max_utts: int = 16,
                       max_mel_len: Optional[int] = None) -> Dict[str, float]:
    """Free-running synthesis over the first `max_utts` val utterances ->
    mean objective metrics.

    model: the port's FastSpeech2 (put in eval mode here); dataset:
    FS2Dataset (val split, apply_masking=False).
    """
    import torch

    from tts_king_torch.data.dataset import L_STEP, _quantize

    model.eval()
    mcds, dur_maes = [], []
    n = min(len(dataset.meta), max_utts)
    for idx in range(n):
        item = dataset._item_from_entry(dataset._entry(idx))
        seq = item["text"]
        L = _quantize(len(seq), L_STEP)
        texts = np.zeros((1, L), np.int32)
        texts[0, : len(seq)] = seq
        with torch.no_grad():
            out = model(torch.tensor([int(item["speaker"])], device=device),
                        torch.from_numpy(texts).to(device),
                        torch.tensor([len(seq)], dtype=torch.int32,
                                     device=device),
                        max_mel_len=max_mel_len)
        T = int(out["mel_lens"][0])
        if T < 2:
            continue
        mel_pred = out["postnet_mel"][0, :T].float().cpu().numpy()
        mel_gt = item["mel"]
        mcds.append(mcd_dtw(mel_pred, mel_gt)[0])
        dur_maes.append(duration_mae(
            out["duration_rounded"][0, : len(seq)].cpu().numpy(),
            item["duration"]))

    return {
        "n_utts": float(len(mcds)),
        "mcd_db": float(np.mean(mcds)) if mcds else float("nan"),
        "duration_mae_frames": (float(np.mean(dur_maes)) if dur_maes
                                else float("nan")),
    }
