"""HiFi-GAN training data (hifi/meldataset.py's counterpart).

Port of tts_king_tpu/data/mel_dataset.py. Crops are bit-identical to the JAX
package's: the file order shuffled by ``random.Random(seed)``, each batch's
order by ``random.Random(batch seed)``, one crop RNG per item,
``random.Random(seed * 1_000_003 + start + j)`` (a pure function of the
epoch position, so a sharded run crops as an unsharded one), clips shorter
than a segment zero-padded. The mels are computed per batch by the port's
``hifigan_mel`` on ``device`` (the loss mel at ``mel_fmax_loss or
mel_fmax``, and the input mel only when that differs from ``mel_fmax``).
``fine_tuning=True`` reads ``<base_mels_path>/<name>.npy`` (an acoustic
model's mels, (frames, mels) or (mels, frames)) and crops the wav aligned
with it, with the JAX package's pad and clamp rules.

Batches are dicts of tensors on ``device`` (the card unless the caller
asks for the CPU): "mel" (B, frames, mels), "wav"
(B, segment_size) and "mel_loss" (B, frames, mels).
"""

import os
import random
from typing import List, Optional

import numpy as np
import torch

from tts_king_torch.config import VocoderModelConfig
from tts_king_torch.data.features import load_wav
from tts_king_torch.ops.stft import hifigan_mel
from tts_king_torch.pipeline import resolve_device


class MelDataset:
    def __init__(self, wav_paths: List[str], cfg: VocoderModelConfig,
                 fine_tuning: bool = False,
                 base_mels_path: Optional[str] = None, seed: int = 1234,
                 shuffle: bool = True, device="cuda"):
        self.paths = list(wav_paths)
        if shuffle:
            random.Random(seed).shuffle(self.paths)
        self.cfg = cfg
        self.fine_tuning = fine_tuning
        self.base_mels_path = base_mels_path
        self.device = resolve_device(device)
        self.fmax = cfg.mel_fmax
        self.fmax_loss = cfg.mel_fmax_loss
        self.frames_per_seg = cfg.segment_size // cfg.hop_size

    def __len__(self):
        return len(self.paths)

    def _mel(self, wav, fmax):
        """(B, T) float32 numpy -> (B, frames, mels) on the device."""
        c = self.cfg
        y = torch.from_numpy(np.ascontiguousarray(wav)).to(self.device)
        return hifigan_mel(y, c.n_fft, c.num_mels, c.sampling_rate,
                           c.hop_size, c.win_size, c.mel_fmin, fmax)

    def _segment(self, wav, rng):
        seg = self.cfg.segment_size
        if len(wav) >= seg:
            start = rng.randint(0, len(wav) - seg)
            return wav[start : start + seg]
        return np.pad(wav, (0, seg - len(wav)))

    def _load_segment(self, idx: int, rng: random.Random):
        """(wav segment, base mel or None): the aligned crop, no
        spectrogram."""
        cfg = self.cfg
        wav = load_wav(self.paths[idx], cfg.sampling_rate)
        if not self.fine_tuning:
            return self._segment(wav, rng).astype(np.float32), None
        base = os.path.splitext(os.path.basename(self.paths[idx]))[0]
        mel = np.load(os.path.join(self.base_mels_path, base + ".npy"))
        if mel.ndim == 2 and mel.shape[0] == cfg.num_mels:
            mel = mel.T
        if mel.shape[0] >= self.frames_per_seg:
            start = rng.randint(0, mel.shape[0] - self.frames_per_seg)
            mel = mel[start : start + self.frames_per_seg]
            wav = wav[start * cfg.hop_size :
                      (start + self.frames_per_seg) * cfg.hop_size]
        else:
            mel = np.pad(mel, ((0, self.frames_per_seg - mel.shape[0]),
                               (0, 0)))
        if len(wav) < cfg.segment_size:
            wav = np.pad(wav, (0, cfg.segment_size - len(wav)))
        wav = wav[: cfg.segment_size]
        return wav.astype(np.float32), mel.astype(np.float32)

    def _mels(self, wav_b, base_mels):
        """(mel, mel_loss) of a batch of equal-length segments."""
        mel_loss = self._mel(wav_b, self.fmax_loss or self.fmax)
        if base_mels is not None:
            mel = torch.from_numpy(np.stack(base_mels)).to(self.device)
        elif (self.fmax_loss or self.fmax) == self.fmax:
            mel = mel_loss   # the same transform: computed once
        else:
            mel = self._mel(wav_b, self.fmax)
        return mel, mel_loss

    def batches(self, batch_size: int, seed: int = 0, shard=None):
        """Yield batches of aligned (mel, wav, mel_loss) segments; the last
        partial batch is dropped.

        shard=(rank, nproc): this process's contiguous row block of every
        batch (rows rank*B/n .. (rank+1)*B/n), each item cropped by its own
        RNG, so the blocks of all ranks concatenate to the unsharded batch."""
        rank, nproc = shard if shard is not None else (0, 1)
        if batch_size % nproc:
            raise ValueError(f"batch_size={batch_size} not divisible by "
                             f"process count {nproc}")
        rows = slice((rank * batch_size) // nproc,
                     ((rank + 1) * batch_size) // nproc)
        order = list(range(len(self.paths)))
        random.Random(seed).shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idxs = order[start : start + batch_size][rows]
            # integer seeds only: a tuple or str seed would go through
            # hash(), randomized per process for str
            rngs = [random.Random(seed * 1_000_003 + start + j)
                    for j in range(batch_size)][rows]
            loaded = [self._load_segment(i, r) for i, r in zip(idxs, rngs)]
            wav_b = np.stack([w for w, _ in loaded])
            mel, mel_loss = self._mels(
                wav_b, [m for _, m in loaded] if self.fine_tuning else None)
            yield {"mel": mel, "wav": torch.from_numpy(wav_b).to(self.device),
                   "mel_loss": mel_loss}
