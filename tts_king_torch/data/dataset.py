"""FastSpeech2 training dataset and batcher.

Port of tts_king_tpu/data/dataset.py, single process. Batches are
collated by numpy, or by the native threaded .npy loader
(``use_native_loader``, native/npy_loader.cpp; by default where the native
library builds, as in the JAX package), which gives the same batches. The
feature-file layout and metadata format
are the reference's (fs_two/dataset.py): ``train.txt`` lines
``name|speaker|{phones}|raw``, per-utterance .npy files
``<spk>-{mel,energy,duration,pitch,cwt-pitch,pitch-mean,pitch-std}-<name>.npy``
(the pitch families under ``pitch/``, the others under a directory of their
own name), ``speakers.json`` for the id map.

The reference's sorted group batching (a DataLoader batch of
batch_size * group_size items, sorted by text length and sliced into
group_size real batches, fs_two/dataset.py:206-225) gives the
grad-accumulation superbatches of shape (acc, B, ...). Padded lengths are
quantized up to fixed steps, as in the JAX package, so the same utterances
make the same batches in both.

Grapheme masking is applied per epoch at batch assembly, keyed by (epoch
seed, item index), with the reference's two bugs fixed as in the JAX
package (the ``> 1`` gate that left a ratio of 0.15 dead,
fs_two/dataset.py:149, and the once-at-load application).

Data parallelism: ``shard=(rank, count)`` (rank = the process's dp index).
Every rank computes the same global batch plan (permutation, grouping,
sorting, masks and padded lengths, from the metadata and the .npy headers
alone) and loads the features of its own contiguous row block of each
microbatch only, so the blocks of all ranks make the unsharded batch.
"""

import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from tts_king_torch import native
from tts_king_torch.config import PreprocessConfig, TrainConfig
from tts_king_torch.text import text_to_sequence
from tts_king_torch.text.symbols import MASK, SILENCES

_SILENCE_NAMES = [s.replace("@", "") for s in SILENCES]

L_STEP = 16    # phoneme-length padding quantum
T_STEP = 64    # mel-length padding quantum


def random_mask(phones: List[str], max_masks_per_sentence: float,
                rng: np.random.RandomState) -> List[str]:
    """Replace ~ratio of non-silence tokens with the mask symbol
    (fs_two/dataset.py:14-29 semantics: sampled with replacement, silences
    skipped)."""
    n = len(phones)
    masks_count = int(max_masks_per_sentence * n)
    if masks_count == 0:
        return phones
    out = list(phones)
    for ind in rng.randint(0, n, size=masks_count):
        if out[ind] not in _SILENCE_NAMES:
            out[ind] = MASK
    return out


def _quantize(n, step, cap=None):
    q = ((n + step - 1) // step) * step
    return min(q, cap) if cap else q


class FS2Dataset:
    """Loads preprocessed features and yields padded (super)batches of numpy
    arrays."""

    def __init__(self, metadata_file: str, preprocess: PreprocessConfig,
                 train: TrainConfig, drop_last: bool = True,
                 max_mel_len: Optional[int] = 1000, apply_masking=None,
                 use_native_loader: Optional[bool] = None,
                 shard: tuple = (0, 1)):
        self.root = preprocess.preprocessed_path
        self.cleaners = list(preprocess.text_cleaners)
        self.batch_size = train.optimizer.batch_size
        self.group_size = train.optimizer.grad_acc_step
        self.mask_ratio = train.max_masks_per_sentence
        self.apply_masking = (self.mask_ratio > 0
                              if apply_masking is None else apply_masking)
        self.drop_last = drop_last
        self.max_mel_len = max_mel_len
        rank, count = shard
        if not (0 <= rank < count):
            raise ValueError(f"bad shard {shard}: need 0 <= rank < count")
        self.shard = (int(rank), int(count))
        self._mel_len_cache: Dict[tuple, int] = {}
        self.use_native_loader = (native.available()
                                  if use_native_loader is None
                                  else use_native_loader)

        self.meta = []
        with open(os.path.join(self.root, metadata_file), encoding="utf-8") as f:
            for line in f:
                line = line.strip("\n")
                if not line:
                    continue
                name, speaker, text, raw = line.split("|")
                self.meta.append((name, speaker, text, raw))
        with open(os.path.join(self.root, "speakers.json")) as f:
            self.speaker_map = json.load(f)

    def __len__(self):
        return len(self.meta)

    def _npy_path(self, kind, speaker, name):
        subdir = "pitch" if "pitch" in kind else kind
        return os.path.join(self.root, subdir, f"{speaker}-{kind}-{name}.npy")

    def _npy(self, kind, speaker, name):
        return np.load(self._npy_path(kind, speaker, name))

    def _entry(self, idx: int, mask_seed: Optional[int] = None):
        """(name, speaker, speaker_id, phoneme id sequence), metadata only.
        The masking RNG is keyed by (mask_seed, idx), so an item's masked
        sequence does not depend on the iteration order."""
        name, speaker, text, _raw = self.meta[idx]
        phones = text.strip("{}").split(" ")
        if self.apply_masking and mask_seed is not None:
            item_rng = np.random.RandomState(
                (int(mask_seed) * 1000003 + int(idx)) % (2**32 - 1))
            phones = random_mask(phones, self.mask_ratio, item_rng)
        seq = np.asarray(
            text_to_sequence("{" + " ".join(phones) + "}", self.cleaners),
            np.int32)
        return (name, speaker, np.int32(self.speaker_map[speaker]), seq)

    def _mel_len(self, speaker: str, name: str) -> int:
        """Mel frame count from the .npy header (mmap: no data read)."""
        key = (speaker, name)
        n = self._mel_len_cache.get(key)
        if n is None:
            n = int(np.load(self._npy_path("mel", speaker, name),
                            mmap_mode="r").shape[0])
            self._mel_len_cache[key] = n
        return n

    def _item_from_entry(self, entry) -> Dict[str, np.ndarray]:
        """Feature payloads of one metadata entry (keeps the entry's
        possibly masked phoneme sequence)."""
        name, speaker, sid, seq = entry
        duration = self._npy("duration", speaker, name).astype(np.int32)
        if len(seq) != len(duration):
            # text_to_sequence dropped symbols it does not know: phoneme i
            # would be paired with phoneme j's targets
            raise ValueError(
                f"{speaker}/{name}: phoneme sequence has {len(seq)} ids but "
                f"duration target has {len(duration)} — unknown symbols in "
                "the metadata phones were dropped by text_to_sequence")
        return {
            "id": name,
            "speaker": sid,
            "text": seq,
            "mel": self._npy("mel", speaker, name).astype(np.float32),
            "energy": self._npy("energy", speaker, name).astype(np.float32),
            "duration": duration,
            "pitch_raw": self._npy("pitch", speaker, name).astype(np.float32),
            "pitch_cwt": np.nan_to_num(
                self._npy("cwt-pitch", speaker, name).astype(np.float32)),
            "pitch_mean": self._npy("pitch-mean", speaker, name).astype(np.float32),
            "pitch_std": self._npy("pitch-std", speaker, name).astype(np.float32),
        }

    def _collate_native(self, entries, L: int, T: int):
        """Batch-load every feature family with the native threaded npy
        loader straight into the padded batch buffers (one C++ call per
        family instead of 7 np.load calls per item); the same batch as
        ``_collate``."""
        B = len(entries)
        names = [(spk, name) for (name, spk, _sid, _seq) in entries]

        def paths(kind):
            return [self._npy_path(kind, spk, name) for spk, name in names]

        def load(kind, rows, cols):
            arr, lens = native.load_npy_batch(paths(kind), rows, cols)
            if (lens < 0).any():
                # fail like the np.load path would — a silent all-zero row
                # would train on corrupt targets without a word
                bad = [names[i] for i in np.nonzero(lens < 0)[0]]
                raise FileNotFoundError(
                    f"failed to load {kind} for {bad[:3]}")
            return arr, lens

        mels, mel_lens = load("mel", T, 80)
        energies, _ = load("energy", L, 1)
        durations, dur_lens = load("duration", L, 1)
        pitches, _ = load("pitch", L, 1)
        cwt, _ = load("cwt-pitch", L, 11)
        pmean, _ = load("pitch-mean", 1, 1)
        pstd, _ = load("pitch-std", 1, 1)

        batch = {
            "speakers": np.asarray([sid for (_n, _s, sid, _q) in entries],
                                   np.int32),
            "texts": np.zeros((B, L), np.int32),
            "src_lens": np.zeros((B,), np.int32),
            "mels": mels,
            "mel_lens": mel_lens.astype(np.int32),
            "energies": energies[:, :, 0],
            "durations": durations[:, :, 0].astype(np.int32),
            "pitches_raw": pitches[:, :, 0],
            "pitches_cwt": np.nan_to_num(cwt),
            "pitches_mean": pmean[:, 0, 0],
            "pitches_std": pstd[:, 0, 0],
        }
        for b, (_name, _spk, _sid, seq) in enumerate(entries):
            l = min(len(seq), L)
            if min(int(dur_lens[b]), L) != l:
                # same contract as _item_from_entry: a shorter id sequence
                # means unknown symbols were silently dropped — refuse to
                # train on misaligned targets
                raise ValueError(
                    f"{names[b][0]}/{names[b][1]}: phoneme sequence has "
                    f"{len(seq)} ids but duration target has "
                    f"{int(dur_lens[b])} — unknown symbols in the metadata "
                    "phones were dropped by text_to_sequence")
            batch["texts"][b, :l] = seq[:l]
            batch["src_lens"][b] = l
        return batch

    def _collate(self, items: List[Dict[str, np.ndarray]], L: int, T: int):
        B = len(items)
        batch = {
            "speakers": np.zeros((B,), np.int32),
            "texts": np.zeros((B, L), np.int32),
            "src_lens": np.zeros((B,), np.int32),
            "mels": np.zeros((B, T, 80), np.float32),
            "mel_lens": np.zeros((B,), np.int32),
            "energies": np.zeros((B, L), np.float32),
            "durations": np.zeros((B, L), np.int32),
            "pitches_raw": np.zeros((B, L), np.float32),
            "pitches_cwt": np.zeros((B, L, 11), np.float32),
            "pitches_mean": np.zeros((B,), np.float32),
            "pitches_std": np.zeros((B,), np.float32),
        }
        for b, it in enumerate(items):
            l = min(len(it["text"]), L)
            t = min(it["mel"].shape[0], T)
            batch["speakers"][b] = it["speaker"]
            batch["texts"][b, :l] = it["text"][:l]
            batch["src_lens"][b] = l
            batch["mels"][b, :t] = it["mel"][:t]
            batch["mel_lens"][b] = t
            n = min(l, len(it["energy"]))
            batch["energies"][b, :n] = it["energy"][:n]
            batch["durations"][b, :n] = it["duration"][:n]
            batch["pitches_raw"][b, :n] = it["pitch_raw"][:n]
            c = min(l, it["pitch_cwt"].shape[0])
            batch["pitches_cwt"][b, :c] = it["pitch_cwt"][:c, :11]
            batch["pitches_mean"][b] = it["pitch_mean"]
            batch["pitches_std"][b] = it["pitch_std"]
        return batch

    def superbatches_per_epoch(self) -> int:
        """Superbatch count of one epoch: the batch plan depends on the
        metadata alone (train/loop.py derives the resume offset from it)."""
        group = self.batch_size * self.group_size
        full, tail = divmod(len(self.meta), group)
        if self.drop_last:
            return full
        return full + (1 if tail >= self.batch_size else 0)

    def _rows(self, entries, bs):
        """This shard's contiguous block of a batch's entries."""
        rank, count = self.shard
        if bs % count:
            raise ValueError(
                f"batch_size={bs} not divisible by shard count {count}")
        k = bs // count
        return entries[rank * k:(rank + 1) * k]

    def epoch_superbatches(self, seed: int = 0, start_batch: int = 0
                           ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield (acc, B, ...) superbatches for one epoch (B = batch_size
        // count on a shard: its rows of each microbatch).

        Groups of batch_size * group_size items are sorted by phoneme count
        (longest first) and sliced into ``group_size`` microbatches, padded
        jointly to quantized lengths. ``start_batch`` skips the first N
        superbatches of the epoch without loading their features, so a
        resumed run continues the epoch's data sequence.
        """
        bs = self.batch_size
        rng = np.random.RandomState(seed)
        order = rng.permutation(len(self.meta))
        group = bs * self.group_size
        emitted = 0
        for start in range(0, len(order) - (group - 1 if self.drop_last else 0),
                           group):
            idxs = order[start : start + group]
            if len(idxs) < group and self.drop_last:
                break
            entries = [self._entry(int(i), mask_seed=seed) for i in idxs]
            entries.sort(key=lambda e: -len(e[3]))
            micro = [entries[i * bs : (i + 1) * bs]
                     for i in range(len(entries) // bs)]
            micro = [m for m in micro if len(m) == bs]
            if not micro:
                continue
            if emitted < start_batch:   # plan-only fast-forward
                emitted += 1
                continue
            emitted += 1
            L = _quantize(max(len(e[3]) for m in micro for e in m), L_STEP)
            T = _quantize(max(self._mel_len(e[1], e[0])
                              for m in micro for e in m),
                          T_STEP, self.max_mel_len)
            micro = [self._rows(m, bs) for m in micro]
            if self.use_native_loader:
                collated = [self._collate_native(m, L, T) for m in micro]
            else:
                collated = [
                    self._collate([self._item_from_entry(e) for e in m], L, T)
                    for m in micro]
            yield {k2: np.stack([c[k2] for c in collated])
                   for k2 in collated[0]}

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Plain (B, ...) batches in metadata order (no accumulation axis),
        unmasked, for evaluation. A shard yields its row block of each
        batch and drops the ragged tail (every shard must see the same
        batches)."""
        bs = self.batch_size
        count = self.shard[1]
        for start in range(0, len(self.meta), bs):
            idxs = range(start, min(start + bs, len(self.meta)))
            if len(idxs) < bs and (self.drop_last or count > 1):
                break
            entries = [self._entry(i) for i in idxs]
            L = _quantize(max(len(e[3]) for e in entries), L_STEP)
            T = _quantize(max(self._mel_len(e[1], e[0]) for e in entries),
                          T_STEP, self.max_mel_len)
            if count > 1:
                entries = self._rows(entries, bs)
            yield self._collate([self._item_from_entry(e) for e in entries],
                                L, T)
