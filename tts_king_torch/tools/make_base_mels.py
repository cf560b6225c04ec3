"""Teacher-forced FastSpeech2 mels for HiFi-GAN fine-tuning.

Port of scripts/make_base_mels.py. The FS2 -> HiFi-GAN adaptation recipe
(the reference's fine_tuning mode, hifi/meldataset.py:88-175) trains the
vocoder on (ground-truth audio, acoustic-model mel) pairs, so that it
learns to vocode the acoustic model's own output. For every utterance of
the prepared corpus (train.txt, then val.txt) this runs FastSpeech2
teacher-forced (ground-truth durations, energy and raw pitch; a CWT model
its own pitch), so that the mel is frame-aligned with the audio, and
writes

  * ``<out>/mels/<spk>-<name>.npy``: the (T, n_mels) postnet mel;
  * ``<out>/wavs/<spk>-<name>.wav``: the matching ground-truth slice, int16,
    T * hop samples from the TextGrid's start mark (the window the
    feature pipeline used), zero-padded at the end where the audio is
    shorter.

The checkpoint is the port's own (train/checkpoint.py's ``train_state.pt``
under ``train.ckpt_path``). Batches are slices of ``batch_size``
utterances in metadata order, each sorted longest first and padded to the
batch loaders' quantized lengths, as the JAX script pads them.

    python -m tts_king_torch.tools.make_base_mels [config.yaml]
        [--ckpt-step N] [--out DIR] [--batch-size 16] [--device cuda|cpu]

Then fine-tune with ``python -m tts_king_torch.train.vocoder_loop cfg.yaml
--wavs-dir <out>/wavs --fine-tuning --mels-dir <out>/mels``.
"""

import argparse
import json
import os

import numpy as np
import torch


def make_base_mels(cfg, ckpt_step=None, out=None, batch_size=16,
                   device="cuda"):
    """Write the teacher-forced mels and the aligned ground-truth wavs;
    returns the output directory."""
    from scipy.io import wavfile

    from tts_king_torch.data.dataset import (L_STEP, T_STEP, FS2Dataset,
                                             _quantize)
    from tts_king_torch.data.features import get_alignment, load_wav
    from tts_king_torch.data.textgrid import read_textgrid
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.pipeline import resolve_device
    from tts_king_torch.train.checkpoint import restore_train_state
    from tts_king_torch.train.step import to_device

    device = resolve_device(device)
    pp = cfg.preprocess
    root = pp.preprocessed_path
    out_dir = out or os.path.join(root, "base_mels")
    os.makedirs(os.path.join(out_dir, "mels"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)

    with open(os.path.join(root, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(root, "speakers.json")) as f:
        n_speakers = len(json.load(f))
    with torch.device("meta"):
        model = build_fastspeech2(cfg.model, stats, n_speakers,
                                  pp.mel.n_mel_channels)
    payload = restore_train_state(cfg.train.ckpt_path, ckpt_step)
    model = model.to_empty(device=device)
    model.load_state_dict(payload["model"], strict=True)
    model.eval()
    print(f"restored FS2 step {payload['step']}", flush=True)
    use_cwt = cfg.model.use_cwt

    sr = pp.audio.sampling_rate
    hop = pp.stft.hop_length
    n_done = 0
    for metadata in ("train.txt", "val.txt"):
        ds = FS2Dataset(metadata, pp, cfg.train, drop_last=False,
                        apply_masking=False,
                        max_mel_len=cfg.model.max_seq_len)
        for start in range(0, len(ds.meta), batch_size):
            entries = [ds._entry(i) for i in
                       range(start, min(start + batch_size, len(ds.meta)))]
            # longest first: keeps each batch's padding tight
            entries.sort(key=lambda e: -len(e[3]))
            items = [ds._item_from_entry(e) for e in entries]
            L = _quantize(max(len(e[3]) for e in entries), L_STEP)
            T = _quantize(max(it["mel"].shape[0] for it in items), T_STEP,
                          cfg.model.max_seq_len)
            batch = ds._collate(items, L, T)
            b = to_device(batch, device)
            with torch.no_grad():
                mels = model(
                    b["speakers"], b["texts"], b["src_lens"], max_mel_len=T,
                    mel_lens=b["mel_lens"], energy_targets=b["energies"],
                    duration_targets=b["durations"],
                    pitch_raw_targets=None if use_cwt else b["pitches_raw"],
                )["postnet_mel"].float().cpu().numpy()
            for i, (name, spk, _sid, _seq) in enumerate(entries):
                n = int(batch["mel_lens"][i])
                base = f"{spk}-{name}"
                np.save(os.path.join(out_dir, "mels", base + ".npy"),
                        mels[i, :n])
                tg = read_textgrid(
                    os.path.join(pp.raw_path, spk, name + ".TextGrid"))
                _, _, t_start, _ = get_alignment(
                    tg.get_tier_by_name("phones"), sr, hop)
                wav = load_wav(os.path.join(pp.raw_path, spk, name + ".wav"),
                               sr)
                seg = wav[int(t_start * sr): int(t_start * sr) + n * hop]
                if len(seg) < n * hop:
                    seg = np.pad(seg, (0, n * hop - len(seg)))
                wavfile.write(os.path.join(out_dir, "wavs", base + ".wav"),
                              sr, (seg * 32767.0).astype(np.int16))
                n_done += 1
        print(f"{metadata}: done ({n_done} total)", flush=True)
    print(json.dumps({"out": out_dir, "utterances": n_done}))
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tts_king_torch.tools.make_base_mels",
        description="teacher-forced FastSpeech2 mels for vocoder "
                    "fine-tuning")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--ckpt-step", type=int, default=None,
                    help="checkpoint step under train.ckpt_path "
                         "(default: the latest)")
    ap.add_argument("--out", default=None,
                    help="output dir (default <preprocessed>/base_mels)")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tts_king_torch.config import TTSConfig, load_config

    cfg = load_config(args.config) if args.config else TTSConfig()
    make_base_mels(cfg, ckpt_step=args.ckpt_step, out=args.out,
                   batch_size=args.batch_size, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
