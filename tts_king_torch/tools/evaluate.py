"""Validation evaluation CLI of the port (scripts/evaluate.py's
counterpart): the teacher-forced losses of a checkpoint over a split and,
with ``--objective``, free-running objective metrics (MCD and duration MAE;
F0-RMSE and V/UV precision, recall and F1 where ``vocoder.weights_path``
names a vocoder, through it and YIN on the device).

    python -m tts_king_torch.tools.evaluate [config.yaml] [--restore-step N]
        [--split val.txt] [--objective] [--objective-utts 16]
        [--device cuda|cpu]

Prints one JSON object with the JAX script's keys: the loss terms, step,
num_utterances and, with ``--objective``, the metrics (null where not
finite).
"""

import argparse
import json
import os

import numpy as np
import torch


def objective_fns(cfg, device):
    """(vocode_fn, f0_fn) through the config's vocoder and YIN, or (None,
    None) where ``vocoder.weights_path`` names no file."""
    if not (cfg.vocoder.weights_path
            and os.path.exists(cfg.vocoder.weights_path)):
        return None, None
    from tts_king_torch.ops.f0 import yin_f0
    from tts_king_torch.pipeline import Vocoder

    voc = Vocoder(cfg, device=device)
    sr = cfg.preprocess.audio.sampling_rate
    hop = cfg.preprocess.stft.hop_length

    def vocode_fn(mel):
        # the float waveform in [-1, 1]: no int16 round trip
        return voc(mel[None].astype(np.float32))[0].float().cpu().numpy()

    def f0_fn(wav):
        y = torch.from_numpy(np.ascontiguousarray(wav[None])).to(voc.device)
        return yin_f0(y, sr, hop)[0].cpu().numpy()

    return vocode_fn, f0_fn


def evaluate_checkpoint(cfg, restore_step=None, split="val.txt",
                        objective=False, objective_utts=16, device="cuda"):
    """The report dict the CLI prints."""
    from tts_king_torch.data.dataset import FS2Dataset
    from tts_king_torch.models.fs2 import build_fastspeech2
    from tts_king_torch.pipeline import resolve_device
    from tts_king_torch.train.checkpoint import restore_train_state
    from tts_king_torch.train.evaluate import evaluate
    from tts_king_torch.train.state import TrainState
    from tts_king_torch.train.step import make_eval_step
    from tts_king_torch.utils.logging import LOSS_NAMES

    device = resolve_device(device)
    root = cfg.preprocess.preprocessed_path
    with open(os.path.join(root, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(root, "speakers.json")) as f:
        n_speakers = len(json.load(f))
    with torch.device("meta"):
        model = build_fastspeech2(cfg.model, stats, n_speakers)
    payload = restore_train_state(cfg.train.ckpt_path, restore_step)
    model = model.to_empty(device=device)
    model.load_state_dict(payload["model"], strict=True)
    state = TrainState(model, None, int(payload["step"]))

    ds = FS2Dataset(split, cfg.preprocess, cfg.train, drop_last=False,
                    apply_masking=False, max_mel_len=cfg.model.max_seq_len)
    losses = evaluate(make_eval_step(), state, ds, device)
    report = {name: round(float(v), 5)
              for name, v in zip(LOSS_NAMES, tuple(losses))}
    report["step"] = int(payload["step"])
    report["num_utterances"] = len(ds)

    if objective:
        from tts_king_torch.train.metrics import evaluate_objective

        vocode_fn, f0_fn = objective_fns(cfg, device)
        obj = evaluate_objective(model, ds, device, max_utts=objective_utts,
                                 vocode_fn=vocode_fn, f0_fn=f0_fn,
                                 max_mel_len=cfg.model.max_seq_len)
        report.update({k: (round(v, 4) if np.isfinite(v) else None)
                       for k, v in obj.items()})
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tts_king_torch.tools.evaluate",
        description="teacher-forced losses and objective metrics of a "
                    "checkpoint")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--restore-step", type=int, default=None)
    ap.add_argument("--split", default="val.txt")
    ap.add_argument("--objective", action="store_true",
                    help="also compute free-running MCD / duration MAE / "
                         "F0 metrics (train/metrics.py)")
    ap.add_argument("--objective-utts", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tts_king_torch.config import TTSConfig, load_config

    cfg = load_config(args.config) if args.config else TTSConfig()
    print(json.dumps(evaluate_checkpoint(
        cfg, args.restore_step, args.split, args.objective,
        args.objective_utts, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
