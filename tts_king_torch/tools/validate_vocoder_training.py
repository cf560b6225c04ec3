"""HiFi-GAN training-dynamics validation on a synthetic speech-like corpus.

Port of scripts/validate_vocoder_training.py: train a half-width HiFi-GAN
(upsample_initial_channel 256; 512 is the paper's) from its initial weights
on formant-synthesized speech (data/synthetic.generate_corpus) with
train_vocoder, and summarize the loss curve. The check is its shape: the
mel L1 drops, the adversarial and discriminator terms stay alive (no
collapse to 0, no divergence), every loss is finite. The summary has the
JAX script's keys and criterion strings (SUMMARY_SCHEMA 2), plus the device
it ran on (the card's name and power limit) and the wall time.

    python -m tts_king_torch.tools.validate_vocoder_training [--steps 2000]
        [--channels 256] [--batch-size 16] [--dtype f32|bf16]
        [--root DIR] [--out results/torch_vocoder_training_validation.json]
        [--corpus synthetic|reference] [--device cuda|cpu]

``--corpus reference`` trains on the real Russian speech of the reference
tree's ``examples/`` (its root in ``TTS_REFERENCE_ROOT``); the reference
tree is not part of this repository, so without it the tool raises.
"""

import argparse
import dataclasses
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

SUMMARY_SCHEMA = 2
CRITERION = ("mel_improved: tail-decile mean mel_l1 < head-decile mean; "
             "disc_alive: tail disc > 0.05; adv_alive: tail adv > 0.05; "
             "all losses finite")


def corpus_wavs(corpus, root, speakers, utts):
    """The training wavs: the synthetic corpus under ``root`` (generated
    once), or the reference tree's examples."""
    if corpus == "reference":
        ref = os.environ.get("TTS_REFERENCE_ROOT")
        wavs = (sorted(glob.glob(os.path.join(ref, "examples", "*.wav")))
                if ref else [])
        if not wavs:
            raise SystemExit(
                "--corpus reference reads the reference tree's examples/*.wav"
                f" (TTS_REFERENCE_ROOT={ref!r}): none found; the reference "
                "tree is not part of this repository")
        print(f"corpus: {len(wavs)} real wavs", flush=True)
        return wavs
    from tts_king_torch.data.synthetic import generate_corpus

    raw = os.path.join(root, "raw")
    if not os.path.isdir(raw):
        os.makedirs(raw, exist_ok=True)
        sec = generate_corpus(raw, n_speakers=speakers,
                              utts_per_speaker=utts, seed=0)
        print(f"corpus: {sec / 60:.1f} min audio", flush=True)
    return sorted(glob.glob(os.path.join(raw, "*", "*.wav")))


def read_curve(metrics_path):
    curve = []
    with open(metrics_path) as f:
        for line in f:
            m = json.loads(line)
            if m.get("phase") == "vocoder":
                curve.append({k: m[k] for k in
                              ("step", "disc", "gen", "mel_l1", "fm", "adv")})
    return curve


def summarize(curve, steps, channels, dtype, corpus, n_wavs, batch_size):
    """The JAX script's summary: head and tail deciles of the curve."""
    k = max(len(curve) // 10, 1)
    head, tail = curve[:k], curve[-k:]

    def mean(rows, key):
        return float(np.mean([r[key] for r in rows]))

    finite = all(all(np.isfinite(v) for v in r.values()) for r in curve)
    return {
        "schema": SUMMARY_SCHEMA,
        "criterion": CRITERION,
        "steps": steps,
        "channels": channels,
        "compute_dtype": dtype,
        "corpus": corpus,
        "n_wavs": n_wavs,
        "batch_size": batch_size,
        "mel_l1_first": round(mean(head, "mel_l1"), 3),
        "mel_l1_last": round(mean(tail, "mel_l1"), 3),
        "mel_l1_drop_ratio": round(
            mean(head, "mel_l1") / max(mean(tail, "mel_l1"), 1e-9), 2),
        "disc_first": round(mean(head, "disc"), 3),
        "disc_last": round(mean(tail, "disc"), 3),
        "adv_last": round(mean(tail, "adv"), 3),
        "fm_last": round(mean(tail, "fm"), 3),
        "all_finite": bool(finite),
        "mel_improved": bool(mean(tail, "mel_l1") < mean(head, "mel_l1")),
        # collapse signatures: the discriminator driven to ~0 (it won) or
        # the adversarial term ~0 (the generator fools nothing)
        "disc_alive": bool(0.05 < mean(tail, "disc")),
        "adv_alive": bool(mean(tail, "adv") > 0.05),
    }


def validate_vocoder_training(
        steps=2000, channels=256, batch_size=16, speakers=4, utts=40,
        root=None, out="results/torch_vocoder_training_validation.json",
        log_every=25, dtype="f32", corpus="synthetic", device="cuda"):
    """Run the validation; write ``out`` (summary, curve, the device and
    the wall time) and return the summary."""
    import torch

    from tts_king_torch.config import TTSConfig
    from tts_king_torch.pipeline import resolve_device
    from tts_king_torch.train.vocoder_loop import train_vocoder
    from tts_king_torch.utils.profiling import device_record

    device = resolve_device(device)
    root = root or os.path.join(tempfile.gettempdir(), "tts_validate_voc")
    t0 = time.perf_counter()
    wavs = corpus_wavs(corpus, root, speakers, utts)
    cfg = TTSConfig(exp_name="validate_voc")
    cfg.train = dataclasses.replace(
        cfg.train, ckpt_path=os.path.join(root, "ckpt"),
        result_path=os.path.join(root, "result"))
    cfg.vocoder = dataclasses.replace(
        cfg.vocoder, upsample_initial_channel=channels,
        batch_size=batch_size)
    # the logger appends: a stale file of an earlier run under the same
    # root would prepend its rows to the curve
    metrics = os.path.join(cfg.train.result_path,
                           "validate_voc_vocoder.metrics.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)
    train_vocoder(cfg, wavs, max_steps=steps, log_every=log_every,
                  save_every=max(steps, 1), use_mesh=False,
                  compute_dtype=torch.bfloat16 if dtype == "bf16" else None,
                  device=device)
    curve = read_curve(metrics)
    summary = summarize(curve, steps, channels, dtype, corpus, len(wavs),
                        batch_size)
    record = {"summary": summary, "curve": curve,
              "device": device_record(device),
              "wall_s": time.perf_counter() - t0}
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--channels", type=int, default=256,
                    help="upsample_initial_channel (512 = paper size)")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--speakers", type=int, default=4)
    ap.add_argument("--utts", type=int, default=40, help="per speaker")
    ap.add_argument("--root", default=None,
                    help="working directory (default: a directory under "
                         "the system's temporary directory)")
    ap.add_argument("--out",
                    default="results/torch_vocoder_training_validation.json")
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                    help="the GAN step's conv dtype")
    ap.add_argument("--corpus", default="synthetic",
                    choices=["synthetic", "reference"],
                    help="reference = the reference tree's real speech")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    summary = validate_vocoder_training(
        steps=args.steps, channels=args.channels,
        batch_size=args.batch_size, speakers=args.speakers, utts=args.utts,
        root=args.root, out=args.out, log_every=args.log_every,
        dtype=args.dtype, corpus=args.corpus, device=args.device)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
