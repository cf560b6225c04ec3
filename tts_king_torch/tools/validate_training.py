"""FastSpeech2 training-dynamics validation on a synthetic speech-like
corpus.

Port of scripts/validate_training.py. It drives the whole stack: a
formant-synthesized multi-speaker corpus (data/synthetic.generate_corpus)
-> the Preprocessor's features -> train() of a half-size FastSpeech2 (2
encoder and 4 decoder layers at d = 128) with its validation and its
free-running objective metrics -> the summary of the loss curves. The
check is the curves' shape: the train loss drops steeply, mel, duration
and pitch all improve, the validation loss does not diverge. The summary
has the JAX script's keys and criterion strings (SUMMARY_SCHEMA 2), plus
the device it ran on (the card's name and power limit) and the wall time.

    python -m tts_king_torch.tools.validate_training [--steps 2000]
        [--utts 50] [--speakers 4] [--batch-size 8] [--grad-acc 2]
        [--root DIR] [--out results/torch_training_validation.json]
        [--corpus synthetic|prepared] [--device cuda|cpu]

``--corpus prepared`` trains on raw/ under ``--root`` as already built
from the reference tree's real Russian wavs (scripts/prepare_real_micro.py);
the reference tree is not part of this repository, so without that raw/
it raises.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# Bump when the summary's fields or criteria change (the JAX script's
# definitions: skill-score criterion, objective_improved needs MCD down and
# duration_skill > 0).
SUMMARY_SCHEMA = 2
CRITERION = ("objective_improved: mcd_db_last < mcd_db_first and "
             "duration_skill > 0 (skill = (naive-last)/(naive-floor), "
             "floor = per-symbol-median MAE, naive = global-median MAE)")


def validation_config(root, steps, batch_size, grad_acc, corpus,
                      log_step=50, val_step=250):
    """The JAX script's half-size model and schedule (log every 50 steps,
    validation and objective metrics every 250, no previews or checkpoints
    before the end); real utterances (~820 frames) need the 1024 cap."""
    from tts_king_torch.config import (ModelConfig, OptimizerConfig,
                                       PreprocessConfig, StepConfig,
                                       TrainConfig, TransformerConfig,
                                       TTSConfig, VariancePredictorConfig)

    pp = PreprocessConfig(raw_path=os.path.join(root, "raw"),
                          preprocessed_path=os.path.join(root, "processed"),
                          val_size=16)
    return TTSConfig(
        exp_name="validate",
        preprocess=pp,
        model=ModelConfig(
            transformer=TransformerConfig(
                encoder_layer=2, encoder_head=2, encoder_hidden=128,
                variance_hidden=128, decoder_layer=4, decoder_head=2,
                decoder_hidden=128, conv_filter_size=512),
            variance_predictor=VariancePredictorConfig(filter_size=128),
            max_seq_len=1024 if corpus == "prepared" else 512),
        train=TrainConfig(
            ckpt_path=os.path.join(root, "ckpt"),
            result_path=os.path.join(root, "result"),
            optimizer=OptimizerConfig(batch_size=batch_size,
                                      grad_acc_step=grad_acc,
                                      warm_up_step=400),
            step=StepConfig(total_step=steps, log_step=log_step,
                            synth_step=10 ** 9, val_step=val_step,
                            save_step=10 ** 9)))


def prepare_corpus(cfg, corpus, speakers, utts, device):
    """Generate the synthetic corpus (or find the prepared raw/) and its
    features, unless the features are there already."""
    from tts_king_torch.data.features import Preprocessor
    from tts_king_torch.data.synthetic import generate_corpus

    pp = cfg.preprocess
    if os.path.isdir(pp.preprocessed_path):
        return
    if corpus == "prepared":
        if not os.path.isdir(pp.raw_path):
            raise SystemExit(
                f"--corpus prepared: no raw/ under "
                f"{os.path.dirname(pp.raw_path)}; it is built from the "
                "reference tree's real wavs by scripts/prepare_real_micro.py,"
                " and the reference tree is not part of this repository")
    else:
        os.makedirs(pp.raw_path, exist_ok=True)
        sec = generate_corpus(pp.raw_path, n_speakers=speakers,
                              utts_per_speaker=utts, seed=0)
        print(f"corpus: {speakers} speakers x {utts} utts, "
              f"{sec / 60:.1f} min audio", flush=True)
    Preprocessor(pp, batch_size=16, device=device).build_from_path()


def duration_baselines(cfg, max_utts=16):
    """(floor, naive) duration-MAE baselines on the validation utterances
    the objective metrics score: floor = the per-symbol median fit on the
    train split (the best a text-conditioned predictor can do when
    durations are i.i.d. given the symbol), naive = one global median."""
    from tts_king_torch.data.dataset import FS2Dataset

    tr = FS2Dataset("train.txt", cfg.preprocess, cfg.train,
                    apply_masking=False)
    va = FS2Dataset("val.txt", cfg.preprocess, cfg.train,
                    apply_masking=False)
    per_sym, alld = {}, []
    for idx in range(min(len(tr.meta), 400)):
        item = tr._item_from_entry(tr._entry(idx))
        for s, d in zip(item["text"], item["duration"]):
            per_sym.setdefault(int(s), []).append(float(d))
            alld.append(float(d))
    med = {s: float(np.median(v)) for s, v in per_sym.items()}
    gmed = float(np.median(alld))
    fl, nv = [], []
    for idx in range(min(len(va.meta), max_utts)):
        item = va._item_from_entry(va._entry(idx))
        d = np.asarray(item["duration"], np.float64)
        pred = np.array([med.get(int(s), gmed) for s in item["text"]])
        fl.append(float(np.mean(np.abs(pred - d))))
        nv.append(float(np.mean(np.abs(gmed - d))))
    return float(np.mean(fl)), float(np.mean(nv))


def read_curves(metrics_path):
    """The train, val and objective rows of the loop's metrics JSONL."""
    curve, val_curve, obj_curve = [], [], []
    with open(metrics_path) as f:
        for line in f:
            m = json.loads(line)
            if m.get("phase") == "train":
                curve.append({"step": m["step"], "total": m["total"],
                              "mel": m["mel"], "duration": m["duration"],
                              "pitch": m["pitch"]})
            elif m.get("phase") == "val":
                val_curve.append({"step": m["step"], "total": m["total"],
                                  "mel": m["mel"]})
            elif m.get("phase") == "objective":
                obj_curve.append({"step": m["step"], "mcd_db": m["mcd_db"],
                                  "duration_mae_frames":
                                      m["duration_mae_frames"]})
    return curve, val_curve, obj_curve


def summarize(cfg, corpus, steps, curve, val_curve, obj_curve):
    """The JAX script's summary of the curves."""
    first, last = curve[0], curve[-1]
    summary = {
        "schema": SUMMARY_SCHEMA,
        "criterion": CRITERION,
        "corpus": corpus,
        "steps": steps,
        "train_total_first": round(first["total"], 3),
        "train_total_last": round(last["total"], 3),
        "total_drop_ratio": round(first["total"] / max(last["total"], 1e-9),
                                  2),
        "mel_first": round(first["mel"], 3),
        "mel_last": round(last["mel"], 3),
        "duration_first": round(first["duration"], 3),
        "duration_last": round(last["duration"], 3),
        "val_total_last": (round(val_curve[-1]["total"], 3)
                           if val_curve else None),
        "monotone_val": bool(all(
            b["total"] <= a["total"] * 1.15
            for a, b in zip(val_curve, val_curve[1:])))
        if len(val_curve) > 1 else None,
    }
    if obj_curve:
        # The synthetic corpus draws per-phone durations i.i.d. and scales
        # them by a per-utterance rate that the phoneme ids do not show, so
        # free-running duration MAE has a floor (the per-symbol median);
        # the skill score against the two text-blind baselines is what can
        # improve here.
        floor_mae, naive_mae = duration_baselines(cfg)
        last_mae = obj_curve[-1]["duration_mae_frames"]
        skill = (naive_mae - last_mae) / max(naive_mae - floor_mae, 1e-9)
        summary.update({
            "mcd_db_first": round(obj_curve[0]["mcd_db"], 2),
            "mcd_db_last": round(obj_curve[-1]["mcd_db"], 2),
            "duration_mae_first": round(
                obj_curve[0]["duration_mae_frames"], 3),
            "duration_mae_last": round(last_mae, 3),
            "duration_mae_floor": round(floor_mae, 3),
            "duration_mae_naive": round(naive_mae, 3),
            # 0 = no better than a global constant, 1 = at the floor
            "duration_skill": round(skill, 3),
            "objective_improved": bool(
                obj_curve[-1]["mcd_db"] < obj_curve[0]["mcd_db"]
                and skill > 0.0),
        })
    return summary


def validate_training(steps=2000, speakers=4, utts=50, root=None,
                      out="results/torch_training_validation.json",
                      batch_size=8, grad_acc=2, corpus="synthetic",
                      device="cuda", log_step=50, val_step=250):
    """Run the validation; write ``out`` (summary, curves, the device and
    the wall time) and return the summary. ``log_step`` and ``val_step``
    (the JAX script's 50 and 250) thin out the curves of a short run."""
    from tts_king_torch.pipeline import resolve_device
    from tts_king_torch.train.loop import train
    from tts_king_torch.utils.profiling import device_record

    device = resolve_device(device)
    root = root or os.path.join(tempfile.gettempdir(), "tts_validate")
    t0 = time.perf_counter()
    cfg = validation_config(root, steps, batch_size, grad_acc, corpus,
                            log_step, val_step)
    prepare_corpus(cfg, corpus, speakers, utts, device)
    # the logger appends: a stale file of an earlier run under the same
    # root would prepend its rows to the curve
    metrics = os.path.join(cfg.train.result_path, "validate.metrics.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)
    train(cfg, max_steps=steps, device=device)
    curves = read_curves(metrics)
    summary = summarize(cfg, corpus, steps, *curves)
    record = {"summary": summary, "train_curve": curves[0],
              "val_curve": curves[1], "objective_curve": curves[2],
              "device": device_record(device),
              "wall_s": time.perf_counter() - t0}
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--speakers", type=int, default=4)
    ap.add_argument("--utts", type=int, default=50, help="per speaker")
    ap.add_argument("--root", default=None,
                    help="working directory (default: a directory under "
                         "the system's temporary directory)")
    ap.add_argument("--out", default="results/torch_training_validation.json")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--grad-acc", type=int, default=2)
    ap.add_argument("--corpus", default="synthetic",
                    choices=["synthetic", "prepared"],
                    help="prepared = raw/ under --root already built from "
                         "the reference tree's real wavs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    summary = validate_training(
        steps=args.steps, speakers=args.speakers, utts=args.utts,
        root=args.root, out=args.out, batch_size=args.batch_size,
        grad_acc=args.grad_acc, corpus=args.corpus, device=args.device)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
