"""The comparison that decides a bulk run's ``correct``: each
sentence the check drew, run through the plain reference and held to what
the program produced for it.

Numbers (each the largest over the sentences, or a count over them, but
for wav_noise_ratio):
  log_duration_err, pitch_err, energy_err
                max |program - reference| of the variance predictions;
  duration_mismatch
                phonemes whose duration is not the rounding of the
                program's own log-duration (exact: limit 0);
  mel_err       max |program - reference| of the postnet mel over the
                sentence's frames, over max(1, max |reference|);
  wav_err       |program - reference| / |reference| (2-norms) of the int16
                waveform over the sentence's samples, the reference vocoder
                in float32;
  wav_noise_ratio
                where the configuration states a vocoder precision below
                float32: the energy of (program - float32 reference) over
                the energy of (reference in the stated precision - float32
                reference), int16 waveforms summed over all the sentences.
                A computation in the stated precision reads about 1 whatever
                the weights, though its rounding errors grow through the
                layers until two such computations differ as much as either
                differs from float32; a coarser one reads its excess error
                power (the int8 MRF path about 5);
  length_errors sentences whose frame count or sample count differs.
"""

import numpy as np
import torch

from benchmark.reference import fs2, vocoders


def sentences(cfg, precision, weights, records, device):
    """The numbers for ``records``: per sentence its inputs ("phonemes",
    "length", "speaker"), the program's choices and outputs
    ("log_duration", "duration", "pitch", "energy" at its phoneme padding,
    "mel_bucket" its FastSpeech2 mel length, "frames", "mel", "wav"), and
    the mel frames the vocoder ran on ("vocoder_frames"). ``weights``: the
    benchmark's (acoustic, vocoder) state dicts. FastSpeech2's reference
    computes in float32 on the variables as the configuration stores them,
    the vocoder's in float32 and, for ``wav_noise_ratio``, also in the
    precision the configuration states for it. Float32 products run with
    TF32 off, whatever the caller set."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _sentences(cfg, precision, weights, records, device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _sentences(cfg, precision, weights, records, device):
    p = cfg["precisions"][precision]
    model, v = cfg["model"], cfg["vocoder"]
    sd = fs2.round_variables(weights[0], p["acoustic_variables"])
    vocode = vocoders.find(model["vocoder_model"]).generate
    hop, scale = v["hop_size"], v["max_wav_value"]
    lower = p["vocoder"] != "float32"
    out = {"log_duration_err": 0.0, "pitch_err": 0.0, "energy_err": 0.0,
           "duration_mismatch": 0, "mel_err": 0.0, "wav_err": 0.0,
           "length_errors": 0}
    noise = [0.0, 0.0]   # sum (program - ref)^2, sum (stated - ref)^2
    with torch.no_grad():
        for rec in records:
            Lp = rec["duration"].shape[0]
            ph = np.zeros(Lp, np.int64)
            ph[:len(rec["phonemes"])] = rec["phonemes"]
            chosen = {k: rec[k].to(device) for k in
                      ("log_duration", "duration", "pitch", "energy")}
            mel, n, errs = fs2.fs2_sentence(
                sd, model, p["acoustic_variables"],
                cfg["assumed"]["stats"], torch.from_numpy(ph).to(device),
                rec["length"], rec["speaker"], chosen, rec["mel_bucket"])
            out["duration_mismatch"] += errs.pop("duration_mismatch")
            for k, e in errs.items():
                out[f"{k}_err"] = max(out[f"{k}_err"], e)
            wav = rec["wav"]
            if n != rec["frames"] or len(wav) != n * hop:
                out["length_errors"] += 1
                continue
            ref_mel = mel[:n].cpu()
            err = float((rec["mel"] - ref_mel).abs().max()) / max(
                1.0, float(ref_mel.abs().max()))
            out["mel_err"] = max(out["mel_err"], err)

            def int16_wav(prec):
                w = vocode(weights[1], v, mel[:rec["vocoder_frames"]], prec)
                return vocoders.to_int16(w[:n * hop], scale).cpu().double()

            ref = int16_wav("float32")
            got = torch.from_numpy(np.asarray(wav, np.float64))
            if got.shape != ref.shape:
                out["length_errors"] += 1
                continue
            denom = max(float(ref.norm()), 1.0)
            out["wav_err"] = max(out["wav_err"],
                                 float((got - ref).norm()) / denom)
            if lower:
                noise[0] += float(((got - ref) ** 2).sum())
                noise[1] += float(((int16_wav(p["vocoder"]) - ref) ** 2).sum())
    if lower:
        out["wav_noise_ratio"] = noise[0] / max(noise[1], 1.0)
    return out
