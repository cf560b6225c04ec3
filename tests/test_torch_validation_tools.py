"""The training-dynamics validation tools (tts_king_torch/tools/
validate_training.py and validate_vocoder_training.py, ports of
scripts/validate_training.py and scripts/validate_vocoder_training.py) on
the CPU: a few steps on a tiny synthetic corpus write a record whose
summary has the JAX scripts' keys, schema and criterion strings, with the
device and the wall time; the reference corpora, which are not part of the
repository, raise with a line saying so. The 2000-step runs are made on
the card (results/torch_*training_validation.json)."""

import importlib.util
import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    """A JAX validation script imported by file path (it imports the JAX
    package only inside main)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the keys the JAX scripts' summaries write, from their committed records
FS2_KEYS = set(json.load(open(os.path.join(
    REPO, "results", "training_validation.json")))["summary"])
VOC_KEYS = set(json.load(open(os.path.join(
    REPO, "results", "vocoder_training_validation.json")))["summary"])


def test_fs2_tool_writes_the_scripts_summary(tmp_path):
    from tts_king_torch.tools import validate_training as vt

    jax_script = _jax_script("validate_training")
    assert vt.SUMMARY_SCHEMA == jax_script.SUMMARY_SCHEMA
    assert vt.CRITERION == jax_script.CRITERION
    out = tmp_path / "fs2.json"
    summary = vt.validate_training(
        steps=2, speakers=2, utts=8, root=str(tmp_path / "run"),
        out=str(out), batch_size=2, grad_acc=1, device="cpu", log_step=1,
        val_step=2)
    record = json.load(open(out))
    # (the free-running MCD is NaN after 2 steps: no frames predicted yet)
    assert json.dumps(record["summary"]) == json.dumps(summary)
    assert set(summary) == FS2_KEYS
    assert summary["steps"] == 2 and summary["corpus"] == "synthetic"
    assert [r["step"] for r in record["train_curve"]] == [1, 2]
    assert [r["step"] for r in record["val_curve"]] == [2]
    assert len(record["objective_curve"]) == 1
    assert all(np.isfinite(r["total"]) for r in record["train_curve"])
    assert record["device"]["device"] == "cpu"
    assert record["device"]["nvidia_smi"] is None
    assert record["wall_s"] > 0
    # a corpus prepared from the reference tree, which is not here
    with pytest.raises(SystemExit, match="reference tree"):
        vt.validate_training(steps=1, root=str(tmp_path / "none"),
                             out=str(tmp_path / "x.json"),
                             corpus="prepared", device="cpu")


def test_vocoder_tool_writes_the_scripts_summary(tmp_path, monkeypatch):
    from tts_king_torch.tools import validate_vocoder_training as vv

    jax_script = _jax_script("validate_vocoder_training")
    assert vv.SUMMARY_SCHEMA == jax_script.SUMMARY_SCHEMA
    assert vv.CRITERION == jax_script.CRITERION
    out = tmp_path / "voc.json"
    summary = vv.validate_vocoder_training(
        steps=2, channels=16, batch_size=2, speakers=1, utts=3,
        root=str(tmp_path / "run"), out=str(out), log_every=1,
        device="cpu")
    record = json.load(open(out))
    assert record["summary"] == summary
    assert set(summary) == VOC_KEYS
    assert [r["step"] for r in record["curve"]] == [1, 2]
    assert summary["all_finite"] and summary["channels"] == 16
    assert summary["compute_dtype"] == "f32" and summary["n_wavs"] == 3
    assert record["device"]["device"] == "cpu" and record["wall_s"] > 0
    monkeypatch.delenv("TTS_REFERENCE_ROOT", raising=False)
    with pytest.raises(SystemExit, match="reference tree"):
        vv.validate_vocoder_training(steps=1, root=str(tmp_path / "none"),
                                     out=str(tmp_path / "x.json"),
                                     corpus="reference", device="cpu")
