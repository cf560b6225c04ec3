"""The port's examples must run: each is started as a user would start it
(``python -m tts_king_torch.examples.<name> --micro --device cpu``) in a
subprocess and prints tests/test_examples.py's markers."""

import os
import subprocess
import sys

import pytest
from scipy.io import wavfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_example(name, *argv, timeout=120):
    proc = subprocess.run(
        [sys.executable, "-m", f"tts_king_torch.examples.{name}", "--micro",
         "--device", "cpu", *argv], cwd=REPO, capture_output=True,
        text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_serving_example_micro():
    out = _run_example("serving")
    assert "/tts -> 200" in out
    assert "/stream -> 200" in out
    assert "restarted server answered" in out
    assert out.rstrip().endswith("done")


def test_basic_usage_example_micro():
    out = _run_example("basic_usage")
    assert "valid frames" in out
    assert "served 3 requests" in out


def test_voice_over_example_micro(tmp_path):
    path = str(tmp_path / "vo.wav")
    out = _run_example("voice_over", "--line", "0|привет мир",
                       "--line", "1|тест", "--out", path)
    assert "2 lines" in out
    sr, track = wavfile.read(path)
    assert sr == 22050 and track.dtype.name == "int16" and len(track) > sr / 4


def test_examples_default_to_cuda():
    """Without --device the examples ask for the card, and fail where there
    is none; --time-shard names the parallelism slice."""
    import torch

    from tts_king_torch.examples import basic_usage, voice_over

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        basic_usage.main(["--micro"])
    with pytest.raises(NotImplementedError, match="parallelism"):
        voice_over.main(["--micro", "--line", "0|тест", "--time-shard"])
