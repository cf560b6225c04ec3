"""No card means no numbers; nothing runs without the program; every cache
lies inside the checkout; no source names a fixed path outside it."""

import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.core import env
from benchmark.tests import micro

ARGS = ["--workload", next(iter(micro.cells())), "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


def run_py(root):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=root, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ,
                                                CUDA_VISIBLE_DEVICES=""))


def assert_no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
    assert "metrics" not in proc.stdout


def test_no_cuda_card_exits_with_no_result():
    proc = run_py(env.CHECKOUT)
    assert_no_result(proc)
    assert "CUDA" in proc.stderr


def test_benchmark_alone_exits_with_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(os.path.join(env.CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(env.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert_no_result(run_py(tmp_path))


def test_caches_inside_the_checkout(monkeypatch):
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.delenv(k, raising=False)
    env.fix_cache_dirs()
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        assert os.environ[k].startswith(env.CHECKOUT + os.sep)


def test_no_fixed_paths_outside_the_checkout():
    for path in glob.glob(os.path.join(env.BENCH_DIR, "**", "*.py"),
                          recursive=True):
        if path == os.path.abspath(__file__):
            continue
        with open(path) as f:
            text = f.read()
        for fixed in ("/tmp", "/dev/shm", "/root", "/var/tmp"):
            assert f'"{fixed}' not in text and f"'{fixed}" not in text, path
