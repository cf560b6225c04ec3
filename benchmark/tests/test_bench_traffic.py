"""The traffic generator is a function of the seed, keeps to its declared
ranges and gives every seed the same set of sizes; and nothing under
benchmark/ imports JAX or the JAX package (nor, under benchmark/reference,
the program)."""

import ast
import glob
import json
import os

import numpy as np
import pytest

from benchmark.core import traffic
from benchmark.core.env import BANNED_MODULES, BENCH_DIR

def load(path):
    with open(path) as f:
        return json.load(f)


ALL_TRAFFIC = sorted(glob.glob(os.path.join(BENCH_DIR, "traffic", "*.json")))
TRAFFIC_FILES = [p for p in ALL_TRAFFIC if load(p)["entry"] == "bulk"]


def first_batches(spec, seed, n):
    gen = traffic.bulk_batches(spec, seed, n_symbols=207, n_speakers=66)
    return [next(gen) for _ in range(n)]


@pytest.mark.parametrize("path", TRAFFIC_FILES)
def test_same_seed_same_traffic_other_seed_other(path):
    spec = load(path)
    seed = 2 ** 31 + 12345          # larger than 32 signed bits hold
    a, b = first_batches(spec, seed, 3), first_batches(spec, seed, 3)
    c = first_batches(spec, seed + 1, 3)
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(x[k], y[k])
    assert not all(np.array_equal(x["phonemes"], z["phonemes"])
                   for x, z in zip(a, c))


@pytest.mark.parametrize("path", TRAFFIC_FILES)
def test_lengths_ids_and_speakers_in_range(path):
    spec = load(path)
    ph = spec["phonemes"]
    pool = traffic.length_pool(spec)
    assert pool.min() >= ph["min"] and pool.max() <= ph["max"]
    assert abs(np.median(pool) - ph["median"]) <= 0.05 * ph["median"]
    for b in first_batches(spec, 7, 5):
        n = b["src_lens"]
        assert b["phonemes"].shape == (spec["batch"], n.max())
        for row, k in zip(b["phonemes"], n):
            assert (row[:k] >= 1).all() and (row[:k] < 207).all()
            assert (row[k:] == 0).all()
        assert ((b["speakers"] >= 0) & (b["speakers"] < 66)).all()


@pytest.mark.parametrize("path", TRAFFIC_FILES)
def test_every_seed_serves_the_same_sizes(path):
    """One pass over the pool is the same multiset of lengths under any
    seed, in another order."""
    spec = load(path)
    per_pass = spec["pool"] // spec["batch"]
    sizes = []
    for seed in (1, 2 ** 40 + 3):
        lens = np.concatenate([b["src_lens"] for b in
                               first_batches(spec, seed, per_pass)])
        sizes.append(lens)
    assert sorted(sizes[0]) == sorted(sizes[1])
    assert not np.array_equal(sizes[0], sizes[1])


def test_cut_batches_follow_the_given_longest():
    spec = load(TRAFFIC_FILES[0])
    gen = traffic.bulk_batches(spec, 3, 207, 66, streams=(4, 5),
                               longest=[40, 130])
    got = list(gen)
    assert [int(b["src_lens"].max()) for b in got] == [40, 130]
    assert [int(b["src_lens"][0]) for b in got] == [40, 130]


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


SOURCES = sorted(glob.glob(os.path.join(BENCH_DIR, "**", "*.py"),
                           recursive=True))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, BENCH_DIR) for p in SOURCES])
def test_no_jax_import(path):
    """Compared by whole top-level name: tts_king_torch is not
    tts_king_tpu."""
    tops = {m.split(".")[0] for m in imported_modules(path)}
    assert not tops & BANNED_MODULES
    if os.sep + "reference" + os.sep in path:
        assert "tts_king_torch" not in tops
        assert not any(m.startswith("benchmark.") and not m.startswith(
            "benchmark.reference") for m in imported_modules(path))


def test_the_guard_compares_whole_names():
    assert "tts_king_torch" not in BANNED_MODULES
    assert {"jax", "jaxlib", "flax", "optax", "tts_king_tpu"} <= BANNED_MODULES
