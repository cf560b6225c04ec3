"""BENCHMARK.json keeps the benchmark's contract: its keys, names, units and
lengths; every cell's files exist, its vocoder family's two among them;
every cell reports set-up, another end-to-end metric and a per-layer
metric; and every per-layer metric has its reader (and a kernel metric its
name patterns)."""

import json
import os
import re

import pytest

from benchmark.core.env import BENCH_DIR, CHECKOUT
from benchmark.reference import vocoders

with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(line(w) for w in BENCH["command"])
    assert all(p == "benchmark" or p.startswith("benchmark/")
               for p in BENCH["paths"])
    n = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, n // 4)


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        allowed = KEYS[section] | ({"workloads"} if section in (
            "end_to_end", "per_layer") else set())
        assert KEYS[section] <= set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert line(e[key]), (e["name"], key)


def test_cells_have_their_files_and_metrics():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert os.path.isfile(os.path.join(CHECKOUT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(CHECKOUT, c["file"])) as f:
            family = vocoders.family(json.load(f)["model"]["vocoder_model"])
        for side in ("programs", "reference"):
            assert os.path.isfile(os.path.join(BENCH_DIR, side,
                                               family + ".py")), (c, side)
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        for part in (("traffic", w["traffic"] + ".json"),
                     ("limits", w["name"] + ".json")):
            assert os.path.isfile(os.path.join(BENCH_DIR, *part))
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in BENCH["per_layer"])
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_per_layer_readers_and_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads")
        for w in m.get("workloads", []):
            assert moved is None or w in moved, (m["name"], w)
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
            assert os.path.isfile(os.path.join(BENCH_DIR, "kernels",
                                               m["name"] + ".json"))
