"""A vocoder family, a configuration and a cell are added by new files alone.

In a copy of the benchmark, a family under a new ``vocoder_model`` name
("Copy-GAN 3", family ``copygan3``) gets a program file that builds the
port's HiFi-GAN Generator and a reference file that delegates to
``reference/hifigan.py`` and fixes one tensor by a weight rule; a
configuration, a cell on the HiFi-GAN cell's traffic and its limits are
added beside them. The cell runs through the copy's ``harness.run_cell`` on
the CPU at the tests' widths and is correct, the rule's tensor holds the
rule's value in the program, and no file the copy had before has changed."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.core import env, harness
from benchmark.tests import micro

PROGRAM_FILE = '''"""A copy of HiFi-GAN's program side under another name."""
from benchmark.programs import hifigan

PROGRAM_NAME = "HiFi-GAN"


def vocoder_config(v):
    return hifigan.vocoder_config(v)


def generator(tc, v):
    from tts_king_torch.models.hifigan import Generator

    return Generator(tc.vocoder)
'''

REFERENCE_FILE = '''"""HiFi-GAN's reference under another name, with conv_post's bias fixed."""
import torch

from benchmark.reference import hifigan

generate = hifigan.generate
flops_per_frame = hifigan.flops_per_frame
MICRO = hifigan.MICRO
WEIGHT_RULES = {r"conv_post\\.bias": lambda z: torch.full_like(z, 0.125)}
'''


def file_hashes(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def add_family(checkout):
    """The new files, and the new entries of the copy's BENCHMARK.json."""
    bench_dir = os.path.join(checkout, "benchmark")
    base = micro.configs("hifigan")[0]
    base_cell = next(w for w in harness.manifest()["workloads"]
                     if w["config"] == base)

    def write(rel, text):
        with open(os.path.join(bench_dir, rel), "x") as f:
            f.write(text)

    write("programs/copygan3.py", PROGRAM_FILE)
    write("reference/copygan3.py", REFERENCE_FILE)
    cfg = harness.load_json("configs", f"{base}.json")
    cfg["name"], cfg["model"]["vocoder_model"] = "fs2_copygan3", "Copy-GAN 3"
    write("configs/fs2_copygan3.json", json.dumps(cfg))
    write("limits/copygan3_bulk_bf16.json", json.dumps(
        harness.load_json("limits", f"{base_cell['name']}.json")))
    path = os.path.join(checkout, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append(dict(
        next(c for c in bench["configs"] if c["name"] == base),
        name="fs2_copygan3", file="benchmark/configs/fs2_copygan3.json"))
    bench["workloads"].append(dict(base_cell, name="copygan3_bulk_bf16",
                                   config="fs2_copygan3"))
    with open(path, "w") as f:
        json.dump(bench, f)


RUN = """
import json, pathlib, sys, time
sys.path.append(sys.argv[1])        # the program, from the repository
import torch
from benchmark.core import harness, program
from benchmark.tests import micro

built = []
build = program.build


def kept(*args, **kwargs):
    built.append(build(*args, **kwargs))
    return built[-1]


program.build = kept
res = harness.run_cell(
    "copygan3_bulk_bf16", 2 ** 31 + 29, 0.5, False, torch.device("cpu"),
    time.time(), config_file=micro.config_file(pathlib.Path(sys.argv[2]),
                                               "fs2_copygan3"),
    traffic_overrides=micro.TRAFFIC)
(_, vocoder), = built
print(json.dumps({"correct": res["correct"], "checks": res["checks"],
                  "attempted": res["attempted"], "bias": sorted(set(
                      vocoder.model.conv_post.bias.float().tolist()))}))
"""


def test_a_family_is_added_by_new_files_alone(tmp_path):
    """The copy's harness runs the new cell in a process of its own, whose
    ``benchmark`` package is the copy."""
    checkout = tmp_path / "checkout"
    shutil.copytree(env.BENCH_DIR, checkout / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(env.CHECKOUT, "BENCHMARK.json"), checkout)
    before = file_hashes(checkout / "benchmark")
    add_family(str(checkout))
    proc = subprocess.run(
        [sys.executable, "-c", RUN, env.CHECKOUT, str(tmp_path)],
        cwd=checkout, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert res["bias"] == [0.125]
    after = file_hashes(checkout / "benchmark")
    assert {k: after.get(k) for k in before} == before
