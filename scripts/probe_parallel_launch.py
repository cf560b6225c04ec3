#!/usr/bin/env python3
"""Where the time of chip_smoke.py's gloo launch goes, on one CUDA card.

Runs chip_smoke.py's ``phase_parallel_path`` up to its gloo launch (the
PAR_RANKS ranks running the parts' workers in turn on the one card), runs
that launch as ``--variant`` says and stops the phase there:

  * ``full``: the launch's task list as the phase builds it;
  * ``no_new``: the same without NEW_TASKS (the tp=2 step with
    attention_probs_bf16 and the CWT model over the ranks).

Beside the phase's set-up before the launch and the load average then,
each rank runs its tasks through ``timed_tasks``, which reports the rank's
start-up (from the parent's call of ``launch.run`` to the rank's first
task: spawn, imports, the arguments' unpickling, the process group), each
task's whole wall (its model builds included, where the task's own
``wall_s`` covers only the timed part) and the pickled size of its result,
and the return (from the rank's last task to ``launch.run``'s return: the
results through the queue, the join). Prints one JSON line. One variant
a process: the tasks write checkpoints into the phase's temporary
directory, and a second launch in it would resume from the first's.
``--repo DIR`` runs the package and chip_smoke.py of another checkout (a
parent's ``git archive``), for an A/B in one call:

    python3 scripts/probe_parallel_launch.py --repo build/parent
    python3 scripts/probe_parallel_launch.py --variant no_new
"""

import argparse
import json
import os
import pickle
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_TASKS = ("fs2_parallel_steps:bp", "dp_generate:cwt")


class _Stop(Exception):
    pass


def timed_tasks(rank, tasks):
    """chip_smoke.parallel_tasks with each task's wall and result size, under
    the key ``_probe``."""
    import chip_smoke

    entered = time.time()
    out, timing = {}, {}
    for name, spec in tasks:
        t0 = time.perf_counter()
        res = getattr(chip_smoke, name.split(":")[0])(rank, spec)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        nbytes = len(pickle.dumps(res, protocol=pickle.HIGHEST_PROTOCOL))
        timing[name] = {"s": wall, "result_mib": nbytes / 2**20,
                        "pickle_s": time.perf_counter() - t0}
        out[name] = res
    out["_probe"] = {"entered": entered, "tasks": timing, "left": time.time()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=REPO)
    ap.add_argument("--variant", choices=("full", "no_new"), default="full")
    args = ap.parse_args(argv)
    # the checkout in place of scripts/, whose profile.py would shadow the
    # standard library's profile module that torch imports
    sys.path[0] = os.path.abspath(args.repo)

    import torch

    import chip_smoke
    from tts_king_torch.ops.kernels import _build
    from tts_king_torch.parallel import launch

    if not torch.cuda.is_available():
        raise SystemExit("probe_parallel_launch: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    real_run = launch.run

    def run_variant(target, nprocs, run_args=(), **kw):
        sel = [t for t in run_args[0]
               if args.variant == "full" or t[0] not in NEW_TASKS]
        setup_s = time.perf_counter() - t_phase
        loadavg = os.getloadavg()
        t0 = time.perf_counter()
        args_mib = len(pickle.dumps(
            (sel,), protocol=pickle.HIGHEST_PROTOCOL)) / 2**20
        args_pickle_s = time.perf_counter() - t0
        start = time.time()
        t0 = time.perf_counter()
        ranks = real_run(timed_tasks, nprocs, (sel,), **kw)
        wall = time.perf_counter() - t0
        end = time.time()
        per_rank = [r["_probe"] for r in ranks]
        print(json.dumps({
            "probe": "parallel_launch", "repo": args.repo,
            "variant": args.variant, "ranks": nprocs,
            "tasks": [name for name, _ in sel], "wall_s": wall,
            "setup_s": setup_s, "loadavg_before": loadavg,
            "args_mib": args_mib, "args_pickle_s": args_pickle_s,
            "startup_s": [p["entered"] - start for p in per_rank],
            "tasks_s": [sum(t["s"] for t in p["tasks"].values())
                        for p in per_rank],
            "return_s": [end - p["left"] for p in per_rank],
            "task": {name: [p["tasks"][name] for p in per_rank]
                     for name, _ in sel},
            "build_s": build_s, "nvidia_smi": smi}), flush=True)
        raise _Stop

    launch.run = run_variant
    with tempfile.TemporaryDirectory() as tmp:
        t_phase = time.perf_counter()
        try:
            chip_smoke.phase_parallel_path(smi, tmp)
        except _Stop:
            pass
        else:
            raise SystemExit("probe_parallel_launch: the phase ran no launch")
        finally:
            launch.run = real_run


if __name__ == "__main__":
    main()
