"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic, entry,
limits and per-layer metrics are found by the names in BENCHMARK.json
(benchmark/core/harness.py). It loads and warms up (set-up), measures for
``--seconds``, compares what the measured window produced with the plain
reference (benchmark/reference/), and prints the numbers compared beside
their limits as the last lines of standard error and one JSON object as the
last line of standard output. ``--trace 1`` profiles the window and reports
the per-layer metrics instead of the end-to-end ones.

It exits with an error and prints no result where the cell's CUDA cards are
missing (it never falls back to the CPU), and where a JAX module was loaded.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.core import env  # noqa: E402


def main(argv=None):
    t_start = env.process_start_time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    env.fix_cache_dirs()
    env.sys_path()

    from benchmark.core import harness

    cell = harness.find(harness.manifest()["workloads"], args.workload,
                        "workload")
    reason = env.cuda_guard(cell["chips"])
    if reason is not None:
        print(f"benchmark: {reason}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    env.float32_exact()
    print(f"benchmark: {env.nvidia_smi_line()}", file=sys.stderr)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              t_start)
    banned = env.banned_loaded()
    if banned:
        print(f"benchmark: modules that no run may load were loaded: "
              f"{', '.join(banned)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
