"""One run of one cell: what every entry shares.

``run_cell`` finds the cell's configuration, traffic, limits and entry by
the names in BENCHMARK.json, hands the entry a ``Run``, and turns what the
entry reports into the result line: the end-to-end metrics (untraced run)
or the per-layer metrics and the device's busy time (traced run), and the
comparison's numbers beside their limits.

A cell's parts are files found by name, so a cell is added by adding files:
  configs/<config>.json        the configuration as it is run
  programs/<family>.py         the program's side of its vocoder family
                               (core/program.py); <family> is the config's
                               model.vocoder_model, lower-case, letters and
                               digits only ("HiFi-GAN" -> hifigan)
  reference/<family>.py        the family's plain reference, FLOPs, weight
                               rules and CPU-test widths
                               (reference/vocoders.py)
  traffic/<traffic>.json       the traffic's parameters; "entry" names
  entries/<entry>.py           the code that drives that kind of traffic
  limits/<workload>.json       the limit of each number compared ("limits"),
                               and the controls that must fail them
                               ("controls", tests/test_bench_control.py)
  metrics/<metric>.py          a per-layer metric's reader
"""

import contextlib
import importlib.util
import json
import math
import os
import sys
import time

from benchmark.core import env

TRACE_FILE = os.path.join(env.CHECKOUT, "build", "bench_trace.json")


def load_json(*parts):
    with open(os.path.join(env.BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_module(kind, name):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(env.BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest():
    with open(os.path.join(env.CHECKOUT, "BENCHMARK.json")) as f:
        return json.load(f)


def find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def metrics_of(entries, workload):
    """The metrics of ``entries`` that ``workload`` reports."""
    return [m for m in entries if workload in m.get("workloads", [workload])]


class Run:
    """What an entry gets: the cell's files, the seed, the device, and the
    window's bookkeeping (set-up time, the measured window, host ranges
    for the traced run)."""

    def __init__(self, config, traffic, seed, seconds, trace, device,
                 t_start):
        self.config, self.traffic = config, traffic
        self.seed, self.seconds = seed, seconds
        self.trace, self.device, self.t_start = trace, device, t_start
        self.setup_s = None
        self.window_s = None
        self.device_info = None
        self.records = {}     # what the per-layer readers read
        self._profiler = None

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_step(self, name):
        """Note on standard error how far set-up has come (seconds since
        the process started), so that set-up's parts can be told apart."""
        self.sync()
        print(f"setup {name}: {time.time() - self.t_start:.3f} s",
              file=sys.stderr)

    def setup_done(self):
        """Set-up ends: everything is loaded and warmed up."""
        self.sync()
        self.setup_s = time.time() - self.t_start

    @contextlib.contextmanager
    def window(self):
        """The measured window; traced when the run is. Yields a clock that
        gives the seconds since the window opened. The card's memory peak
        is reset as it opens, so that the peak read is the window's."""
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.__enter__()
        if self.device.type == "cuda":
            import torch

            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        with self.range("bench.window"):
            yield lambda: time.perf_counter() - t0
            self.sync()
        self.window_s = time.perf_counter() - t0
        if self._profiler is not None:
            self._profiler.__exit__(None, None, None)
            os.makedirs(os.path.dirname(TRACE_FILE), exist_ok=True)
            self._profiler.export_chrome_trace(TRACE_FILE)
            self._profiler = None

    def range(self, name):
        """A host range the traced run's readers can attribute work to."""
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def read_device(self):
        """Take the device's record, its memory peak with it; call it once
        the window has closed and before the reference runs."""
        self.device_info = env.device_record(self.device)


def judge(numbers, limits):
    """Each number compared beside its limit, and whether all hold (a
    number that is not finite fails)."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        holds = (value is not None and math.isfinite(value)
                 and value <= limit)
        ok = ok and holds
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def run_cell(workload, seed, seconds, trace, device, t_start,
             config_file=None, traffic_overrides=None):
    """One run of ``workload``. ``config_file`` (default: the cell's) and
    ``traffic_overrides`` (keys replaced in the cell's traffic) let the
    tests drive a small configuration on the CPU."""
    bench = manifest()
    cell = find(bench["workloads"], workload, "workload")
    config = load_json(config_file or os.path.join(
        "configs", f"{cell['config']}.json"))
    traffic = dict(load_json("traffic", f"{cell['traffic']}.json"),
                   **(traffic_overrides or {}))
    limits = load_json("limits", f"{workload}.json")["limits"]
    run = Run(config, traffic, seed, seconds, trace, device, t_start)
    entry = load_module("entries", traffic["entry"])
    out = entry.run(run)
    correct, checks = judge(out["numbers"], limits)
    if trace:
        from benchmark.core.trace import Trace

        tr = Trace(TRACE_FILE)
        os.remove(TRACE_FILE)
        run.records["trace"] = tr
        metrics = {}
        for m in metrics_of(bench["per_layer"], workload):
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        run.device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_device_ops(),
                     "idle_gaps": tr.idle_gaps()}
    else:
        values = dict(out["end_to_end"], setup_s=run.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench["end_to_end"], workload)}
        breakdown = None
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": run.device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
