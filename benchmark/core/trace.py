"""Reading torch.profiler's trace of a measured window.

The profiler (CUPTI) records every kernel, copy and memset the card ran,
each with the correlation id of the host call that launched it, and the
host's ranges (``record_function``) and operators. From these:

  * busy time: the union of the device's intervals (kernels, copies and
    memsets together, so overlapping work is counted once);
  * device time under a host range: the device work launched while that
    range was open on the host; work whose launch the trace does not show
    (a library that launches through an untraced path) is given to the
    range whose own device work brackets it, as one stream runs in order;
  * the breakdown: the device operations that took most time, and the idle
    gaps of the device summed by what the host was doing meanwhile.

All times are in microseconds on the trace's clock unless a name says _s.
"""

import bisect
import json
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation", "python_function"}


def merge(intervals):
    """Sorted, non-overlapping union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clipped_length(merged, lo, hi):
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


class Trace:
    """A chrome-trace JSON export of one profiled window."""

    def __init__(self, path, window_range="bench.window"):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.device_ops, launches, self.host = [], {}, []
        self.ranges = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args", {})
            if cat in DEVICE_CATS:
                self.device_ops.append((ts, ts + dur, e["name"],
                                        args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = ts
            elif cat in HOST_CATS:
                self.host.append((ts, ts + dur, e["name"], e.get("tid")))
                if cat == "user_annotation":
                    self.ranges[e["name"]].append((ts, ts + dur))
        self.launch_ts = [launches.get(c) for *_, c in self.device_ops]
        if not self.ranges.get(window_range):
            raise ValueError(f"the trace holds no {window_range!r} range")
        self.window = self.ranges[window_range][0]
        self.busy = merge([(s, e) for s, e, *_ in self.device_ops])

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self):
        """Seconds in the window in which the device ran anything."""
        return clipped_length(self.busy, *self.window) * 1e-6

    def ops_matching(self, patterns):
        """Device operations whose name contains any of ``patterns``, in
        the window: [(start, end, name)]."""
        lo, hi = self.window
        return [(s, e, n) for s, e, n, _ in self.device_ops
                if s >= lo and e <= hi and any(p in n for p in patterns)]

    def range_device_s(self, name):
        """Seconds of device work launched under the host range ``name``,
        summed over the range's instances (each instance's ops as a union),
        and the number of instances. Work with no traced launch inside a
        range's device-side bracket counts for that range."""
        spans = sorted(self.ranges.get(name, []))
        if not spans:
            return None, 0
        starts = [s for s, _ in spans]
        owned = defaultdict(list)
        unowned = []
        for (s, e, _, _), ts in zip(self.device_ops, self.launch_ts):
            if ts is None:
                unowned.append((s, e))
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                owned[i].append((s, e))
        total = 0.0
        for i, ops in owned.items():
            lo = min(s for s, _ in ops)
            hi = max(e for _, e in ops)
            ops = ops + [(s, e) for s, e in unowned if s >= lo and e <= hi]
            total += sum(e - s for s, e in merge(ops))
        return total * 1e-6, len(spans)

    def top_device_ops(self, n=10):
        """The ``n`` device operations (by name) that took most time in the
        window: [[name, seconds]]."""
        by_name = defaultdict(float)
        lo, hi = self.window
        for s, e, name, _ in self.device_ops:
            if s >= lo and e <= hi:
                by_name[name] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v * 1e-6] for k, v in top]

    def idle_gaps(self, n=10):
        """The device's idle time in the window summed by what the host was
        doing in the middle of each gap (its innermost range or operator
        under its outermost one): [[name, seconds]], the ``n`` largest."""
        lo, hi = self.window
        edges = [lo] + [x for s, e in self.busy for x in (s, e)] + [hi]
        host = sorted(h for h in self.host if h[2] != "bench.window")
        by_activity = defaultdict(float)
        active, nxt = [], 0
        for gs, ge in zip(edges[0::2], edges[1::2]):
            gs, ge = max(gs, lo), min(ge, hi)
            if ge <= gs:
                continue
            mid = 0.5 * (gs + ge)
            while nxt < len(host) and host[nxt][0] <= mid:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[1] >= mid]
            around = active
            if around:
                outer = min(around, key=lambda h: h[0])
                inner = max(around, key=lambda h: h[0])
                name = (outer[2] if outer is inner
                        else f"{outer[2]} > {inner[2]}")
            else:
                name = "host outside any traced call"
            by_activity[_short(name)] += ge - gs
        top = sorted(by_activity.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-6] for k, v in top]


def _short(name, limit=160):
    return name if len(name) <= limit else name[:limit - 3] + "..."
