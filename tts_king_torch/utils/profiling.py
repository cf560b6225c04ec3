"""Tracing and profiling hooks (port of tts_king_tpu/utils/profiling.py).

* ``span(name, ident=None)``: a named host range around a layer's work
  (a ``record_function`` range), on the same clock as the card's kernels
  in the profiler's trace, with ``ident`` (a batch's or a request's id) as
  its one recorded input. While no profiler runs it is a shared null
  context: one read of a process-wide flag, no allocation, no lock.
* ``trace(log_dir)``: a ``torch.profiler`` trace of the block (host ops and
  spans of every thread, each op's input shapes and each span's id, and the
  card's kernels where CUDA is present) written to ``<log_dir>/trace.json``
  (chrome://tracing, Perfetto); a no-op where the profiler cannot start.
* ``force(x)``: completes the work behind a tree of tensors by fetching a
  checksum to the host.
* ``timed(fn, *args)``: mean wall seconds per call, completion forced.
* ``roofline(fn, *args)``: operations (``FlopCounterMode``) and bytes (each
  tensor argument read once, each output written once) of one call, their
  floors at the card's peaks and which one binds, with the JAX function's
  fields (``t_mxu_ms`` is the floor on the tensor cores here).
* ``device_record(device)``: what a measurement ran on (the card's name,
  and nvidia-smi's name and power limit).
"""

import contextlib
import os
import subprocess
import time
from typing import Callable, Dict

import torch
from torch.autograd import profiler as _autograd_profiler

# Dense peaks of an H100 SXM (data sheet): tensor-core operations per
# second by input dtype (f32 as TF32 would round it is not counted: f32 is
# the CUDA cores' rate) and HBM3 bytes per second.
PEAK_OPS = {"H100": {torch.bfloat16: 989e12, torch.float16: 989e12,
                     torch.float32: 67e12}}
PEAK_HBM_BYTES = {"H100": 3.35e12}


_OFF = contextlib.nullcontext()


def span(name: str, ident=None):
    """A host range named ``name`` around the block while a profiler runs
    (the null context otherwise), with ``ident`` (an int: a batch's or a
    request's id) as its one recorded input."""
    # set while any torch profiler runs, on every thread; the thread-local
    # torch.autograd._profiler_enabled() reads False on threads other than
    # the one that started the profiler, so it cannot gate spans made there
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, () if ident is None else (ident,))


class _Span:
    """A record_function range entered through the profiler's entry that
    takes inputs: a profiler that records inputs (``trace``) writes the id
    into the event's "Concrete Inputs", which record_function's string
    ``args`` never reach, and its enter and exit cost the host about half
    of record_function's."""

    __slots__ = ("_args", "_handle")

    def __init__(self, name, inputs):
        self._args = (name,) + inputs

    def __enter__(self):
        self._handle = torch.autograd._record_function_with_args_enter(
            *self._args)

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self._handle)


def _all_threads():
    """The profiler's setting that records every thread's ranges and
    operators (the default records only the thread that starts it), or
    None where the installed torch has no such setting."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler trace of the block, every thread's spans and ops
    with their inputs, into ``<log_dir>/trace.json``; a no-op where the
    profiler cannot start. The trace is kept in memory while the block
    runs and written when it ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=True,
                   experimental_config=_all_threads())
    try:
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def force(x):
    """Complete the work behind a tree of tensors by fetching a scalar
    checksum (the sum of every numeric tensor's magnitudes)."""
    return sum(float(t.detach().abs().double().sum())
               for t in _tensors(x) if t.dtype != torch.bool)


def timed(fn: Callable, *args, iters: int = 5, warmup: int = 1):
    """Mean wall seconds per call, completion forced."""
    for _ in range(warmup):
        force(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        force(fn(*args))
    return (time.perf_counter() - t0) / iters


def _card(args):
    """(device name, peak table key or None) of the first tensor
    argument's device."""
    dev = next((t.device for t in _tensors(args)), torch.device("cpu"))
    if dev.type != "cuda":
        return dev.type, None
    name = torch.cuda.get_device_name(dev)
    return name, next((k for k in PEAK_OPS if k in name), None)


def roofline(fn, *args, measured_s=None):
    """Roofline of one call: its operations (FlopCounterMode: 2 per
    multiply-add of the matrix products and convolutions), its bytes (each
    tensor argument read once, each output written once), the floors at
    the card's peaks for the inputs' dtype, and which one binds. Values are
    None where no peak is known (the CPU)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        out = fn(*args)
    flops = float(counter.get_total_flops()) or None
    bytes_ = float(sum(t.numel() * t.element_size()
                       for t in list(_tensors(args)) + list(_tensors(out))
                       )) or None
    kind, key = _card(args)
    dtype = next((t.dtype for t in _tensors(args) if t.is_floating_point()),
                 torch.float32)
    peak_f = PEAK_OPS[key].get(dtype) if key else None
    peak_b = PEAK_HBM_BYTES.get(key) if key else None
    t_mxu = flops / peak_f if (flops and peak_f) else None
    t_hbm = bytes_ / peak_b if (bytes_ and peak_b) else None
    result = {
        "device": kind,
        "gflops": round(flops / 1e9, 2) if flops else None,
        "hbm_gbytes": round(bytes_ / 1e9, 3) if bytes_ else None,
        "arith_intensity": (round(flops / bytes_, 1) if (flops and bytes_)
                            else None),
        "t_mxu_ms": round(t_mxu * 1e3, 3) if t_mxu else None,
        "t_hbm_ms": round(t_hbm * 1e3, 3) if t_hbm else None,
        "bound": (("mxu" if t_mxu >= t_hbm else "hbm")
                  if (t_mxu and t_hbm) else None),
    }
    if measured_s is not None:
        result["measured_ms"] = round(measured_s * 1e3, 3)
        if t_mxu or t_hbm:
            floor = max(t_mxu or 0.0, t_hbm or 0.0)
            result["roofline_fraction"] = round(floor / measured_s, 3)
    return result


def device_record(device) -> Dict:
    """What a measurement ran on: the device, and on a card its name and
    ``nvidia-smi --query-gpu=name,power.limit`` line (None where nvidia-smi
    does not run), since a card set below its power limit runs slower."""
    device = torch.device(device)
    out = {"device": str(device), "kind": None, "nvidia_smi": None}
    if device.type == "cuda":
        out["kind"] = torch.cuda.get_device_name(device)
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60, check=True)
            out["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            pass
    return out
