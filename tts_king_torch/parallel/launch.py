"""Run a function on N fresh processes joined into one process group.

``run(target, nprocs, args)`` spawns ``nprocs`` interpreters (the spawn
start method: nothing of the parent's state, CUDA included, is inherited),
each of which joins a group over a store on a free localhost port
(lockstep.initialize), calls ``target(rank, *args)`` and sends back its
picklable result: pickled into a file of a temporary directory, whose path
goes through the queue (a result of gigabytes, chip_smoke.py's state dicts,
crosses a file faster than the queue's pipe;
scripts/probe_parallel_launch.py measures the return). The parent waits up
to ``timeout_s`` in all, kills every process still running then, and
raises if any rank failed, exited without a result or did not finish: a
hang cannot outlast the timeout.

For several ranks on one host: the tests' gloo ranks on the CPU, and
chip_smoke.py's two gloo ranks sharing one card. ``target`` must be a
module-level function of an importable module.
"""

import multiprocessing as mp
import os
import pickle
import queue
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(target, rank, nprocs, port, backend, threads, args, results,
            out_dir):
    try:
        import torch
        import torch.distributed as dist

        from tts_king_torch.parallel import lockstep

        if threads:
            torch.set_num_threads(threads)
        lockstep.initialize(f"127.0.0.1:{port}", nprocs, rank, backend,
                            timeout_s=300.0)
        try:
            out = target(rank, *args)
        finally:
            dist.destroy_process_group()
        path = os.path.join(out_dir, f"rank{rank}.pkl")
        with open(path, "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        results.put((rank, True, path))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run(target: Callable, nprocs: int, args: Sequence[Any] = (),
        timeout_s: float = 300.0, backend: str = "gloo",
        threads: int = 1) -> List[Any]:
    """Each rank's ``target(rank, *args)``, in rank order. ``threads``:
    torch's intra-op threads a rank (0 leaves torch's default)."""
    with tempfile.TemporaryDirectory(prefix="launch-") as out_dir:
        return _run(target, nprocs, args, timeout_s, backend, threads,
                    out_dir)


def _run(target, nprocs, args, timeout_s, backend, threads, out_dir):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(target, r, nprocs, port, backend, threads,
                               tuple(args), results, out_dir))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got, errors = {}, []
    try:
        while len(got) + len(errors) < nprocs:
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue.Empty:
                if time.monotonic() > deadline:
                    errors.append(f"timed out after {timeout_s:.0f} s with "
                                  f"ranks {sorted(got)} done")
                    break
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    # a rank died without a word (a crash): its peers would
                    # wait for it until the group's timeout
                    time.sleep(0.5)
                    if results.empty():
                        errors.append(
                            "ranks died without a result: " + ", ".join(
                                f"{procs.index(p)} (exit {p.exitcode})"
                                for p in dead))
                        break
                continue
            if not ok:
                # its peers may wait for it in a collective: stop them now
                errors.append(f"rank {rank} failed:\n{out}")
                break
            with open(out, "rb") as f:
                got[rank] = pickle.load(f)
            os.remove(out)
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if errors:
        raise RuntimeError("parallel run failed: " + "\n".join(errors))
    return [got[r] for r in range(nprocs)]
