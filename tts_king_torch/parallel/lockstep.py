"""Multi-process startup and the coordination barrier.

Counterpart of tts_king_tpu/parallel/lockstep.py and of the
``jax.distributed.initialize`` call in scripts/train.py. ``initialize``
joins a ``torch.distributed`` process group over a ``TCPStore`` that rank 0
serves at the coordinator's address, with an explicit timeout;
``coordination_barrier`` waits for every process on that store, which is
not a collective: it works before any group has run one, and takes any
timeout.

The JAX file's other half, the first-dispatch lockstep (``LockstepFn``),
exists because XLA builds a Gloo clique when a program first runs, with a
fixed ~30 s rendezvous that a peer still compiling can miss. PyTorch
builds each group's Gloo or NCCL context when the group is created
(``init_process_group``, ``new_group``), under the timeout given here, and
runs no compiler between collectives, so that part has no counterpart.
"""

import collections
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "active", "coordination_barrier", "default_backend",
           "local_world_size", "add_cli_args", "init_from_args"]

_store = None
_uses = collections.Counter()


def default_backend(device, local_processes: int) -> str:
    """NCCL where each of this host's ``local_processes`` has a card of its
    own, else gloo (the CPU, or several processes sharing one card: NCCL
    refuses two ranks on one device, gloo reduces CUDA tensors)."""
    device = torch.device(device)
    if (device.type == "cuda" and dist.is_nccl_available()
            and local_processes <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def local_world_size() -> int:
    """The processes of this run on this host: torchrun's
    LOCAL_WORLD_SIZE, else every process of the run."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: str = "gloo",
               timeout_s: float = 900.0) -> None:
    """Join the run's process group. ``coordinator`` is ``host:port``;
    rank 0 serves the store there. Without the three values, torchrun's
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) is read."""
    global _store
    missing = [v for v, given in (
        ("MASTER_ADDR", coordinator), ("MASTER_PORT", coordinator),
        ("WORLD_SIZE", num_processes), ("RANK", process_id))
        if given is None and v not in os.environ]
    if missing:
        raise ValueError(
            "a multi-process run needs --coordinator HOST:PORT, "
            "--num-processes and --process-id, or torchrun's environment "
            f"(missing {', '.join(missing)})")
    if coordinator is None:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    _store = dist.TCPStore(host, int(port), num_processes,
                           is_master=process_id == 0, timeout=timeout)
    dist.init_process_group(backend, store=_store, world_size=num_processes,
                            rank=process_id, timeout=timeout)


def active() -> bool:
    """A multi-process run is joined."""
    return dist.is_initialized() and dist.get_world_size() > 1


def _default_store():
    if _store is not None:
        return _store
    from torch.distributed import distributed_c10d

    return distributed_c10d._get_default_store()


def coordination_barrier(name: str, timeout_s: float = 900.0) -> None:
    """Block until every process of the run reaches barrier ``name``, on
    the store (not a collective). A name may recur: its n-th use is a
    barrier of its own, so every process must pass the barriers of one
    name in one sequence. No-op outside a process group."""
    if not dist.is_initialized():
        return
    key = f"ttk_barrier:{name}#{_uses[name]}"
    _uses[name] += 1
    store = _default_store()
    if store.add(f"{key}:arrived", 1) == dist.get_world_size():
        store.set(f"{key}:go", "1")
    store.wait([f"{key}:go"], datetime.timedelta(seconds=timeout_s))


def add_cli_args(ap):
    """The multi-process flags of the training CLIs (scripts/train.py:44-60,
    scripts/train_vocoder.py:33-44)."""
    ap.add_argument("--distributed", action="store_true",
                    help="join a multi-process run (torch.distributed)")
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's host:port (default: torchrun's "
                         "MASTER_ADDR:MASTER_PORT)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)


def init_from_args(args):
    """Join the run's process group when ``--distributed`` is given;
    returns the device this process computes on."""
    device = args.device
    if not args.distributed:
        return device
    rank = (args.process_id if args.process_id is not None
            else int(os.environ.get("RANK", 0)))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu")
        device = f"cuda:{local_rank % torch.cuda.device_count()}"
        torch.cuda.set_device(torch.device(device))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", args.num_processes
                               or os.environ.get("WORLD_SIZE", 1)))
    initialize(args.coordinator, args.num_processes, args.process_id,
               default_backend(device, local))
    return device
