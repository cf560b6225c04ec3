"""Process set-up of a benchmark run: where caches go, the device guard, the
float32 settings, the check that no JAX module was loaded, and what the
result line says of the device.

Nothing here runs when the module is imported.
"""

import os
import sys
import time

# Top-level module names that no run may load: the JAX stack and the JAX
# package the port was made from. Compared whole: ``tts_king_torch`` is the
# system under test and only shares a prefix with ``tts_king_tpu``.
BANNED_MODULES = frozenset({"jax", "jaxlib", "flax", "optax", "tts_king_tpu"})

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH_DIR)


def process_start_time():
    """Wall-clock time (time.time()) at which this process started, from
    /proc; time.time() itself where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])   # field 22: starttime, in clock ticks
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def fix_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds; no library loads JAX; and the
    host's math libraries run one thread each, so that a run is one
    process of few threads (steadier times on a shared host)."""
    build = os.path.join(CHECKOUT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"


def sys_path():
    """The checkout on sys.path, so that the program imports by name."""
    if CHECKOUT not in sys.path:
        sys.path.insert(0, CHECKOUT)


def cuda_guard(chips):
    """None when ``chips`` CUDA cards are there, else the reason to stop."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False: this benchmark runs only on a CUDA card"
    n = torch.cuda.device_count()
    if n < chips:
        return f"the cell needs {chips} CUDA cards, this machine has {n}"
    return None


def float32_exact():
    """Float32 products and convolutions in full float32 (TF32 off), as the
    configurations state f32. PyTorch's default turns TF32 on for cuDNN."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def banned_loaded():
    """Sorted top-level names of loaded modules that no run may load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & BANNED_MODULES)


def device_record(device):
    """The result line's ``device`` for a run on one card: platform, card
    name, cards used, and the peak of allocated memory since the last
    reset (the window's opening)."""
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def nvidia_smi_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"
