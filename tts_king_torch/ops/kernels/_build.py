"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``tts_king_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds). The library's name carries a hash of
the source and the flags, so an edited source is rebuilt and a stale
library is never loaded. Libraries go to ``build/kernels/`` at the root of
the checkout.

Every C entry point returns a ``cudaError_t`` value; ``check`` raises on
anything but 0. Nothing here runs when a module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
SOURCES = {"attention": "attention.cu", "mrf_stage": "mrf_stage.cu",
           "mrf_stage_int8": "mrf_stage_int8.cu",
           "flash_attention": "flash_attention.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs = {}


def build_dir():
    return os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build",
                        "kernels")


def nvcc_path():
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def _lib_path(name):
    with open(os.path.join(CSRC_DIR, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=None):
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process per source, all started together. Returns {name: seconds}
    for the sources it compiled; raises with nvcc's output on a failure.
    nvcc's resource report (-Xptxas -v) is kept beside each library as
    ``<lib>.log``."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out, tmp, time.perf_counter())
    seconds = {}
    failures = []
    for name, (proc, out, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(out + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[name]} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name):
    """The ctypes library of one kernel, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        _libs[name] = lib
    return lib


def build_log(name):
    with open(_lib_path(name) + ".log") as f:
        return f.read()


def check(lib, err, what):
    """Raise if a C entry point of ``lib`` returned a CUDA error."""
    if err != 0:
        lib.tk_error_string.argtypes = [ctypes.c_int]
        lib.tk_error_string.restype = ctypes.c_char_p
        msg = lib.tk_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def current_stream(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
