"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``tts_king_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds). The library's name carries a hash of
the source, of every header beside it (``*.cuh``) and of the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
Libraries go to ``build/kernels/`` at the root of the checkout.

Each library's C entry points get their ctypes signatures once, when the
library is opened (``SIGNATURES``). Every kernel entry point returns a
``cudaError_t`` value; ``check`` raises on anything but 0. Nothing here runs
when a module is imported.

Several threads may launch kernels at once (the server's pipeline stages and
a streaming caller): ``load`` and ``build`` hold one lock while they build
and bind, each build writes through a temporary file named for its process
and thread, and ``count_launch`` bumps a wrapper's launch count under a lock.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
SOURCES = {"attention": "attention.cu", "mrf_stage": "mrf_stage.cu",
           "mrf_stage_int8": "mrf_stage_int8.cu",
           "flash_attention": "flash_attention.cu", "amp_act": "amp_act.cu"}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> {entry point: (restype, argtypes)}; pointers and the stream are
# c_void_p (a plain int would be cut to 32 bits).
SIGNATURES = {
    "attention": {
        "tk_attention": (_I, [_P] * 5 + [_I] * 5 + [_LL] * 6
                         + [ctypes.c_float, _P]),
        "tk_attention_probs_bf16": (_I, [_P] * 6 + [_I] * 4 + [_LL] * 7
                                    + [ctypes.c_float, _P])},
    "flash_attention": {
        "tk_flash_fwd": (_I, [_P] * 6 + [_I] * 4 + [_LL] * 6
                         + [ctypes.c_float, _P]),
        "tk_flash_bwd": (_I, [_P] * 11 + [_I] * 4 + [_LL] * 6
                         + [ctypes.c_float, _P]),
        "tk_flash_fwd_probs_bf16": (_I, [_P] * 7 + [_I] * 4 + [_LL] * 7
                                    + [ctypes.c_float, _P]),
        "tk_flash_bwd_probs_bf16": (_I, [_P] * 11 + [_I] * 4 + [_LL] * 7
                                    + [ctypes.c_float, _P])},
    "mrf_stage": {
        "tk_mrf_stage_bf16": (_I, [_P] * 5 + [_I] * 7 + [_P, _I, _P]
                              + [_LL] * 6 + [_P]),
        "tk_mrf_stage_f32": (_I, [_P] * 5 + [_I] * 7 + [_P, _I, _P]
                             + [_LL] * 6 + [_P])},
    "mrf_stage_int8": {
        "tk_mrf_int8_cluster_smem": (_LL, [_I] * 7),
        "tk_mrf_int8_pass_rows": (_I, [_I]),
        "tk_mrf_int8_cluster_stage": (_I, [_P] * 5 + [_I] * 8
                                      + [_P, _I, _P, _P] + [_I] * 4
                                      + [_LL] * 6 + [_P])},
    "amp_act": {
        "tk_amp_act": (_I, [_P] * 7 + [_I] * 4 + [_LL, _LL, _I, _P, _P]),
        "tk_amp_mean": (_I, [_P] * 3 + [_I, _P, _I, _LL, _I, _LL, _I, _P])},
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs = {}
_lock = threading.RLock()          # load and build
_count_lock = threading.Lock()     # count_launch


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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=None):
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process per source, all started together. Returns {name: seconds}
    for the sources it compiled; raises with nvcc's output on a failure.
    nvcc's resource report (-Xptxas -v) is kept beside each library as
    ``<lib>.log``."""
    with _lock:
        return _compile(list(SOURCES) if names is None else list(names))


def _compile(names):
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
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


def bind(name, path):
    """Open the library at ``path`` with the entry points of kernel
    ``name`` bound to their ctypes signatures."""
    lib = ctypes.CDLL(path)
    for fn_name, (restype, argtypes) in {
            **SIGNATURES[name],
            "tk_error_string": (ctypes.c_char_p, [ctypes.c_int])}.items():
        fn = getattr(lib, fn_name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def load(name):
    """The ctypes library of one kernel, built first if needed; the first
    caller of several threads builds and binds it, the others wait for it."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = bind(name, _lib_path(name))
                _libs[name] = lib
    return lib


def count_launch(namespace, name="launches", n=1):
    """Add ``n`` to the count ``namespace[name]`` (a wrapper module's
    globals()) under a lock: a bare ``+= 1`` from two threads can lose one."""
    with _count_lock:
        namespace[name] += n


def build_log(name):
    with open(_lib_path(name) + ".log") as f:
        return f.read()


def check(lib, err, what):
    """Raise if a C entry point of ``lib`` returned a CUDA error."""
    if err != 0:
        msg = lib.tk_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def current_stream(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
