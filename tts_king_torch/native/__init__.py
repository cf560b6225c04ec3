"""Native (C++) host components with ctypes bindings.

Port of tts_king_tpu/native: the port's own copies of its C++ sources
(``f0.cpp``, ``dio.cpp``, ``npy_loader.cpp``, the same code), built with
the same ``g++`` flags, so both packages' F0 is bit-equal. The library is
built at first use into ``build/native/`` at the root of the checkout (not
beside the sources), named with a hash of the sources and the flags, so an
edited source is rebuilt and a stale library never loaded. ``available()``
says whether it builds and loads here; a caller that needs it and finds it
missing raises.

Components:
  * yin_f0 / yin_f0_batch: native YIN F0 (the algorithm of ops/f0.py);
  * dio_f0 / dio_f0_batch: DIO-style multiband F0 with StoneMask-style
    refinement (the reference's pyworld dio+stonemask equivalent,
    preprocessor.py:207-213);
  * load_npy_batch: threaded .npy batch loader (the native equivalent of the
    reference's DataLoader worker processes, train.py:93-99).
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_HERE, n) for n in ("f0.cpp", "dio.cpp",
                                             "npy_loader.cpp")]
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "yin_f0_native": (ctypes.c_int, [
        _F, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, _F, ctypes.c_int]),
    "yin_f0_batch": (None, [
        ctypes.POINTER(_F), _I, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, _F,
        ctypes.c_int, _I, ctypes.c_int]),
    "dio_f0_native": (ctypes.c_int, [
        _F, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, _F, ctypes.c_int]),
    "dio_f0_batch": (None, [
        ctypes.POINTER(_F), _I, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, _F,
        ctypes.c_int, _I, ctypes.c_int]),
    "load_npy_batch": (None, [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _F, ctypes.c_long,
        ctypes.c_long, ctypes.POINTER(ctypes.c_long), ctypes.c_int]),
}

_lib = None
_lock = threading.Lock()
_build_error = None


def build_dir():
    return os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                        "native")


def library_path():
    """build/native/libttsking_native_<hash of sources and flags>.so"""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir(),
                        f"libttsking_native_{h.hexdigest()[:16]}.so")


def _build(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, *_SOURCES, "-lpthread"],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The native library (built at first use), or None where it cannot be
    built or loaded (the reason is in ``build_error()``)."""
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = e
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return _lib


def build_error():
    return _build_error


def available() -> bool:
    return get_lib() is not None


def _need():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return lib


def _threads(n_threads):
    return min(os.cpu_count() or 1, 8) if n_threads is None else n_threads


def yin_f0(wav, sampling_rate=22050, hop_length=256, frame_length=2048,
           f0_floor=71.0, f0_ceil=800.0, threshold=0.15):
    """Native YIN for one utterance. wav: (T,) float32 -> (T//hop+1,) f0."""
    lib = _need()
    wav = np.ascontiguousarray(wav, np.float32)
    max_frames = len(wav) // hop_length + 1
    out = np.zeros(max_frames, np.float32)
    n = lib.yin_f0_native(
        wav.ctypes.data_as(_F), len(wav), sampling_rate, hop_length,
        frame_length, f0_floor, f0_ceil, threshold, out.ctypes.data_as(_F),
        max_frames)
    return out[:n]


def _batch(fn, wavs, hop_length, args, n_threads):
    """Run a batch entry point over a list of utterances: (pointers,
    lengths, n, *args, out, max_frames, n_frames, threads)."""
    wavs = [np.ascontiguousarray(w, np.float32) for w in wavs]
    n = len(wavs)
    lens = np.asarray([len(w) for w in wavs], np.int32)
    max_frames = int(lens.max()) // hop_length + 1 if n else 0
    out = np.zeros((n, max_frames), np.float32)
    n_frames = np.zeros(n, np.int32)
    ptrs = (_F * n)(*[w.ctypes.data_as(_F) for w in wavs])
    fn(ptrs, lens.ctypes.data_as(_I), n, *args, out.ctypes.data_as(_F),
       max_frames, n_frames.ctypes.data_as(_I), _threads(n_threads))
    return [out[i, : n_frames[i]].copy() for i in range(n)]


def yin_f0_batch(wavs, sampling_rate=22050, hop_length=256, frame_length=2048,
                 f0_floor=71.0, f0_ceil=800.0, threshold=0.15,
                 n_threads=None):
    """Native YIN over a list of utterances with a thread pool; a list of
    per-utterance f0 arrays."""
    lib = _need()
    return _batch(lib.yin_f0_batch, wavs, hop_length,
                  (sampling_rate, hop_length, frame_length, f0_floor, f0_ceil,
                   threshold), n_threads)


def dio_f0(wav, sampling_rate=22050, hop_length=256, f0_floor=71.0,
           f0_ceil=800.0, channels_in_octave=2.0, allowed_range=0.1):
    """DIO-style multiband F0 + StoneMask-style refinement for one utterance
    (the reference's pyworld dio+stonemask equivalent, preprocessor.py:207-213).
    wav: (T,) float32 -> (T//hop+1,) f0 in Hz, 0 where unvoiced."""
    lib = _need()
    wav = np.ascontiguousarray(wav, np.float32)
    max_frames = len(wav) // hop_length + 1
    out = np.zeros(max_frames, np.float32)
    n = lib.dio_f0_native(
        wav.ctypes.data_as(_F), len(wav), sampling_rate, hop_length,
        f0_floor, f0_ceil, channels_in_octave, allowed_range,
        out.ctypes.data_as(_F), max_frames)
    return out[:n]


def dio_f0_batch(wavs, sampling_rate=22050, hop_length=256, f0_floor=71.0,
                 f0_ceil=800.0, channels_in_octave=2.0, allowed_range=0.1,
                 n_threads=None):
    """Threaded DIO over a list of utterances -> list of f0 arrays."""
    lib = _need()
    return _batch(lib.dio_f0_batch, wavs, hop_length,
                  (sampling_rate, hop_length, f0_floor, f0_ceil,
                   channels_in_octave, allowed_range), n_threads)


def load_npy_batch(paths, max_rows, cols, n_threads=None):
    """Threaded load of .npy files into one zero-padded float32 batch.

    Returns (batch (n, max_rows, cols) float32, lengths (n,) int64; -1 marks
    a failed load).
    """
    lib = _need()
    n = len(paths)
    batch = np.zeros((n, max_rows, cols), np.float32)
    lengths = np.zeros(n, np.int64)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.load_npy_batch(
        c_paths, n, batch.ctypes.data_as(_F), max_rows, cols,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        _threads(n_threads))
    return batch, lengths
