"""ctypes bindings for the C++ audio I/O library (``audioio.cpp``, a
byte-for-byte copy of the JAX package's ``native/audioio.cpp``).

g++ builds the library at first use, with the JAX package's flags, into
``build/native/<hash>/`` beside the package (a directory ``.gitignore``
lists). The hash covers the source and the flags. A failed build raises
with the compiler's message: the port has no second resampler.

``decode_wav_native`` returns None for a file the decoder does not read
(its error code is not 0), and the caller then tries the Python decoders,
as in the JAX package.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["decode_wav_native", "resample_native", "rms_db_native",
           "load_batch_native", "native_library"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "audioio.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                           "native")
CXX_FLAGS = ["-O3", "-ffast-math", "-funroll-loops", "-pthread", "-shared",
             "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None


def _library_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16], "libaudioio.so")


def _build(so_path):
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SRC} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so_path)


def native_library():
    """Build (once per source hash) and load the library; raises when g++
    is missing or fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so_path = _library_path()
        if not os.path.exists(so_path):
            _build(so_path)
        lib = ctypes.CDLL(so_path)
        lib.vpr_decode_wav.restype = ctypes.c_int
        lib.vpr_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32)]
        lib.vpr_resample.restype = ctypes.c_int
        lib.vpr_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64)]
        lib.vpr_rms_db.restype = ctypes.c_double
        lib.vpr_rms_db.argtypes = [ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64]
        lib.vpr_load_batch.restype = ctypes.c_int
        lib.vpr_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32]
        lib.vpr_free.restype = None
        lib.vpr_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _take(lib, ptr, n):
    """Copy a malloc'd float buffer into numpy and free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n else \
        np.zeros((0,), np.float32)
    lib.vpr_free(ptr)
    return arr


def decode_wav_native(data: bytes):
    """WAV bytes -> (float32 mono samples, sample_rate), or None when the
    decoder does not read this file."""
    lib = native_library()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    rc = lib.vpr_decode_wav(data, len(data), ctypes.byref(out),
                            ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        return None
    return _take(lib, out, n.value), int(sr.value)


def resample_native(samples, sr_in: int, sr_out: int):
    """float32 samples at ``sr_in`` -> float32 samples at ``sr_out``
    (Kaiser-windowed polyphase sinc, 32 taps per phase)."""
    lib = native_library()
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    if samples.shape[0] == 0:
        return samples
    out = ctypes.POINTER(ctypes.c_float)()
    n_out = ctypes.c_int64()
    rc = lib.vpr_resample(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        samples.shape[0], int(sr_in), int(sr_out), ctypes.byref(out),
        ctypes.byref(n_out))
    if rc != 0:
        raise RuntimeError(f"vpr_resample({sr_in} -> {sr_out} Hz) failed "
                           f"with code {rc}")
    return _take(lib, out, n_out.value)


def rms_db_native(samples):
    lib = native_library()
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    return float(lib.vpr_rms_db(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        samples.shape[0]))


def load_batch_native(paths, target_sr, target_len, speeds=None,
                      crop_fracs=None, n_threads=None):
    """Train batches in one GIL-free call (JAX ``audio_native.py:166-204``):
    read, decode, resample (sample rate x speed perturb), crop and int16
    quantize every path in a C++ thread pool.

    ``speeds``: per-item (num, den) speed fractions ((9, 10) = 0.9x
    playback, a longer signal); ``crop_fracs``: per-item crop-start
    fractions in [0, 1). Returns ``(int16 (N, target_len), valid (N,)
    int64, duration_s (N,) float64)``; ``valid[i] < 0`` marks an item the
    library could not read (the caller loads it on its own)."""
    lib = native_library()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    num = np.ones(n, np.int32) if speeds is None else \
        np.ascontiguousarray([s[0] for s in speeds], dtype=np.int32)
    den = np.ones(n, np.int32) if speeds is None else \
        np.ascontiguousarray([s[1] for s in speeds], dtype=np.int32)
    fracs = (np.zeros(n, np.float32) if crop_fracs is None
             else np.ascontiguousarray(crop_fracs, dtype=np.float32))
    out = np.empty((n, int(target_len)), np.int16)
    valid = np.empty(n, np.int64)
    dur = np.empty(n, np.float64)
    if n_threads is None:
        n_threads = min(n, os.cpu_count() or 1)
    lib.vpr_load_batch(
        c_paths, n, int(target_sr), int(target_len),
        num.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        den.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        fracs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dur.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(n_threads))
    return out, valid, dur
