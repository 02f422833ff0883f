"""The JAX package's native audio library for the port's tests: built once
per run under a file lock, loaded whole by every test process.

The JAX binding (``voiceprintrecognition_paddlepaddle_tpu/native/
audio_native.py``) builds ``libaudioio.so`` lazily with g++ straight onto
its shared path, with no lock between processes, and a process whose load
fails keeps the binding's Python decoders and resampler for good. Under
pytest-xdist several workers may build or load that file at once; a
worker that loads a half-written library then holds the port's native
results against JAX's Python fallback, which differs from the native code
at every resampling rate.

Every port test module that reaches the JAX package's audio code imports
this module first. At import it points the JAX binding at a library of
its own under ``build/jax_native/<source hash>/`` and, holding an
``fcntl`` lock on a file beside it, lets the binding's own loader build
(once per run) and load it. No other process writes that path, so every
worker loads a complete library. Each xdist worker imports every test
module while it collects, before any test runs, so this happens before
the first test, and the JAX package's own audio tests in the same worker
use the same library.

The JAX package's ``tests/test_native.py`` asks for the library while it
is collected, which comes first; that call still builds onto the shared
path and is not covered here.
"""

import fcntl
import hashlib
import os

from voiceprintrecognition_paddlepaddle_tpu.native import \
    audio_native as _jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_under_lock():
    with open(_jax_native._SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    home = os.path.join(ROOT, "build", "jax_native", digest)
    os.makedirs(home, exist_ok=True)
    with open(os.path.join(home, "lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            with _jax_native._lock:
                _jax_native._LIB_PATH = os.path.join(home, "libaudioio.so")
                _jax_native._HASH_PATH = _jax_native._LIB_PATH + ".srchash"
                _jax_native._lib, _jax_native._tried = None, False
            return _jax_native.native_available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_load_under_lock()


def require_jax_native():
    """Fail with a clear message, not a numeric mismatch against the JAX
    package's Python fallback, when its native library did not load."""
    assert _jax_native.native_available(), \
        "the JAX package's native library did not load"
