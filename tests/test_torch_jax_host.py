"""Loads the JAX package's host library before a port test compares with it.

Some of the port's tests hold the port bit for bit against results that
only the JAX package's host library (``native/libsigma_host.so``) gives:
its numpy fallback sums in another order and differs in the last bit.
That library is built on first use with ``g++ -o`` in place, and the JAX
loader tries once per process: under ``pytest -n N`` a worker that opens
a half-written file keeps the fallback for every file it runs after.

``jax_host_library()`` makes the load certain.  It takes a file lock under
``build/`` (so the port's test files of all workers build and load one at
a time), loads, and on failure forgets the failed attempt and tries again
a few times, a second apart, so that a worker that met another process's
half-written file loads the finished one.  If the library still does not
load it raises, naming the cause: a test never compares quietly against
the fallback.  The test files that need it call it at import."""

import fcntl
import os
import time
from pathlib import Path

from sigma_tpu import native as jax_native

LOCK = Path(__file__).resolve().parent.parent / "build" / "jax_host_library.lock"
TRIES = 30


def jax_host_library():
    """The JAX package's loaded host library, or a ``RuntimeError``."""
    if os.environ.get("SIGMA_TPU_NO_NATIVE"):
        raise RuntimeError(
            "SIGMA_TPU_NO_NATIVE is set, so the JAX package uses its numpy fallback; "
            "these tests hold the port bit for bit against its host library "
            "(native/libsigma_host.so) and need it loaded")
    LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(LOCK, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            for attempt in range(TRIES):
                lib = jax_native._load()
                if lib is not None:
                    return lib
                jax_native._tried = False
                if attempt + 1 < TRIES:
                    time.sleep(1.0)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    raise RuntimeError(
        f"the JAX package's host library {jax_native._LIB_PATH} did not build or load "
        f"in {TRIES} tries (g++ missing or failing on {jax_native._SRC}?); these tests "
        "hold the port bit for bit against it and do not compare against the numpy "
        "fallback")


def test_jax_host_library_is_loaded_in_this_worker():
    lib = jax_host_library()
    assert jax_native.available()
    assert lib is jax_native._load()
