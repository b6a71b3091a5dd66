"""The JAX package's native shims (``native/*.so``) for the port's tests.

Several test processes may build ``native/`` at once: the JAX package's
``tests/test_native_wordpiece.py`` runs ``make -C native`` when it is
imported, in every xdist worker that finds a library missing, and a linker
rewrites the library while it runs.  A load that lands inside that window
fails, and the JAX loaders cache the failure for the process
(``_LIB_TRIED``).  ``load_jax_shim`` builds under a file lock, clears that
cache and retries the load until it succeeds or ``SHIM_WAIT_S`` have passed.
"""

import fcntl
import os
import subprocess
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIM_WAIT_S = 120  # how long a load may wait on builds in other test processes


def load_jax_shim(module, library: str):
    """``module._load_native()`` (a JAX shim loader) once ``native/<library>``
    loads; None if it has not after ``SHIM_WAIT_S``."""
    lock_path = os.path.join(tempfile.gettempdir(), "mmgclip_native_build.lock")
    deadline = time.monotonic() + SHIM_WAIT_S
    while True:
        with open(lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.isfile(os.path.join(REPO, "native", library)):
                subprocess.run(["make", "-C", os.path.join(REPO, "native")], capture_output=True)
            module._LIB_TRIED = False
            lib = module._load_native()
        if lib is not None or time.monotonic() > deadline:
            return lib
        time.sleep(1.0)
