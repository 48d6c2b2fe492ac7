"""The JAX package's three C++ libraries, made sure of for the port's
parity tests.

The JAX package builds each library in place with ``g++ -o <the .so>`` at
first use, with no lock, and keeps a failed load in ``_load_error`` for the
life of the process.  Under pytest-xdist every worker imports every test
file at the same moment, so on a checkout with no library built one worker
can ``dlopen`` a file that another is still writing ("file too short").
That worker then runs the JAX side of a parity test on its numpy or Python
fallback, or skips.  ``load_all()`` repairs that for the port's tests:
under a lock file that every process shares, it rebuilds a library that
failed to load to a temporary name, moves it into place with
``os.replace``, clears the module's ``_lib`` / ``_load_error`` and loads
it again, and raises if it still does not load.  Nothing under
``clairs_to_tpu/`` changes, so the JAX tests' own collection-time loads
keep their race.
"""

import fcntl
import importlib
import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(REPO, "build", "jax_native.lock")   # build/ is git-ignored

# each library's g++ command as the JAX package's loader runs it
# (realign/__init__.py:28, bamio/native/__init__.py:27-30,
# postcall/verdict_native.py:28-31), its output and source named "_SO" and
# "_SRC" as there; tests/test_torch_native_libs.py holds each to its loader
COMMANDS = {
    "clairs_to_tpu.realign":
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", "_SO", "_SRC"],
    "clairs_to_tpu.bamio.native":
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", "_SO", "_SRC", "-lz"],
    "clairs_to_tpu.postcall.verdict_native":
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off", "-o", "_SO",
         "_SRC"],
}


def _rebuild(mod):
    tmp = f"{mod._SO}.{os.getpid()}.tmp"
    names = {"_SO": tmp, "_SRC": mod._SRC}
    subprocess.run([names.get(a, a) for a in COMMANDS[mod.__name__]], check=True,
                   capture_output=True)
    os.replace(tmp, mod._SO)


def loaded(name):
    """The JAX module ``name`` (a key of COMMANDS) with its library loaded."""
    mod = importlib.import_module(name)
    if mod._lib is not None:
        return mod
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    with open(LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if mod.get_lib() is None:
                _rebuild(mod)
                mod._lib, mod._load_error = None, None
                if mod.get_lib() is None:
                    raise RuntimeError(f"{name}: library does not load: {mod._load_error!r}")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return mod


def load_all():
    for name in COMMANDS:
        loaded(name)
