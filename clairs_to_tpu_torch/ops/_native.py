"""Build and load the port's native libraries.

A ``Library`` names a C++ or CUDA source (a file name under ``csrc/``, or a
path), its shared library under ``build/kernels/`` at the repository root,
the compiler command that makes one from the other (nvcc for sm_90a unless
given; ``host_command`` for the host's C++ compiler), and its C entry
points, each with its return type and argument types.  ``build`` compiles
each library that is missing or older than its source, all at once, each to
a temporary name renamed on success (two processes may build at once), and
loads it with ctypes.  A failed build raises with the compiler's output;
``Library.load_or_none`` keeps the error and returns None instead, for the
host libraries whose callers fall back to numpy or Python.
"""

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")


def nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from csrc/*.cu with "
                       "the CUDA toolkit (set CUDA_HOME)")


def nvcc_command(src, verbose=False):
    """nvcc's arguments that build ``src`` into a shared library for sm_90a
    (``start_compile`` adds the output); ``-Xptxas -v`` when ``verbose``."""
    return [nvcc(), *(["-Xptxas", "-v"] if verbose else []), "-gencode",
            "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
            "-fPIC", src]


def host_command(*flags, libs=()):
    """A ``command`` for the host's C++ compiler (c++ or g++): ``-O3
    -std=c++17 -shared -fPIC`` and ``flags``, the source, then the ``libs``
    it links."""
    def command(src, verbose=False):
        for cand in ("c++", "g++"):
            path = shutil.which(cand)
            if path:
                return [path, "-O3", "-std=c++17", "-shared", "-fPIC", *flags, src, *libs]
        raise RuntimeError(f"no C++ compiler (c++ or g++) found to build {src}")
    return command


def stale(src, so):
    """Whether the library ``so`` is missing or older than its source ``src``."""
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def start_compile(argv, so):
    """Start the compiler ``argv`` writing to a temporary name beside ``so``;
    ``finish_compile`` renames it."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    return tmp, subprocess.Popen([*argv, "-o", tmp], stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def finish_compile(job, so):
    """Wait for a ``start_compile`` job and, if it succeeded, move its library
    to ``so``.  Returns (returncode, stdout, stderr)."""
    tmp, proc = job
    out, err = proc.communicate()
    if proc.returncode == 0:
        os.replace(tmp, so)
    return proc.returncode, out, err


class Library:
    """A native library: ``source`` (a file name under ``csrc/``, or a path),
    built into ``build/kernels/<so_name>``; ``entries`` maps each C entry
    point to ``(return type, argument types)``, the first being the one
    ``fn()`` gives by default; ``command(src, verbose)`` gives the
    compiler's arguments without the output (``nvcc_command`` unless given).
    Once built, ``cdll`` is the loaded library and ``fns`` its entry points;
    ``error`` is what ``load_or_none`` caught."""

    def __init__(self, source, so_name, entries, command=nvcc_command):
        self.source = os.path.join(CSRC, source)    # an absolute ``source`` stays as it is
        self.so = os.path.join(BUILD_DIR, so_name)
        self.entries = entries
        self.command = command
        self.lock = threading.Lock()
        self.cdll = self.fns = self.error = None

    def fn(self, entry=None):
        """The loaded entry point ``entry`` (the first by default), built
        first if need be."""
        if self.fns is None:
            build(self)
        return self.fns[entry or next(iter(self.entries))]

    def load_or_none(self):
        """The loaded library, built first if need be, or None if it does not
        build or load: the error is then kept in ``error`` and not tried
        again.  Threads that ask at once wait for one build."""
        if self.cdll is None and self.error is None:
            try:
                build(self)
            except Exception as e:
                self.error = e
        return self.cdll


def build(*libs, verbose=False):
    """Compile each of ``libs`` whose library is missing or older than its
    source (one compiler each, all at once) and load every one not loaded
    yet.  Returns the compilers' diagnostics, "" when every library was
    current.  Raises if one fails, and then loads none of them."""
    with contextlib.ExitStack() as held:
        # each library's own lock, always in one order
        for lib in sorted(set(libs), key=lambda lib: lib.so):
            held.enter_context(lib.lock)
        jobs = {lib: start_compile(lib.command(lib.source, verbose), lib.so)
                for lib in libs if stale(lib.source, lib.so)}
        log, failed = "", []
        for lib, job in jobs.items():
            rc, out, err = finish_compile(job, lib.so)
            name = os.path.basename(lib.source)
            if rc != 0:
                compiler = os.path.basename(lib.command(lib.source)[0])
                failed.append(f"{compiler} failed on {name} ({rc}):\n{err}")
                continue
            log += f"{name}:\n{out}{err}"
        if failed:
            raise RuntimeError("\n".join(failed))
        for lib in libs:
            if lib.fns is None:
                cdll = ctypes.CDLL(lib.so)
                fns = {}
                for entry, (restype, argtypes) in lib.entries.items():
                    fn = getattr(cdll, entry)
                    fn.restype, fn.argtypes = restype, argtypes
                    fns[entry] = fn
                lib.cdll, lib.fns = cdll, fns
        return log
