"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain
``extern "C"`` interface (no PyTorch headers, so a build takes seconds).
The build runs at first use, on a machine with ``nvcc``, into
``kernels/_build/`` (listed in ``.gitignore``).  A library's file name
carries a hash of every source under ``csrc/`` (the ``.cu`` files and the
``.cuh`` headers they share) and of the flags, so an edited source or
header rebuilds and a stale library is never loaded.  :func:`build` starts
one nvcc per missing library, all at once; :func:`load` builds every
missing main-path library in that one round, so a process's first kernel
builds all the others it may call (the resize's, the conv stack's)
without a serial nvcc.  Nothing here runs at import time.

A library named ``<name>_prof`` is ``csrc/<name>.cu`` built a second time
with ``-DSRCNN_PROFILING``: the kernel-profiling path (K5 and the stage
cuts K6 / K7), kept out of the main path's libraries so that their
first-use build does not grow.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

# No --use_fast_math: flush-to-zero and approximate division are not
# exact f32.  -Xptxas -v reports registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name suffix of a profiling library, and the define that makes one
PROFILING = "_prof"
PROFILING_FLAGS = ("-DSRCNN_PROFILING",)

#: ptxas / nvcc output of each library built in this process, by name
build_logs: dict[str, str] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def tool(name: str) -> str:
    """Path of a CUDA toolkit program (e.g. ``cuobjdump``) beside nvcc."""
    return os.path.join(os.path.dirname(nvcc()), name)


def _source_and_flags(name: str) -> tuple[str, tuple[str, ...]]:
    """The ``csrc`` source of library ``name`` and its nvcc flags."""
    if name.endswith(PROFILING):
        return name[:-len(PROFILING)] + ".cu", NVCC_FLAGS + PROFILING_FLAGS
    return name + ".cu", NVCC_FLAGS


def sources() -> list[str]:
    """Every file under ``csrc/`` that a build can read, in a fixed order."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def main_libraries() -> list[str]:
    """The main path's libraries: one per ``csrc/*.cu``, none of the
    profiling ones."""
    return sorted(os.path.splitext(os.path.basename(src))[0]
                  for src in glob.glob(os.path.join(CSRC, "*.cu")))


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(_source_and_flags(name)[1]).encode())
    digest.update(name.encode())
    for src in sources():
        digest.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(*names: str) -> None:
    """Build the library of each name whose library is missing (see the
    module's docstring), one nvcc process per library, all started
    together."""
    todo = [n for n in dict.fromkeys(names) if not os.path.exists(library_path(n))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    try:
        for name in todo:
            # build to a temporary name, then rename: a concurrent build or
            # an interrupted one never leaves a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            src, flags = _source_and_flags(name)
            cmd = [nvcc(), *flags, "-o", tmp, os.path.join(CSRC, src)]
            jobs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, tmp, proc in jobs:
            out, _ = proc.communicate()
            build_logs[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}:\n{out}")
            else:
                os.replace(tmp, library_path(name))
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build library ``name`` and every main-path library that is missing
    (:func:`main_libraries`) in one round, then load ``name``."""
    build(name, *main_libraries())
    return ctypes.CDLL(library_path(name))
