"""Build the port's CUDA kernels with nvcc, load them with ctypes and
launch them.

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

Every hand-written kernel (K1-K7 of :mod:`.fused_conv` and
:mod:`.ablation`, ``resample``, ``color``) is loaded by :func:`library`,
from the one table of C signatures :data:`LIBRARIES`, and launched by
:func:`launch`, which counts it in ``utils.profiling.launches``.
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

import torch

from ..utils.profiling import counts, launches

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


_P, _I = ctypes.c_void_p, ctypes.c_int


def _fused(prefix: str, own: dict | None = None, **entries: int) -> tuple[str, dict]:
    """A fused conv library's C functions: its two constants, ``own``'s
    functions with their own argument types, and each entry point with (y,
    out, params, then ``entries[entry]`` ints: n, h, w, the 4 edge flags
    and its own, then the stream)."""
    return prefix, {"n_params": (), "max_rows": (), **(own or {}),
                    **{e: (_P,) * 3 + (_I,) * n + (_P,) for e, n in entries.items()}}


#: library -> (C prefix, {C function without the prefix: its argument
#: types}); every function returns an int, a cudaError_t or a constant.
#: The ``_prof`` libraries add the profiling path's entry points:
#: ``cut_forward`` (K6, K7: [kernel index,] stage) and ``band_forward``
#: (K5: tile_h); K1's library adds its strip walk's ``segment_tiles`` (n,
#: h, w, SMs -> tiles per segment).
LIBRARIES = {
    "fused_srcnn": _fused("srcnn_fused", {"segment_tiles": (_I,) * 4}, forward=7),
    "fused_srcnn_bf16": _fused("srcnn_bf16", forward=8),
    "fused_srcnn_int8": _fused("srcnn_int8", forward=7),
    "fused_srcnn_prof": _fused("srcnn_fused", forward=7, cut_forward=8),
    "fused_srcnn_bf16_prof": _fused("srcnn_bf16", forward=8, cut_forward=9,
                                    band_forward=8),
    "fused_srcnn_int8_prof": _fused("srcnn_int8", forward=7, cut_forward=8),
    "resample": ("resample", {"rows": (_P,) * 4 + (_I,) * 5 + (_P,),
                              "cols": (_P,) * 4 + (_I, ctypes.c_longlong, _I, _I, _P)}),
    "color": ("color", {"split_launch": (_P, _P, _I, _I, _P),
                        "merge_launch": (_P,) * 6 + (_I, _I, _P)}),
}


@functools.lru_cache(maxsize=None)
def library(name: str) -> dict:
    """Library ``name`` of :data:`LIBRARIES`, loaded once: its C functions
    by their names without the prefix, declared.  Its load builds it and
    every main-path library that is missing (:func:`main_libraries`) in
    one round, and counts one ``kernels.libs_loaded``."""
    if name not in LIBRARIES:
        raise ValueError(f"no kernel library {name!r}")
    build(name, *main_libraries())
    lib = ctypes.CDLL(library_path(name))
    counts["kernels.libs_loaded"] += 1
    prefix, functions = LIBRARIES[name]
    declared = {}
    for fn, argtypes in functions.items():
        declared[fn] = getattr(lib, f"{prefix}_{fn}")
        declared[fn].argtypes, declared[fn].restype = argtypes, ctypes.c_int
    return declared


@functools.lru_cache(maxsize=None)
def constants(name: str) -> dict[str, int]:
    """Library ``name``'s constants (its functions that take no argument),
    read once."""
    return {fn: f() for fn, f in library(name).items() if not f.argtypes}


def cuda_device(t: torch.Tensor, kernel: str) -> torch.device:
    """``t``'s device, which must be a CUDA one: a kernel has no CPU form."""
    if t.device.type != "cuda":
        raise ValueError(f"the {kernel} kernel takes CUDA tensors, got {t.device}; "
                         f"a CPU tensor takes its plain version")
    return t.device


def launch(name: str, entry: str, kernel: str, *args) -> None:
    """Call C function ``entry`` of library ``name`` with ``args`` and the
    stream, and count one launch of ``kernel`` in
    ``utils.profiling.launches``.  A tensor in ``args`` passes its data
    pointer; the first one must be on CUDA (:func:`cuda_device`), and the
    call runs on its device and that device's current stream (the callers
    check that every tensor lies there).  A nonzero cudaError raises
    RuntimeError."""
    dev = cuda_device(args[0], kernel)
    fn = library(name)[entry]
    with torch.cuda.device(dev):
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    launches[kernel] += 1
