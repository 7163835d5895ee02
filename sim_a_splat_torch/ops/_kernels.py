"""Build and load the CUDA kernels of ``sim_a_splat_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ctypes.  Nothing is
built at import: the first call that needs a kernel builds it (all sources
at once, one ``nvcc`` process each, in parallel) into
``sim_a_splat_torch/_build/``, named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused.

``--use_fast_math`` is never passed: it changes ``expf``, and the
``ALPHA_MIN`` and sigma cut-offs would turn such differences into whole
contributions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNEL_SOURCES = ("composite", "composite_bwd", "composite_sel",
                  "composite_sel_bwd", "composite_single",
                  "composite_single_bwd", "composite_pair",
                  "composite_pair_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else the one under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``); raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def compile_all(jobs) -> dict:
    """Compile each (source ``.cu``, include directory, library path) job
    with ``nvcc``, one process each, all started together.  Returns
    {library path: nvcc's output (ptxas' report)}; raises with nvcc's
    output on failure."""
    nvcc = nvcc_path()
    procs = []
    for src, inc, lib in jobs:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(inc), "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {src} (rc {proc.returncode})\n{log}")
            continue
        os.replace(tmp, lib)
        logs[lib] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def build_all() -> dict:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together.  Returns {name: {"seconds", "ptxas"}} for the
    sources built by this call (seconds: the whole build's); raises with
    nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {name: _library_path(name) for name in KERNEL_SOURCES}
    jobs = {name: lib for name, lib in jobs.items() if not lib.exists()}
    logs = compile_all([(CSRC / f"{name}.cu", CSRC, lib)
                        for name, lib in jobs.items()])
    seconds = time.perf_counter() - t0
    return {name: {"seconds": seconds, "ptxas": logs[lib]}
            for name, lib in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """The launch function ``symbol`` of ``csrc/<name>.cu``'s library, with
    its ctypes ``argtypes`` set (pointers as ``c_void_p``, so none is cut to
    32 bits) and an int result: the CUDA error code of the launch."""
    f = getattr(load(name), symbol)
    if f.argtypes is None:
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return f


def check(rc: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
