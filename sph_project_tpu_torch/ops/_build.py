"""Build the port's CUDA kernels with ``nvcc`` on first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its own
into ``build/kernels/<name>-<hash>.so`` at the repository root (the hash
covers the source, every shared header ``csrc/*.cuh`` and the flags, so an
edit to any of them rebuilds), then loaded with ``ctypes``.
:func:`build_all` starts one ``nvcc`` per source at once.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false``: the pair kernel's
squared distance and body arithmetic must round like the unfused float32
tensor ops of the plain versions (a contracted multiply-add moves lattice
pairs at exactly the support radius across the ``d2 < h^2`` test). Never
``--use_fast_math``: the cubic kernel relies on IEEE division and sqrt.
The flags are fixed here: nothing in the environment changes what is built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("pair_pass", "pair_slab", "permute")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict = {}
build_seconds: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host "
                       "with the CUDA toolkit")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    headers = sorted(os.path.join(CSRC, h) for h in os.listdir(CSRC)
                     if h.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (src, *headers):
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names=SOURCES, verbose: bool = False) -> None:
    """Compile every missing library, one nvcc process per source, all
    started together. Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for name in names:
        src, out = _target(name)
        if os.path.exists(out):
            continue
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", out + ".tmp", src]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, proc in procs:
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed:\n{log.decode()}")
            continue
        if verbose and log:
            print(log.decode(), flush=True)
        os.replace(out + ".tmp", out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        _, out = _target(name)
        if not os.path.exists(out):
            build_all((name,))
        lib = ctypes.CDLL(out)
        _libs[name] = lib
    return lib
