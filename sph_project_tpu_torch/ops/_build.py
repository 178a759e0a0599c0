"""Build the port's CUDA kernels with ``nvcc`` on first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its own
into ``build/kernels/<name>-<hash>.so`` at the repository root (the hash
covers the source, every shared header ``csrc/*.cuh`` and the flags, so an
edit to any of them rebuilds), then loaded with ``ctypes``. A pair kernel
(:data:`PAIR_SOURCES`) is compiled once per kernel kind and dimension
(:data:`VARIANTS`, ``-DPAIR_KIND``/``-DPAIR_DIM``), into
``<name>-<kind><dim>d-<hash>.so``: each library holds the body instances of
one combination. :func:`build_all` starts one ``nvcc`` per library at once.

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
SOURCES = ("pair_pass", "pair_slab", "permute", "graph_loop", "polar")
PAIR_SOURCES = ("pair_pass", "pair_slab")
# (kernel kind, dimension) of each pair kernel library
VARIANTS = (("cubic", 3), ("cubic", 2), ("poly6", 3), ("poly6", 2))
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


def variants(name: str) -> tuple:
    """The libraries of source ``name``: one per (kind, dim) for a pair
    kernel, else one (``None``)."""
    return VARIANTS if name in PAIR_SOURCES else (None,)


def _defines(variant) -> list:
    if variant is None:
        return []
    kind, dim = variant
    return [f"-DPAIR_KIND=KIND_{kind.upper()}", f"-DPAIR_DIM={dim}"]


def _target(name: str, variant=None) -> tuple[str, str]:
    """(source, library path) of ``name``; a pair kernel's ``variant``
    defaults to its cubic 3D library."""
    if variant is None and name in PAIR_SOURCES:
        variant = VARIANTS[0]
    src = os.path.join(CSRC, f"{name}.cu")
    headers = sorted(os.path.join(CSRC, h) for h in os.listdir(CSRC)
                     if h.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + _defines(variant)).encode())
    for path in (src, *headers):
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = "" if variant is None else f"-{variant[0]}{variant[1]}d"
    return src, os.path.join(BUILD_DIR,
                             f"{name}{tag}-{digest.hexdigest()[:16]}.so")


def build_all(names=SOURCES, verbose: bool = False) -> None:
    """Compile every missing library of ``names``, one nvcc process per
    library, all started together. Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for name in names:
        for variant in variants(name):
            src, out = _target(name, variant)
            if os.path.exists(out):
                continue
            # a file of this process's own: ranks started together on a
            # fresh checkout build the same library at once
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, *_defines(variant),
                   *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, src]
            label = name if variant is None else \
                f"{name}-{variant[0]}{variant[1]}d"
            procs.append((label, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for label, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_seconds[label] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {label} failed:\n{log.decode()}")
            continue
        if verbose and log:
            print(f"nvcc {label}:\n{log.decode()}", flush=True)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, variant=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (of ``variant``, a pair
    kernel's (kind, dim)), built first if needed."""
    lib = _libs.get((name, variant))
    if lib is None:
        _, out = _target(name, variant)
        if not os.path.exists(out):
            build_all((name,))
        lib = ctypes.CDLL(out)
        _libs[(name, variant)] = lib
    return lib
