"""Build the port's CUDA and host C++ sources at first use.

Each ``rtm3d_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` on its own
into ``rtm3d_tpu_torch/_build/<name>-<hash>.so``, a shared library with a
plain C interface that the kernel's wrapper loads with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The hash covers the sources and
the flags, so an edited source builds anew; a finished library is reused.
``build`` starts one ``nvcc`` per source, all at once, and waits for all.
``nvcc`` runs only when a kernel is first needed, never at import.

Host C++ (``csrc/<name>.cc``: the AP evaluator's overlap library and the
reader's fused warp, no CUDA) takes its own route,
``build_host``/``load_host``: ``c++ -O3 -std=c++17 -shared -fPIC -pthread``
into the same directory, hashed the same way (no ``-march=native``: a
library in ``_build/`` may be copied to another machine with the tree). It is kept
apart from the ``.cu`` sources: ``kernel_names`` and ``build`` see only
CUDA. Either build raises when the compiler is missing or fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
)
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(jobs: Dict[str, tuple], compiler: Callable[[], str], flags: tuple) -> Dict[str, dict]:
    """``jobs``: name -> (source, library). Compiles every job whose library
    is missing, all at once, each into a temporary file moved into place
    when it is done; ``compiler()`` is looked up only when one is."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name, (src, lib) in jobs.items():
        log = lib.with_suffix(".log")
        if lib.exists():
            out[name] = {"path": lib, "seconds": 0.0,
                         "log": log.read_text() if log.exists() else ""}
            continue
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen([compiler(), *flags, "-o", str(tmp), str(src)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            lib, tmp, log, time.perf_counter(),
        )
    failed = []
    for name, (proc, lib, tmp, log, t0) in procs.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: {proc.args[0]} exited {proc.returncode}\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        out[name] = {"path": lib, "seconds": seconds, "log": text}
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return out


def build(names: Iterable[str] | None = None) -> Dict[str, dict]:
    """Compile every named CUDA source (default: all of ``csrc/*.cu``) that
    has no current library, in parallel. Returns ``{name: {"path",
    "seconds", "log"}}``; ``log`` is nvcc's output (ptxas resource usage)."""
    names = kernel_names() if names is None else list(names)
    return _compile({n: (CSRC_DIR / f"{n}.cu", library_path(n)) for n in names}, find_nvcc, NVCC_FLAGS)


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    lib = library_path(name)
    if not lib.exists():
        build([name])
    return ctypes.CDLL(str(lib))


def find_cxx() -> str:
    cxx = shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (c++) found: the port's host libraries are built from source")
    return cxx


def host_library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cc").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_host(names: Iterable[str]) -> Dict[str, dict]:
    """Compile the named host sources ``csrc/<name>.cc`` with ``c++`` that
    have no current library; as ``build``."""
    return _compile({n: (CSRC_DIR / f"{n}.cc", host_library_path(n)) for n in names}, find_cxx, HOST_CXX_FLAGS)


def load_host(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cc``, built first if needed."""
    lib = host_library_path(name)
    if not lib.exists():
        build_host([name])
    return ctypes.CDLL(str(lib))
