"""Build the port's CUDA sources at first use.

Each ``rtm3d_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` on its own
into ``rtm3d_tpu_torch/_build/<name>-<hash>.so``, a shared library with a
plain C interface that the kernel's wrapper loads with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The hash covers the sources and
the flags, so an edited source builds anew; a finished library is reused.
``build`` starts one ``nvcc`` per source, all at once, and waits for all.
``nvcc`` runs only when a kernel is first needed, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
)


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


def build(names: Iterable[str] | None = None) -> Dict[str, dict]:
    """Compile every named source (default: all of ``csrc/``) that has no
    current library, in parallel. Returns ``{name: {"path", "seconds",
    "log"}}``; ``log`` is nvcc's output (ptxas resource usage)."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        lib = library_path(name)
        log = lib.with_suffix(".log")
        if lib.exists():
            out[name] = {"path": lib, "seconds": 0.0,
                         "log": log.read_text() if log.exists() else ""}
            continue
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib, tmp, log, time.perf_counter(),
        )
    failed = []
    for name, (proc, lib, tmp, log, t0) in procs.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        out[name] = {"path": lib, "seconds": seconds, "log": text}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    lib = library_path(name)
    if not lib.exists():
        build([name])
    return ctypes.CDLL(str(lib))
