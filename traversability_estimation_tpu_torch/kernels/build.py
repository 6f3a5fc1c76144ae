"""Build the CUDA sources of the package at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. Libraries land in
``_build/`` inside the package (git-ignored), named by a hash of the
source, the flags and the compiler, so an edited source rebuilds and an
unchanged one loads straight away. Several sources build in parallel, one
``nvcc`` process each.

Flags: ``sm_90a`` (Hopper), ``-O3``, no ``-use_fast_math`` (the kernels
rely on IEEE NaN and infinity semantics and correctly rounded division and
square root) and ``-fmad=false`` (no contraction of ``a*b + c``: the
kernels repeat the plain versions' float32 operations bit for bit; the one
fused multiply-add they need is written explicitly).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

SOURCES = {
    "fused_update": "fused_update.cu",
    "circle_field": "circle_field.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
# one build and load at a time (a node's timer and service threads may reach
# a kernel's first use together), and one writer of a launch count at a time
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str, nvcc: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    h = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode() + nvcc.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (all by default) that are not built yet,
    all ``nvcc`` processes started together. Returns the wall seconds of
    each compile that ran; the compiler's resource report (registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    names = list(SOURCES) if names is None else list(names)
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name, nvcc)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        # the child keeps its own descriptor of the log after ours closes
        with open(out.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, out, tmp, proc, time.perf_counter()))
    seconds: Dict[str, float] = {}
    failed = []
    for name, out, tmp, proc, t0 in jobs:
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n{out.with_suffix('.log').read_text()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report for the built library of `name`."""
    return library_path(name, nvcc_path()).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `name`, built first if needed."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name, nvcc_path())))
        return _loaded[name]


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, from any thread."""
    with _lock:
        wrapper.launches += 1

