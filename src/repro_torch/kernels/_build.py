"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/`` (listed in
``.gitignore``), then loaded with ``ctypes``. Nothing here runs at import
time: a kernel is built on its first use, from the sources in the checkout,
or ahead of time by :func:`build_all`. The library name carries a hash of the
source, of every header under ``csrc/`` (``*.cuh``, which the sources
include) and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_load_mu = threading.Lock()  # dispatcher threads may reach a first use at once


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``); raises if there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(path.stem for path in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library is built: named by a hash of the
    source, the headers beside it and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str) -> str:
    """Run ``nvcc`` on ``csrc/<name>.cu`` unless its library is built;
    returns the compiler's output (empty when nothing was built)."""
    final = library_path(name)
    if final.is_file():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, final)
    return proc.stdout


def build_all() -> dict[str, str]:
    """Compile every kernel source at once (one ``nvcc`` per source, all
    started together). Returns the compiler's output per source (``-Xptxas
    -v`` register and shared-memory lines; empty when already built)."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(_compile, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _load_mu:
        lib = _loaded.get(name)
        if lib is None:
            _compile(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
