"""Builds the package's CUDA sources with ``nvcc`` at first use and loads
them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface and compiles, alone,
into a shared library for Hopper (``sm_90a``) under ``build/`` next to
the package; :func:`build` compiles several sources at once.  A library
is named after its source's content hash, so an edited source rebuilds
and an unchanged one loads at once.  Beside each library lies nvcc's
report of its build (:func:`report`: ptxas's registers and spill bytes
by kernel instance), so a cached library keeps it.  Nothing is compiled
when the package is imported.
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
from typing import Dict, Iterable, List, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / _PKG.name

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: source name -> (seconds the build took, nvcc's stderr with ptxas's
#: register/spill report); only sources built by this process
build_log: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/ on a machine with the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _report_path(library: Path) -> Path:
    return library.with_suffix(".log")


def report(source: str) -> str:
    """nvcc's stderr from the build of ``csrc/<source>``'s current
    library, with ptxas's register/spill report; built first if it was
    not."""
    with _lock:
        library = _build_locked([source])[source]
    return _report_path(library).read_text()


def build(sources: Iterable[str]) -> Dict[str, Path]:
    """The library of each ``csrc/<source>``, compiling those that do not
    exist yet: one ``nvcc`` per source, all started together.  Raises with
    the compilers' output if any build fails."""
    with _lock:
        return _build_locked(list(sources))


def _build_locked(sources: List[str]) -> Dict[str, Path]:
    paths = {source: library_path(source) for source in sources}
    jobs = []
    try:
        for source, out in paths.items():
            if out.exists() and _report_path(out).exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((source, proc, tmp, out, time.perf_counter()))
        errors = []
        for source, proc, tmp, out, t0 in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {source}:\n{err}")
                continue
            log = tmp.with_suffix(".log")
            log.write_text(err)
            os.replace(log, _report_path(out))
            os.replace(tmp, out)
            build_log[source] = (time.perf_counter() - t0, err)
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, proc, *_ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return paths


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(_build_locked([source])[source]))
            _libs[source] = lib
        return lib
