"""Build the CUDA sources under ``repro_torch/csrc`` at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with :mod:`ctypes`.  :func:`build_all` starts one
``nvcc`` per source whose library is missing, all at once, and waits for
them; :func:`load` builds one source that way if needed and loads it.
Libraries go into ``build/`` at the root of the checkout, named by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  Nothing is built while a module is imported: the CPU
tests import every module on a machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")   # the CUDA toolkit's usual place
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# name -> (seconds spent compiling, nvcc's output); empty when loaded as built
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "repro_torch build on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives for the current
    source and flags."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def sources() -> list[str]:
    """Names of every CUDA source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: list[str] | None = None) -> None:
    """Build the libraries of ``names`` (default: every source) that do not
    exist yet, one ``nvcc`` process per source, all started together."""
    todo = [n for n in (sources() if names is None else names) if not library_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in running:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{report}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        BUILD_LOG[name] = (time.perf_counter() - t0, report)
    if failures:
        raise RuntimeError("\n".join(failures))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` unless its library exists, then load it."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
